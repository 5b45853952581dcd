"""The port's device contract (``repro_torch.device.resolve_device``).

Every spelling of a device resolves to the one form a tensor made there
reports: ``None``, ``"cuda"`` and ``"cuda:<current>"`` are the current
card, ``cuda:N``; ``"cpu"`` and ``"cpu:0"`` are ``cpu``; ``"meta"``
passes through.  A CUDA spelling without a card, or with an index other
than the current device's, raises ``DeviceError``.  The CUDA cases run
here with ``have_cuda`` and ``torch.cuda.current_device`` patched; the
entry points that take ``device=`` are held to the same contract.
"""

import numpy as np
import pytest
import torch

from repro_torch import device as devmod
from repro_torch.collectives.dispatch import reset_dispatcher
from repro_torch.collectives.ingraph import InGraphSelector
from repro_torch.configs import get_smoke_config
from repro_torch.device import DeviceError, resolve_device
from repro_torch.models import init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import MeshAxes
from repro_torch.models.transformer import tree_leaves
from repro_torch.policies import bucket_tuner
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import Trainer, TrainerConfig

AX = MeshAxes(tp=1, dp=1, fsdp=False)
CPU_SPELLINGS = ["cpu", "cpu:0", torch.device("cpu"), torch.device("cpu", 0)]
CPU_IDS = ["cpu", "cpu:0", "device(cpu)", "device(cpu, 0)"]


def _cuda_spellings(index: int) -> list:
    return [None, "cuda", torch.device("cuda"), f"cuda:{index}",
            torch.device("cuda", index)]


def _fake_card(monkeypatch, index: int) -> None:
    """Make ``require_cuda`` see a card whose current device is
    ``cuda:<index>``."""
    monkeypatch.setattr(devmod, "have_cuda", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: index)


def _no_card(monkeypatch) -> None:
    monkeypatch.setattr(devmod, "have_cuda", lambda: False)


@pytest.mark.parametrize("spelling", CPU_SPELLINGS, ids=CPU_IDS)
def test_cpu_spellings_resolve_to_what_a_tensor_reports(spelling):
    got = resolve_device(spelling, "the test")
    assert got == torch.empty(0, device=spelling).device
    assert got == torch.device("cpu") and got.index is None


def test_meta_passes_through():
    got = resolve_device("meta", "the test")
    assert got == torch.device("meta") == torch.empty(0, device="meta").device


@pytest.mark.parametrize("index", [0, 1])
@pytest.mark.parametrize("k", range(5), ids=["None", "cuda", "device(cuda)",
                                             "cuda:N", "device(cuda, N)"])
def test_cuda_spellings_resolve_to_the_current_card(k, index, monkeypatch):
    """A tensor on the card reports ``cuda:N``; so does every spelling of
    the card."""
    _fake_card(monkeypatch, index)
    got = resolve_device(_cuda_spellings(index)[k], "the test")
    assert got == torch.device("cuda", index) and got.index == index


@pytest.mark.parametrize("index", [0, 1])
def test_a_cuda_index_other_than_the_current_raises(index, monkeypatch):
    _fake_card(monkeypatch, index)
    other = 1 - index
    for spelling in (f"cuda:{other}", torch.device("cuda", other)):
        with pytest.raises(DeviceError, match=f"current device is "
                                              f"cuda:{index}"):
            resolve_device(spelling, "the test")


@pytest.mark.parametrize("k", range(5), ids=["None", "cuda", "device(cuda)",
                                             "cuda:0", "device(cuda, 0)"])
def test_cuda_spellings_without_a_card_raise(k, monkeypatch):
    _no_card(monkeypatch)
    with pytest.raises(DeviceError, match="the test needs a CUDA device"):
        resolve_device(_cuda_spellings(0)[k], "the test")


# ---------------------------------------------------------------------------
# the entry points that take device=
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("tinyllama-1.1b")
    params, _ = init_params(0, cfg, AX, device="cpu")
    return cfg, params


def _leaf_devices(tree) -> set:
    return {t.device for t in tree_leaves(tree)}


def _entry(name: str, smoke, device):
    """Calls the entry point ``name`` with ``device``; returns the device
    it holds and the devices of the tensors it made."""
    cfg, params = smoke
    if name == "init_params":
        p, _ = init_params(0, cfg, AX, device=device)
        return None, _leaf_devices(p)
    if name == "params_from_numpy":
        p = params_from_numpy({"w": [np.zeros(3, np.float32)]}, device=device)
        return None, _leaf_devices(p)
    if name == "ServeEngine":
        eng = ServeEngine(cfg, params, AX,
                          ServeConfig(batch_slots=1, max_ctx=8),
                          device=device)
        return eng.device, _leaf_devices(eng.params)
    if name == "Trainer":
        reset_dispatcher(tier="torch")      # the host's policy tier
        tr = Trainer(cfg, AX, None, TrainerConfig(steps=1), device=device)
        return tr.device, _leaf_devices(tr.params)
    sel = InGraphSelector(bucket_tuner.program, tier="torchc",
                          device=device)
    return sel.device, _leaf_devices(sel.init_state())


ENTRY_POINTS = ["init_params", "params_from_numpy", "ServeEngine", "Trainer",
                "InGraphSelector"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_hold_the_cpu_in_one_form(name, smoke):
    """``"cpu:0"`` and ``"cpu"`` give one device, held and made."""
    for spelling in ("cpu", "cpu:0"):
        held, made = _entry(name, smoke, spelling)
        assert held in (None, torch.device("cpu")), spelling
        assert made == {torch.device("cpu")}, spelling


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_points_raise_for_the_card_without_one(name, smoke,
                                                     monkeypatch):
    """No silent CPU run and no late torch error: every CUDA spelling
    raises ``DeviceError`` before anything is made."""
    _no_card(monkeypatch)
    for spelling in (None, "cuda", "cuda:0"):
        with pytest.raises(DeviceError, match="needs a CUDA device"):
            _entry(name, smoke, spelling)


def test_the_selector_holds_one_form_of_the_card(monkeypatch):
    """``device=None``, ``"cuda"`` and ``"cuda:N"`` give a ``torchc``
    selector the device its card tensors report (the selector's build of
    the switch-node library is skipped: there is no card here)."""
    from repro_torch.core import graphs
    _fake_card(monkeypatch, 0)
    monkeypatch.setattr(graphs, "build", lambda: None)
    got = {InGraphSelector(bucket_tuner.program, tier="torchc",
                           device=d).device
           for d in (None, "cuda", "cuda:0", torch.device("cuda"))}
    assert got == {torch.device("cuda", 0)}
