"""The training cell on the CPU at a size a test can hold: the plain
reference against the port's model, the FLOP arithmetic against
``FlopCounterMode``, the harness's corpus against the port's, and the
control and the faults the cell can have coming out not correct."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, weights
from portbench.runners import train as drv
from portbench.flops import model_flops_per_step
from portbench.reference import qwen3 as ref_q
from portbench.tests.helpers import SEED, SMALL_TRAIN, cpu_run
from portbench.traffic import TokenCorpus

CELL = "adaptive-loop.train-qwen3-1.7b"


def _cell():
    return harness.find_cell(harness.load_bench(), CELL)


def _small():
    c = _cell()
    model = dict(c.model, **SMALL_TRAIN["model"])
    return c, model, drv.port_config(model, SMALL_TRAIN)


def _port_tree(W):
    """The reference's leaves as the port's tree."""
    tree = {}
    for path, t in W.items():
        node = tree
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = t
    return {"blocks": [tree["blocks"]["0"]], "embed": tree["embed"],
            "final_norm": tree["final_norm"], "tail": []}


def test_reference_loss_equals_the_ports_in_float32():
    from repro_torch.models import loss_fn
    from repro_torch.models.layers import MeshAxes
    c, model, cfg = _small()
    W = weights.make(model, SEED, "cpu")
    b = TokenCorpus(model["vocab_size"], 5).batch(0, 2, 32)
    tok, lab = (torch.as_tensor(b[k]).long() for k in ("tokens", "labels"))
    want = ref_q.loss(W, tok, lab, model)
    got = loss_fn(_port_tree(W), {"tokens": tok, "labels": lab},
                  cfg.with_overrides(dtype="float32", remat=False),
                  MeshAxes())
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)


def test_flops_equal_the_counter_without_recomputation():
    from repro_torch.models import loss_fn
    from repro_torch.models.layers import MeshAxes
    c, model, cfg = _small()
    W = weights.make(model, SEED, "cpu")
    for t in W.values():
        t.requires_grad_(True)
    B, S = 2, 32
    b = TokenCorpus(model["vocab_size"], 5).batch(0, B, S)
    counter = FlopCounterMode(display=False)
    with counter:
        loss = loss_fn(_port_tree(W), {k: torch.as_tensor(v).long()
                                        for k, v in b.items()},
                       cfg.with_overrides(dtype="float32", remat=False),
                       MeshAxes())
        loss.backward()
    n = sum(t.numel() for t in W.values())
    # 6 N T counts the norm scales too, which no matrix product uses
    scales = sum(t.numel() for p, t in W.items() if "norm" in p or
                 "ln" in p)
    assert model_flops_per_step(model, n, B, S) - 6 * scales * B * S \
        == counter.get_total_flops()


def test_corpus_is_the_ports():
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    ds = SyntheticLMDataset(get_config("qwen3-1.7b"),
                            DataConfig(seq_len=64, global_batch=2, seed=9))
    mine = TokenCorpus(151936, 9).batch(3, 2, 64)
    theirs = ds.batch(3)
    for k in ("tokens", "labels"):
        assert (mine[k] == theirs[k]).all()


def test_the_cell_at_a_small_size_is_correct():
    line = cpu_run(CELL, sizes=SMALL_TRAIN, seconds=600.0)
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] == 2


def test_checked_steps_and_window_share_one_run(monkeypatch):
    """The checked steps are the first steps of the one ``Trainer.run``
    the cell makes; the window opens after them and the settling steps,
    with no second run and no second data pipeline."""
    from repro_torch.train import trainer
    runs = []
    run = trainer.Trainer.run
    monkeypatch.setattr(trainer.Trainer, "run",
                        lambda self, **kw: runs.append(kw) or run(self, **kw))
    line = cpu_run(CELL, sizes=SMALL_TRAIN, seconds=600.0)
    mix = _cell().mix
    n = mix["checked_steps"] + mix["settle_steps"]
    assert runs == [{"steps": n + SMALL_TRAIN["window_steps"]}]
    assert line["attempted"] == SMALL_TRAIN["window_steps"]
    assert line["correct"] is True, line["compared"]


@pytest.mark.parametrize("fault", ["frozen_step", "half_batch",
                                   "altered_decision"])
def test_a_broken_step_is_not_correct(fault):
    line = cpu_run(CELL, sizes=SMALL_TRAIN, seconds=600.0, fault=fault)
    assert line["correct"] is False, line["compared"]


def test_control_in_the_programs_place_is_not_correct():
    """The reference in float8 against the reference in float32."""
    c, model, cfg = _small()
    mix = c.mix
    B, S = SMALL_TRAIN["batch"], SMALL_TRAIN["seq"]
    ref = drv.reference_readings(model, mix, SEED, B, S, "cpu")
    ctl = drv.reference_readings(model, mix, SEED, B, S, "cpu",
                                 quantize=True)
    gaps = ref_q.gaps(ctl, ref)
    lim = mix["limits"]["adaptive-loop"]
    assert any(gaps[k] > lim[k] for k in gaps), gaps
