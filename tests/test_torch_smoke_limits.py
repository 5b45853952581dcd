"""The limit ``chip_smoke.py`` holds each full-width model-kernel cell to.

Phase 10 compares each CUDA kernel's bf16 output with its plain version
element by element: within two bf16 steps of the plain value plus half a
step at the output's RMS (``within_bf16_steps``).  Here, on the CPU, the
plain flash attention stands in for both sides: computed in another
summation order it passes, and the faults a wrong kernel would show at
a decode-like shape (one kv tile dropped, the keys shifted by a few
positions, every output halved, one head's output replaced) fail.  The
reference's 2e-2 ``allclose`` passes the first two.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fa

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_limits", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def decode():
    """q (BH, 1, d), k/v (BH, T, d) in bf16 and the plain output."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(8, n, 128, generator=g).bfloat16()
               for n in (1, 4096, 4096))
    return q, k, v, fa.flash_attention_plain(q, k, v, bk=128)


def test_another_summation_order_passes(smoke, decode):
    q, k, v, want = decode
    got = fa.flash_attention_plain(q, k, v, bk=64)
    worst = smoke.within_bf16_steps("reordered", got, want)
    assert worst["err_over_limit"] <= 1.0
    assert worst["limit_at_rms"] == pytest.approx(
        (2.0 ** -6 + 2.0 ** -8) * worst["rms"])


def _dropped_tile(q, k, v, want):
    return fa.flash_attention_plain(q, k[:, 64:], v[:, 64:], bk=64)


def _shifted_keys(q, k, v, want):
    return fa.flash_attention_plain(q, k[:, 3:], v[:, 3:], bk=1)


def _halved(q, k, v, want):
    return want * 0.5


def _one_head_replaced(q, k, v, want):
    bad = want.clone()
    bad[3] = want[4]
    return bad


@pytest.mark.parametrize("fault", [_dropped_tile, _shifted_keys, _halved,
                                   _one_head_replaced],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_wrong_kernel_fails(smoke, decode, fault):
    q, k, v, want = decode
    bad = fault(q, k, v, want)
    with pytest.raises(RuntimeError, match="the limit"):
        smoke.within_bf16_steps(fault.__name__, bad, want)


def test_the_reference_tolerance_alone_passes_small_faults(smoke, decode):
    """Why the element-wise limit exists: at decode the outputs are about
    0.02, so rtol = atol = 2e-2 passes a dropped tile or shifted keys."""
    q, k, v, want = decode
    for fault in (_dropped_tile, _shifted_keys):
        bad = fault(q, k, v, want)
        assert torch.allclose(bad.float(), want.float(), rtol=2e-2,
                              atol=2e-2)
