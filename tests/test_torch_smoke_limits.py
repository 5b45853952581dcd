"""The limit ``chip_smoke.py`` holds each full-width model-kernel cell to.

Phase 10 compares each CUDA kernel's bf16 output with its plain version
element by element: within two bf16 steps of the plain value plus half a
step at the output's RMS (``within_bf16_steps``).  Here, on the CPU, the
plain flash attention stands in for both sides: computed in another
summation order it passes, and the faults a wrong kernel would show at
a decode-like shape (one kv tile dropped, the keys shifted by a few
positions, every output halved, one head's output replaced) fail.  The
reference's 2e-2 ``allclose`` passes the first two.

The same limit fixes how the bf16 tensor-core kernel multiplies P by V:
P rounded once to bf16 before the product (the usual FlashAttention-2
move) fails it at full width; P split into hi = bf16(p) and lo =
bf16(p - hi), each multiplied by V into one f32 sum, passes it.
"""

import importlib.util
from pathlib import Path

import numpy as np
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


def _attention_with_p(q, k, v, p_form: str, bk: int = 128):
    """One causal head, q (S, d) and k/v (T, d): the plain version's
    arithmetic (f32 logits, online softmax over ``bk``-wide tiles), with
    P as the P V product takes it: ``"f32"`` (the reference's), ``"bf16"``
    (rounded once) or ``"hi_lo"`` (hi = bf16(p), lo = bf16(p - hi), two
    products added in f32)."""
    S, d = q.shape
    T = k.shape[0]
    q_pos = torch.arange(S)[:, None] + (T - S)
    m = torch.full((S, 1), fa.NEG_INF)
    l = torch.zeros((S, 1))
    acc = torch.zeros((S, d))
    for k0 in range(0, T, bk):
        kf, vf = k[k0:k0 + bk].float(), v[k0:k0 + bk].float()
        s = q.float() @ kf.T * d ** -0.5
        mask = (k0 + torch.arange(bk))[None, :] <= q_pos
        s = torch.where(mask, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        l = alpha * l + p.sum(dim=1, keepdim=True)
        hi = p.bfloat16().float()
        pv = {"f32": lambda: p @ vf, "bf16": lambda: hi @ vf,
              "hi_lo": lambda: hi @ vf + (p - hi).bfloat16().float() @ vf
              }[p_form]()
        acc = alpha * acc + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).bfloat16()


@pytest.mark.parametrize("S,d", [(4096, 128), (2048, 256)])
def test_p_rounded_once_fails_and_hi_lo_passes(smoke, S, d):
    """Full-width causal heads (d = 128 at 4096 tokens, d = 256 at 2048):
    one bf16 rounding of P leaves hundreds of elements 2.5-5x over the
    limit; the hi/lo split stays under half of it."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((S, d), np.float32))
               .bfloat16() for _ in range(3))
    want = _attention_with_p(q, k, v, "f32")
    with pytest.raises(RuntimeError, match="the limit"):
        smoke.within_bf16_steps("P in bf16", _attention_with_p(
            q, k, v, "bf16"), want)
    worst = smoke.within_bf16_steps("P as hi + lo", _attention_with_p(
        q, k, v, "hi_lo"), want)
    assert worst["err_over_limit"] <= 0.5
