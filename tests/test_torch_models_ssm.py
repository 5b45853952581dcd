"""The port's SSM (xLSTM) and hybrid (RG-LRU) models against the reference.

Each smoke config's numpy-seeded weights and batch go through the
reference (``repro.models``, JAX on the CPU) and through the port on
``device="cpu"``: f32 forward logits and aux, the f32 loss and every
gradient leaf (``jax.value_and_grad`` against autograd), bf16 logits,
and f32 decode tokens and caches.  Tolerances and their reasons are in
``tests/torch_models_check.py``.
"""

import pytest

import torch_models_check as chk

ARCHS = ["xlstm-1.3b", "recurrentgemma-9b"]


@pytest.mark.parametrize("check", chk.CHECKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_against_the_reference(arch, check):
    chk.run_check(check, arch)


# ---------------------------------------------------------------------------
# the recurrent cores: the parity cases of tests/test_recurrent.py on the
# port, and the port against the reference functions on the same inputs
# ---------------------------------------------------------------------------

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.models import recurrent as ref_rec  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402


def _mlstm_inputs(B=2, S=64, H=2, dk=16, dv=8, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, S, H, dk).astype(np.float32) * 0.5
    k = rng.randn(B, S, H, dk).astype(np.float32) * 0.5
    v = rng.randn(B, S, H, dv).astype(np.float32)
    it = rng.randn(B, S, H).astype(np.float32)
    ft = (rng.randn(B, S, H) + 2.0).astype(np.float32)
    return q, k, v, it, ft


def _t(*arrs):
    return tuple(torch.from_numpy(a) for a in arrs)


def _j(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunked_matches_scan(chunk):
    x = _mlstm_inputs()
    h_ref, (C_ref, n_ref, m_ref) = rec.mlstm_scan_ref(*_t(*x))
    h_chk, (C_chk, n_chk, m_chk) = rec.mlstm_chunked(*_t(*x), chunk=chunk)
    _close(h_ref, h_chk, 2e-4)
    _close(m_ref, m_chk, 1e-5)
    _close(C_ref, C_chk, 2e-4)
    # and the reference's chunked form on the same inputs
    h_j, (C_j, n_j, m_j) = ref_rec.mlstm_chunked(*_j(*x), chunk=chunk)
    _close(h_chk, h_j, 1e-5)
    _close(C_chk, C_j, 1e-5)
    _close(n_chk, n_j, 1e-5)
    _close(m_chk, m_j, 1e-6)


def test_mlstm_extreme_gates_stable():
    q, k, v, it, ft = _mlstm_inputs(seed=3)
    it = it * 20.0          # huge input gates: the stabiliser must hold
    ft = ft - 10.0          # strong forgetting
    h_ref, _ = rec.mlstm_scan_ref(*_t(q, k, v, it, ft))
    h_chk, _ = rec.mlstm_chunked(*_t(q, k, v, it, ft), chunk=16)
    assert bool(torch.isfinite(h_ref).all())
    assert bool(torch.isfinite(h_chk).all())
    _close(h_ref, h_chk, 1e-3)
    h_j, _ = ref_rec.mlstm_scan_ref(*_j(q, k, v, it, ft))
    _close(h_ref, h_j, 1e-5)


def _rglru_inputs(B=2, S=33, W=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, W).astype(np.float32),
            rng.randn(B, S, W).astype(np.float32),
            rng.randn(B, S, W).astype(np.float32),
            (rng.rand(W) * 0.5 + 0.3).astype(np.float32))


def test_rglru_assoc_scan_matches_sequential():
    x, gr, gi, lam = _t(*_rglru_inputs())
    B, S, W = x.shape
    h_par, h_last = rec._rglru_core(x, gr, gi, lam)
    # sequential reference via repeated single-step (decode) calls
    h = torch.zeros((B, W))
    outs = []
    for t in range(S):
        y, h = rec._rglru_core(x[:, t:t + 1], gr[:, t:t + 1],
                               gi[:, t:t + 1], lam, h0=h)
        outs.append(y[:, 0])
    _close(h_par, torch.stack(outs, dim=1), 1e-5)
    _close(h_last, h, 1e-5)
    # and the reference's associative scan on the same inputs
    h_j, last_j = ref_rec._rglru_core(*_j(*_rglru_inputs()))
    _close(h_par, h_j, 1e-6)
    _close(h_last, last_j, 1e-6)


@pytest.mark.parametrize("S", [1, 2, 7, 32, 33])
def test_associative_scan_against_a_sequential_scan(S):
    """The log-depth scan equals a left-to-right loop with the same
    combine, at odd and even lengths."""
    rng = np.random.RandomState(S)
    a = torch.from_numpy(rng.rand(3, S, 5).astype(np.float32))
    b = torch.from_numpy(rng.randn(3, S, 5).astype(np.float32))
    got_a, got_b = rec.associative_scan(rec._combine, (a, b), dim=1)
    acc = (a[:, 0], b[:, 0])
    want_a, want_b = [acc[0]], [acc[1]]
    for t in range(1, S):
        acc = rec._combine(acc, (a[:, t], b[:, t]))
        want_a.append(acc[0])
        want_b.append(acc[1])
    _close(got_a, torch.stack(want_a, dim=1), 1e-6)
    _close(got_b, torch.stack(want_b, dim=1), 1e-5)


def test_mlstm_decode_continues_train_state():
    """Train S=32 then decode 8 more == train S=40 (state handoff)."""
    q, k, v, it, ft = _t(*_mlstm_inputs(S=40, seed=5))
    h_full, _ = rec.mlstm_scan_ref(q, k, v, it, ft)
    h_pre, carry = rec.mlstm_scan_ref(q[:, :32], k[:, :32], v[:, :32],
                                      it[:, :32], ft[:, :32])
    outs = [h_pre]
    for t in range(32, 40):
        h_t, carry = rec.mlstm_scan_ref(q[:, t:t + 1], k[:, t:t + 1],
                                        v[:, t:t + 1], it[:, t:t + 1],
                                        ft[:, t:t + 1], carry=carry)
        outs.append(h_t)
    _close(h_full, torch.cat(outs, dim=1), 1e-5)
