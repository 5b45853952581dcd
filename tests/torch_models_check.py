"""Shared half of ``tests/test_torch_models_*.py``: one smoke config's
weights and batch through the reference (``repro.models``, JAX on the
CPU) and through the port (``repro_torch.models`` on ``device="cpu"``).

Both packages compute on the same numpy-seeded weights: the reference's
``init_params`` tree, carried across with ``params_from_numpy``.

Tolerances, each against the reference's own output:

- f32 forward logits: max |port - reference| <= 1e-4 rms(reference);
  the aux loss within 1e-5 relative.  Both compute in f32 and differ only
  in summation order (measured: at most 7.2e-6 rms).
- f32 loss within 1e-5 relative; each gradient leaf ||dg|| <= 1e-4 ||g||
  (measured: at most 2.1e-6).
- bf16 (the configs' own dtype) logits: rms |port - reference| <= 2^-5
  rms(reference) and max <= 2^-3 rms(reference).  bf16 keeps 8
  significant bits, and the two packages round at different points (XLA
  keeps f32 inside its fusions, PyTorch rounds after each op), so they
  differ by about bf16's own error against f32 (measured: rms 0.4-1.0%,
  max 2.5-5.0% of the rms; bf16 against f32 is 0.8-10% rms).
- decode: the same tokens at every step in f32; every cache leaf within
  rtol = atol = 1e-5.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models as R
import repro_torch.models as T
from repro.configs import get_smoke_config as ref_smoke
from repro.models.layers import MeshAxes as RefAxes
from repro.models.transformer import init_caches as ref_init_caches
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import MeshAxes
from repro_torch.models.transformer import _decode_logits, init_caches

REF_AX = RefAxes(tp=1, dp=1, fsdp=False)
AX = MeshAxes(tp=1, dp=1, fsdp=False)
B, S = 2, 32
CHECKS = ("forward_f32", "loss_and_grads_f32", "forward_bf16", "decode_f32")


def rms(a) -> float:
    a = np.asarray(a, np.float64)
    return float(np.sqrt(np.mean(a * a)))


def flatten(tree, prefix=""):
    """(path, leaf) pairs in ``jax.tree`` order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def numpy_of(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@functools.lru_cache(maxsize=None)
def case(arch: str):
    """(reference params, numpy params, batch as numpy) for ``arch``."""
    cfg = ref_smoke(arch)
    params, _ = R.init_params(jax.random.PRNGKey(0), cfg, REF_AX)
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.randn(B, cfg.n_audio_frames,
                                    cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.randn(B, cfg.n_patch_tokens,
                                     cfg.d_model).astype(np.float32)
    return params, jax.tree.map(np.asarray, params), batch


def configs(arch: str, dtype: str):
    return (ref_smoke(arch).with_overrides(dtype=dtype),
            port_smoke(arch).with_overrides(dtype=dtype))


def port_params(arch: str):
    return params_from_numpy(case(arch)[1], device="cpu")


def _batches(arch):
    batch = case(arch)[2]
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def forwards(arch: str, dtype: str):
    """(reference logits, aux), (port logits, aux) as numpy / float."""
    rcfg, pcfg = configs(arch, dtype)
    bj, bt = _batches(arch)
    lj, aj = jax.jit(lambda p, b: R.forward_logits(p, b, rcfg, REF_AX))(
        case(arch)[0], bj)
    with torch.no_grad():
        lt, at = T.forward_logits(port_params(arch), bt, pcfg, AX)
    assert lt.dtype == pcfg.torch_dtype
    return (numpy_of(lj), float(aj)), (numpy_of(lt), float(at))


def check_forward_f32(arch: str) -> None:
    (lj, aj), (lt, at) = forwards(arch, "float32")
    assert lt.shape == lj.shape
    err = np.abs(lt - lj).max()
    assert err <= 1e-4 * rms(lj), (err, rms(lj))
    assert abs(at - aj) <= 1e-5 * max(abs(aj), 1e-3), (at, aj)


def check_forward_bf16(arch: str) -> None:
    (lj, aj), (lt, at) = forwards(arch, "bfloat16")
    r = rms(lj)
    assert rms(lt - lj) <= 2.0 ** -5 * r, (rms(lt - lj), r)
    assert np.abs(lt - lj).max() <= 2.0 ** -3 * r, (np.abs(lt - lj).max(), r)
    assert abs(at - aj) <= 2.0 ** -5 * max(abs(aj), 1e-3), (at, aj)


def check_loss_and_grads_f32(arch: str) -> None:
    rcfg, pcfg = configs(arch, "float32")
    bj, bt = _batches(arch)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: R.loss_fn(p, bj, rcfg, REF_AX)))(case(arch)[0])
    lm = T.LM(pcfg, port_params(arch), AX)
    loss_t = lm.loss(bt)
    loss_t.backward()
    loss_t = float(loss_t.detach())
    assert abs(loss_t - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = dict(flatten(jax.tree.map(np.asarray, grads_j)))
    got = dict(flatten(lm.tree()))
    assert sorted(got) == sorted(want)
    for path, g in want.items():
        p = got[path]
        mine = p.grad.numpy() if p.grad is not None else np.zeros_like(g)
        assert mine.shape == g.shape, path
        bound = 1e-4 * np.linalg.norm(g)
        assert np.linalg.norm(mine - g) <= bound or \
            np.array_equal(mine, g), (path, np.linalg.norm(mine - g), bound)


def decode_runs(arch: str, steps: int = 8, prompt: int = 4, ctx: int = 16):
    """Both packages' decode over a ``prompt``-token prefix, then greedy
    tokens, from empty caches: (tokens_ref, tokens_port, caches_ref,
    caches_port, logits_port)."""
    rcfg, pcfg = configs(arch, "float32")
    pj = case(arch)[0]
    pt = port_params(arch)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, rcfg.vocab, (B, prompt)).astype(np.int32)
    extra_j, extra_t = {}, {}
    if rcfg.family == "audio":
        enc = rng.randn(B, rcfg.n_audio_frames, rcfg.d_model).astype(
            np.float32)
        extra_j["enc_out"] = jnp.asarray(enc)
        extra_t["enc_out"] = torch.from_numpy(enc)
    step = jax.jit(lambda p, t, c, q: R.decode_step(p, t, c, q, rcfg, REF_AX,
                                                    **extra_j))
    cj = ref_init_caches(pj, rcfg, B, ctx, REF_AX)
    ct = init_caches(pt, pcfg, B, ctx, AX)
    out_j, out_t, logits_t = [], [], []
    tj = tt = toks[:, :1]
    with torch.no_grad():
        for i in range(steps):
            pos = np.full((B,), i, np.int32)
            nj, cj = step(pj, jnp.asarray(tj), cj, jnp.asarray(pos))
            lg, ct = _decode_logits(pt, torch.from_numpy(np.asarray(tt)), ct,
                                    torch.from_numpy(pos), pcfg, AX,
                                    **extra_t)
            nt = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)[:, None]
            out_j.append(np.asarray(nj))
            out_t.append(nt.numpy())
            logits_t.append(lg.numpy())
            if i + 1 < prompt:
                tj = tt = toks[:, i + 1:i + 2]
            else:
                tj, tt = np.asarray(nj), nt.numpy()
    return out_j, out_t, cj, ct, logits_t


def check_decode_f32(arch: str) -> None:
    out_j, out_t, cj, ct, _ = decode_runs(arch)
    for i, (a, b) in enumerate(zip(out_j, out_t)):
        assert np.array_equal(a, b), (i, a.ravel(), b.ravel())
    want = list(flatten(cj))
    got = list(flatten(ct))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(numpy_of(g), numpy_of(w), rtol=1e-5,
                                   atol=1e-5, err_msg=path)


def run_check(name: str, arch: str) -> None:
    globals()[f"check_{name}"](arch)
