"""The port's model kernels (B3-B5) against the JAX package, on the CPU.

Every case of ``tests/test_kernels.py`` is mirrored, over the same
shapes, dtypes and block sizes, in four pairs on the same seeded inputs
(``torch_samples.kernel_inputs``; bf16 casts of float32 arrays, round to
nearest even in both frameworks, so the bits agree):

  JAX ``*_tpu(interpret=True)``    <->  the port's plain version
  JAX ``*_ref``                    <->  the port's ``ref.py``
  JAX ops, ``backend="pallas"``    <->  the port's ops, ``backend="torch"``
  JAX ops, ``backend="ref"``       <->  the port's ops, ``backend="ref"``

with the reference's tolerance: rtol = atol = 2e-5 in float32, 2e-2 in
bfloat16, compared in float32.  Then the cases the reference does not
cover: GQA expansion order, queries offset against the keys (``S < T``),
rows that see no key (``S > T``, ROADMAP C5), windows without
``causal``, the bf16 rounding order of RMSNorm, the shape contract, the
device contract of ``backend="cuda"``, and a guard on the CUDA sources.
The kernels themselves run on the card: ``tests/test_torch_kernels_cuda.py``.
"""

import ast
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_samples as samples
from repro.kernels.flash_attention.kernel import flash_attention_tpu
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_fa_ref
from repro.kernels.grouped_matmul.kernel import grouped_matmul_tpu
from repro.kernels.grouped_matmul.ops import grouped_matmul as j_gmm
from repro.kernels.grouped_matmul.ref import grouped_matmul_ref as j_gmm_ref
from repro.kernels.rmsnorm.kernel import fused_rmsnorm_tpu
from repro.kernels.rmsnorm.ops import fused_rmsnorm as j_rms
from repro.kernels.rmsnorm.ref import fused_rmsnorm_ref as j_rms_ref
from repro_torch import kernels as K
from repro_torch.device import DeviceError
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.grouped_matmul import kernel as gmm
from repro_torch.kernels.grouped_matmul import ref as gmm_ref
from repro_torch.kernels.rmsnorm import kernel as rms
from repro_torch.kernels.rmsnorm import ref as rms_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}
PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"


def _tol(dtype: str) -> dict:
    return dict(rtol=2e-5, atol=2e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)


def _j(a, dtype: str):
    return jnp.asarray(a).astype(DTYPES[dtype][0])


def _t(a, dtype: str):
    return torch.from_numpy(a).to(DTYPES[dtype][1])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(pairs, tol: dict) -> None:
    for what, port, ref in pairs:
        assert port.shape == ref.shape, what
        np.testing.assert_allclose(_f32(port), _f32(ref), err_msg=what,
                                   **tol)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _flash_pairs(a, dtype, *, causal=True, window=0, bq=128, bk=128):
    """The four pairs on q (B, H, S, d), k/v (B, KV, T, d); kernel and
    oracle on the kv-expanded heads (``jnp.repeat`` on the JAX side,
    the port's ``ops`` on its own)."""
    jq, jk, jv = (_j(a[n], dtype) for n in "qkv")
    tq, tk, tv = (_t(a[n], dtype) for n in "qkv")
    B, H, S, d = jq.shape
    KV, T = jk.shape[1], jk.shape[2]
    jkx, jvx = (jnp.repeat(t, H // KV, axis=1) for t in (jk, jv))
    tkx, tvx = (torch.from_numpy(np.array(_f32(t))).to(DTYPES[dtype][1])
                for t in (jkx, jvx))
    kw = dict(causal=causal, window=window)
    flat = lambda t, n: t.reshape(B * H, n, d)                # noqa: E731
    got = fa.flash_attention_plain(flat(tq, S), flat(tkx, T), flat(tvx, T),
                                   bq=bq, bk=bk, **kw)
    pairs = [
        ("kernel", got.reshape(B, H, S, d),
         flash_attention_tpu(flat(jq, S), flat(jkx, T), flat(jvx, T), bq=bq,
                             bk=bk, interpret=True, **kw).reshape(
                                 B, H, S, d)),
        ("oracle", fa_ref.flash_attention_ref(tq, tkx, tvx, **kw),
         j_fa_ref(jq, jkx, jvx, **kw)),
        ("ops", K.flash_attention(tq, tk, tv, backend="torch", bq=bq, bk=bk,
                                  **kw),
         j_flash(jq, jk, jv, backend="pallas", bq=bq, bk=bk, **kw)),
        ("ops ref", K.flash_attention(tq, tk, tv, backend="ref", **kw),
         j_flash(jq, jk, jv, backend="ref", **kw)),
    ]
    _close(pairs, _tol(dtype))
    return {what: (port, ref) for what, port, ref in pairs}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,d,bq,bk", [
    (128, 128, 64, 64, 64),
    (256, 256, 64, 128, 64),
    (128, 256, 128, 64, 128),   # cross/cache: T > S
    (64, 64, 32, 64, 64),       # single block
])
def test_flash_attention_causal(S, T, d, bq, bk, dtype):
    a = samples.kernel_inputs("flash_attention", 0, q_shape=(1, 3, S, d),
                              kv_shape=(1, 3, T, d))
    _flash_pairs(a, dtype, bq=bq, bk=bk)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_attention_sliding_window(window):
    a = samples.kernel_inputs("flash_attention", 1, q_shape=(1, 2, 256, 64),
                              kv_shape=(1, 2, 256, 64))
    _flash_pairs(a, "float32", window=window, bq=64, bk=64)


def test_flash_attention_gqa_expansion():
    a = samples.kernel_inputs("flash_attention", 2, q_shape=(2, 8, 128, 32),
                              kv_shape=(2, 2, 128, 32))
    _flash_pairs(a, "float32", bq=64, bk=64)


def test_flash_attention_matches_model_sdpa():
    """The port's op agrees with the JAX model's ``_sdpa`` path."""
    from repro.models.attention import _sdpa, causal_mask
    B, H, S, d = 2, 4, 128, 64
    a = samples.kernel_inputs("flash_attention", 3, q_shape=(B, S, H, d),
                              kv_shape=(B, S, H, d))
    pos = jnp.arange(S)[None]
    want = _sdpa(*(jnp.asarray(a[n]) for n in "qkv"),
                 causal_mask(S, pos, pos), scale=d ** -0.5,
                 kv_map=jnp.arange(H))
    bhsd = {n: np.ascontiguousarray(a[n].transpose(0, 2, 1, 3))
            for n in "qkv"}
    got = _flash_pairs(bhsd, "float32", bq=64, bk=64)["ops"][0]
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 1, 3),
                               np.asarray(want), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", [(8, 4), (8, 2), (4, 1)])
def test_flash_attention_gqa_ops_match_jax(H, KV, dtype):
    """``backend="torch"`` keeps the reference's expansion: equal to the
    JAX op on GQA inputs in both dtypes."""
    a = samples.kernel_inputs("flash_attention", 50 + H // KV,
                              q_shape=(2, H, 96, 32),
                              kv_shape=(2, KV, 96, 32))
    _flash_pairs(a, dtype, window=40, bq=32, bk=32)


@pytest.mark.parametrize("rep", [2, 4])
def test_flash_attention_gqa_repeat_order(rep):
    """Heads expand as ``jnp.repeat`` does, ``[k0, k0, k1, k1, ...]``:
    the port's op follows it, and tiling the heads would not."""
    H = 8
    a = samples.kernel_inputs("flash_attention", 40 + rep,
                              q_shape=(1, H, 64, 32),
                              kv_shape=(1, H // rep, 64, 32))
    got = _flash_pairs(a, "float32", bq=64, bk=64)["ops"][0]
    tq, tk, tv = (torch.from_numpy(a[n]) for n in "qkv")
    tiled = K.flash_attention(tq, tk.repeat(1, rep, 1, 1),
                              tv.repeat(1, rep, 1, 1), backend="torch")
    assert not torch.allclose(got, tiled, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S,T", [(1, 256), (64, 256)])
def test_flash_attention_queries_end_aligned(S, T):
    """Decode (one query) and a chunk of queries against a longer cache:
    queries sit at the end of the keys."""
    a = samples.kernel_inputs("flash_attention", 5, q_shape=(1, 2, S, 64),
                              kv_shape=(1, 2, T, 64))
    _flash_pairs(a, "float32", bq=64, bk=64)


def test_flash_attention_rows_without_keys_c5():
    """S > T under causal: the first S - T query rows see no key.  The
    kernel (JAX and the port's plain version) returns 0 there; the
    oracle (both) the mean of v — ROADMAP C5, kept as the reference
    has it."""
    S, T = 128, 64
    a = samples.kernel_inputs("flash_attention", 6, q_shape=(1, 2, S, 32),
                              kv_shape=(1, 2, T, 32))
    out = _flash_pairs(a, "float32", bq=64, bk=64)
    kernel, oracle = out["kernel"][0], out["oracle"][0]
    assert torch.equal(kernel[:, :, :S - T],
                       torch.zeros_like(kernel[:, :, :S - T]))
    mean_v = torch.from_numpy(a["v"]).mean(dim=2, keepdim=True)
    np.testing.assert_allclose(oracle[:, :, :S - T].numpy(),
                               mean_v.expand(-1, -1, S - T, -1).numpy(),
                               rtol=2e-5, atol=2e-5)
    assert not torch.allclose(kernel[:, :, :S - T], oracle[:, :, :S - T])
    np.testing.assert_allclose(kernel[:, :, S - T:].numpy(),
                               oracle[:, :, S - T:].numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal,window,S,T", [
    (False, 64, 128, 128),      # window without causal: keys ahead too
    (True, 96, 64, 256),        # window with queries offset
])
def test_flash_attention_window_cases(causal, window, S, T):
    a = samples.kernel_inputs("flash_attention", 7, q_shape=(1, 2, S, 64),
                              kv_shape=(1, 2, T, 64))
    _flash_pairs(a, "float32", causal=causal, window=window, bq=64, bk=64)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

def _rms_pairs(a, dtype, bt, eps=1e-6):
    jx, tx = _j(a["x"], dtype), _t(a["x"], dtype)
    js, ts = jnp.asarray(a["scale"]), torch.from_numpy(a["scale"])
    jr = _j(a["residual"], dtype) if "residual" in a else None
    tr = _t(a["residual"], dtype) if "residual" in a else None
    got = rms.fused_rmsnorm_plain(tx, ts, tr, eps=eps, bt=bt)
    outs = {
        "kernel": (got, fused_rmsnorm_tpu(jx, js, jr, eps=eps, bt=bt,
                                          interpret=True)),
        "oracle": (rms_ref.fused_rmsnorm_ref(tx, ts, tr, eps=eps),
                   j_rms_ref(jx, js, jr, eps=eps)),
        "ops": (K.fused_rmsnorm(tx, ts, tr, eps=eps, backend="torch", bt=bt),
                j_rms(jx, js, jr, eps=eps, backend="pallas", bt=bt)),
        "ops ref": (K.fused_rmsnorm(tx, ts, tr, eps=eps, backend="ref"),
                    j_rms(jx, js, jr, eps=eps, backend="ref")),
    }
    _close([(f"{what} {part}", p[i], j[i])
            for what, (p, j) in outs.items()
            for i, part in enumerate(("y", "residual"))], _tol(dtype))
    return outs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,bt", [(256, 512, 128), (128, 1024, 64),
                                    (64, 256, 64)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_fused_rmsnorm(T, D, bt, dtype, with_residual):
    a = samples.kernel_inputs("rmsnorm", 0, T=T, D=D,
                              with_residual=with_residual)
    _rms_pairs(a, dtype, bt)


@pytest.mark.parametrize("with_residual", [False, True])
def test_fused_rmsnorm_bf16_rounding_order(with_residual):
    """Under bf16 the kernel rounds ``y`` to bf16 before the multiply by
    bf16 ``scale``.  On this input that order and rounding ``y * scale``
    once differ at many elements; the port's plain version takes the
    kernel's order there, bit for bit."""
    a = samples.kernel_inputs("rmsnorm", 8, T=64, D=256,
                              with_residual=with_residual)
    got, want = _rms_pairs(a, "bfloat16", 64)["kernel"]
    x = samples.bf16_round(a["x"])
    if with_residual:
        x = x + samples.bf16_round(a["residual"])
    y = x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True) + 1e-6)
    s = samples.bf16_round(a["scale"])
    cast_first = samples.bf16_round(samples.bf16_round(y) * s)
    one_rounding = samples.bf16_round(y * s)
    differ = cast_first != one_rounding
    assert differ.sum() > 100
    port, jax_y = got[0].float().numpy(), _f32(want[0])
    np.testing.assert_array_equal(port[differ], jax_y[differ])
    assert (port[differ] != one_rounding[differ]).mean() > 0.9


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------

def _gmm_pairs(a, dtype, **blocks):
    jx, jw = _j(a["x"], dtype), _j(a["w"], dtype)
    tx, tw = _t(a["x"], dtype), _t(a["w"], dtype)
    got = gmm.grouped_matmul_plain(tx, tw, **blocks)
    pairs = [
        ("kernel", got, grouped_matmul_tpu(jx, jw, interpret=True, **blocks)),
        ("oracle", gmm_ref.grouped_matmul_ref(tx, tw), j_gmm_ref(jx, jw)),
        ("ops", K.grouped_matmul(tx, tw, backend="torch", **blocks),
         j_gmm(jx, jw, backend="pallas", **blocks)),
        ("ops ref", K.grouped_matmul(tx, tw, backend="ref"),
         j_gmm(jx, jw, backend="ref")),
    ]
    _close(pairs, _tol(dtype))
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F,bc,bf,bd", [
    (4, 128, 256, 128, 64, 64, 128),
    (2, 256, 128, 256, 128, 128, 64),
    (8, 64, 64, 64, 64, 64, 64),
])
def test_grouped_matmul(E, C, D, F, bc, bf, bd, dtype):
    a = samples.kernel_inputs("grouped_matmul", 0, E=E, C=C, D=D, F=F)
    _gmm_pairs(a, dtype, bc=bc, bf=bf, bd=bd)


def test_grouped_matmul_matches_moe_einsum():
    a = samples.kernel_inputs("grouped_matmul", 1, E=4, C=128, D=128, F=256)
    got = _gmm_pairs(a, "float32")
    want = jnp.einsum("ecd,edf->ecf", jnp.asarray(a["x"]),
                      jnp.asarray(a["w"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# the shape contract, the device contract, the sources
# ---------------------------------------------------------------------------

# shapes the reference's assert rejects: (kernel, first operand, second
# operand, blocks)
BAD_SHAPES = {
    "rmsnorm T % bt": ("rmsnorm", (96, 32), (32,), dict(bt=64)),
    "gmm C % bc": ("gmm", (2, 96, 64), (2, 64, 64), dict(bc=64)),
    "gmm F % bf": ("gmm", (2, 64, 64), (2, 64, 96), dict(bf=64)),
    "gmm D % bd": ("gmm", (2, 64, 96), (2, 96, 64), dict(bd=64)),
    "flash S % bq": ("flash", (2, 96, 32), (2, 64, 32), dict(bq=64, bk=64)),
    "flash T % bk": ("flash", (2, 64, 32), (2, 96, 32), dict(bq=64, bk=64)),
}


@pytest.mark.parametrize("case", sorted(BAD_SHAPES))
def test_shape_contract_raises_value_error(case):
    kind, p_shape, q_shape, kw = BAD_SHAPES[case]
    p, q = np.zeros(p_shape, np.float32), np.zeros(q_shape, np.float32)
    jp, jq = jnp.asarray(p), jnp.asarray(q)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    if kind == "rmsnorm":
        jax_call = lambda: fused_rmsnorm_tpu(jp, jq, **kw)    # noqa: E731
        port_calls = [lambda: rms.fused_rmsnorm_plain(tp, tq, **kw),
                      lambda: rms.fused_rmsnorm_cuda(tp, tq, **kw),
                      lambda: K.fused_rmsnorm(tp, tq, backend="torch", **kw)]
    elif kind == "gmm":
        jax_call = lambda: grouped_matmul_tpu(jp, jq, **kw)   # noqa: E731
        port_calls = [lambda: gmm.grouped_matmul_plain(tp, tq, **kw),
                      lambda: gmm.grouped_matmul_cuda(tp, tq, **kw),
                      lambda: K.grouped_matmul(tp, tq, backend="torch",
                                               **kw)]
    else:
        jax_call = lambda: flash_attention_tpu(jp, jq, jq, **kw)  # noqa
        port_calls = [lambda: fa.flash_attention_plain(tp, tq, tq, **kw),
                      lambda: fa.flash_attention_cuda(tp, tq, tq, **kw),
                      lambda: K.flash_attention(tp[None], tq[None], tq[None],
                                                backend="torch", **kw)]
    with pytest.raises(AssertionError):
        jax_call()
    for call in port_calls:
        with pytest.raises(ValueError, match="multiple"):
            call()


@pytest.mark.parametrize("group,q_shape,kv_shape,what", [
    (3, (8, 64, 32), (8, 64, 32), "dividing"),     # 3 does not divide 8
    (0, (8, 64, 32), (8, 64, 32), "dividing"),
    (2.0, (8, 64, 32), (4, 64, 32), "dividing"),
    (2, (8, 64, 32), (8, 64, 32), "BH / group"),   # k/v not 8 / 2 heads
    (4, (8, 64, 32), (4, 64, 32), "BH / group"),
    (2, (8, 64, 32), (4, 64, 16), "BH / group"),   # head dims disagree
])
def test_flash_attention_cuda_refuses_a_bad_group(group, q_shape, kv_shape,
                                                  what):
    """A ``group`` that does not divide the query heads, or k/v shapes that
    disagree with it, raise ``ValueError`` before any launch (the CPU
    tensors here would raise ``DeviceError`` at the launch)."""
    q, kv = torch.zeros(q_shape), torch.zeros(kv_shape)
    before = fa.KERNEL.launches
    with pytest.raises(ValueError, match=what):
        fa.flash_attention_cuda(q, kv, kv, group=group)
    assert fa.KERNEL.launches == before


def test_flash_attention_op_refuses_heads_not_a_multiple_of_kv():
    q, kv = torch.zeros(1, 6, 32, 16), torch.zeros(1, 4, 32, 16)
    for backend in ("torch", "ref"):
        with pytest.raises(ValueError, match="multiple of the 4 kv heads"):
            K.flash_attention(q, kv, kv, backend=backend)


def test_flash_attention_op_hands_the_kernel_kv_heads_unexpanded(
        monkeypatch):
    """``backend="cuda"``: no ``repeat_interleave``; the kernel gets k/v
    as (B KV, T, d) and ``group = H / KV``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    seen = {}

    def kernel(q, k, v, **kw):
        seen.update(q=q.shape, k=k.shape, v=v.shape, **kw)
        return torch.zeros_like(q)

    def expand(*a, **k):
        raise AssertionError("the kernel path expanded the kv heads")
    monkeypatch.setattr(fa_ops, "on_card", lambda *a: None)
    monkeypatch.setattr(fa_ops, "flash_attention_cuda", kernel)
    monkeypatch.setattr(torch, "repeat_interleave", expand)
    q, kv = torch.zeros(2, 8, 64, 32), torch.zeros(2, 2, 96, 32)
    out = K.flash_attention(q, kv, kv, window=16)
    assert out.shape == (2, 8, 64, 32)
    assert (seen["q"], seen["k"], seen["v"]) == (
        (16, 64, 32), (4, 96, 32), (4, 96, 32))
    assert (seen["group"], seen["window"], seen["causal"]) == (4, 16, True)


@pytest.mark.parametrize("BH,S,T,d,group,splits,rows,keys", [
    (128, 1, 32768, 128, 2, 4, 16, 64),     # qwen3-1.7b decode, 8 seqs
    (16, 4096, 4096, 128, 2, 1, 128, 64),   # qwen3-1.7b prefill
    (8, 1, 4096, 128, 2, 8, 16, 64),        # 4 blocks; 8-tile chunks
    (8, 1, 256, 64, 1, 1, 16, 64),          # 4 kv tiles: too few
    (16, 1, 2048, 256, 16, 4, 16, 64),      # one block, 32 kv tiles
    (512, 1, 4096, 128, 1, 1, 16, 64),      # 512 blocks fill the card
    (8, 96, 4096, 256, 1, 16, 64, 32),      # d = 256: 32-key tiles
    (32, 4096, 4096, 160, 4, 1, 128, 32),   # d = 160, two m-tiles
])
def test_kv_splits_follow_the_shapes(BH, S, T, d, group, splits, rows,
                                     keys):
    """Split-KV is a function of the shapes: as many chunks as keep the
    blocks within one wave of two per SM of an H100, each of 8 kv tiles
    or more; the rows a block and the keys a kv tile as the launcher
    picks them."""
    plan = fa.attention_plan(BH, S, T, d, group, torch.bfloat16)
    assert fa.kv_splits(BH, S, T, d, group) == plan["splits"] == splits
    assert plan["launches"] == (2 if splits > 1 else 1)
    assert (plan["rows_per_block"], plan["keys_per_tile"]) == (rows, keys)
    f32 = fa.attention_plan(BH, S, T, d, group, torch.float32)
    assert (f32["splits"], f32["launches"]) == (1, 1)



@pytest.mark.parametrize("cell,E,C,D,F,ptrs,route,tiles,blocks", [
    ("olmoe-1b-7b", 64, 640, 2048, 1024, (0, 0), "wgmma", 1280, 132),
    ("llama4-scout-17b-a16e", 16, 640, 5120, 8192, (0, 0), "wgmma", 2560,
     132),
    ("few tiles", 3, 100, 72, 40, (256, 4096), "wgmma", 3, 3),
    ("F % 8", 1, 128, 48, 130, (0, 0), "wmma", 2, 2),
    ("D % 8", 2, 64, 36, 64, (0, 0), "wmma", 2, 2),
    ("x misaligned", 2, 100, 72, 40, (2, 0), "wmma", 2, 2),
    ("w misaligned", 2, 100, 72, 40, (0, 8), "wmma", 2, 2),
])
def test_gmm_plan_routes(cell, E, C, D, F, ptrs, route, tiles, blocks):
    """bfloat16 goes to wgmma where TMA can describe x and w (rows of a
    multiple of 16 bytes, 16-byte-aligned bases), as a persistent grid of
    at most one block per SM over 128 x 256 tiles; otherwise to WMMA, a
    block per 128 x 128 tile.  One launch either way."""
    plan = gmm.gmm_plan(E, C, D, F, torch.bfloat16, *ptrs, sms=132)
    assert (plan["route"], plan["tiles"], plan["blocks"],
            plan["launches"]) == (route, tiles, blocks, 1)
    assert plan["tile"] == gmm.GMM_TILES[route]
    if route == "wgmma":
        assert plan["stages"] == 4 and plan["waves"] == tiles / 132


def test_gmm_plan_float32_and_other_dtypes():
    """float32 runs on the CUDA cores as it is; float16 and mixed
    operands are widened to float32 for the same kernel (ROADMAP C7);
    a dtype the reference's kernel does not take raises."""
    plan = gmm.gmm_plan(64, 640, 2048, 1024, torch.float32, sms=132)
    assert (plan["route"], plan["tile"], plan["tiles"], plan["blocks"],
            plan["launches"], plan["upcast"]) == (
                "cuda cores", (64, 64, 16), 10240, 10240, 1, False)
    for xdt, wdt in ((torch.float16, None), (torch.bfloat16, torch.float32),
                     (torch.float32, torch.bfloat16),
                     (torch.bfloat16, torch.float16)):
        plan = gmm.gmm_plan(2, 64, 64, 64, xdt, w_dtype=wdt)
        assert (plan["route"], plan["upcast"], plan["launches"]) == (
            "cuda cores", True, 1)
    assert not gmm.gmm_plan(2, 64, 64, 64, torch.bfloat16)["upcast"]
    for xdt, wdt in ((torch.float64, None), (torch.bfloat16, torch.int32)):
        with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
            gmm.gmm_plan(2, 64, 64, 64, xdt, w_dtype=wdt)


def test_launch_entries_match_the_sources():
    """Each wrapper's argument codes (``p`` pointer, ``i`` int, ``f``
    float, the stream left out) are the ``extern "C"`` launcher's
    parameters, in order: ctypes would otherwise pass wrong values."""
    for kernel in (rms.KERNEL, gmm.KERNEL, fa.KERNEL):
        text = kernel.source.read_text()
        for entry, codes in kernel.entries.items():
            m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
            assert m, (kernel.name, entry)
            params = [q.strip() for q in m.group(1).split(",")]
            assert params[-1] == "void *stream", (entry, params[-1])
            got = "".join("p" if "*" in q else "f" if q.startswith("float")
                          else "i" for q in params[:-1])
            assert got == codes, (entry, got, codes)

def _op_calls(backend=None):
    kw = {} if backend is None else {"backend": backend}
    x = torch.zeros(64, 32)
    q = torch.zeros(1, 2, 64, 32)
    return {"fused_rmsnorm": lambda: K.fused_rmsnorm(x, torch.ones(32), **kw),
            "grouped_matmul": lambda: K.grouped_matmul(
                torch.zeros(2, 64, 32), torch.zeros(2, 32, 64), **kw),
            "flash_attention": lambda: K.flash_attention(q, q, q, **kw)}


def _wrapper_calls():
    x = torch.zeros(64, 32)
    q = torch.zeros(2, 64, 32)
    return {"fused_rmsnorm": lambda: rms.fused_rmsnorm_cuda(
                x, torch.ones(32), x),
            "grouped_matmul": lambda: gmm.grouped_matmul_cuda(
                torch.zeros(2, 64, 32), torch.zeros(2, 32, 64)),
            "flash_attention": lambda: fa.flash_attention_cuda(q, q, q)}


@pytest.mark.parametrize("op", ["fused_rmsnorm", "grouped_matmul",
                                "flash_attention"])
def test_cuda_backend_is_default_and_raises_without_a_card(op):
    assert inspect.signature(getattr(K, op)).parameters["backend"].default \
        == "cuda"
    for backend in (None, "cuda"):
        with pytest.raises(DeviceError, match="CUDA device"):
            _op_calls(backend)[op]()
    with pytest.raises(DeviceError, match="CUDA device"):
        _wrapper_calls()[op]()


@pytest.mark.parametrize("op", ["fused_rmsnorm", "grouped_matmul",
                                "flash_attention"])
def test_cuda_backend_refuses_cpu_tensors(op, monkeypatch):
    """With a card present, CPU tensors still raise: ``backend="cuda"``
    neither copies them over nor runs the plain version."""
    monkeypatch.setattr(_build, "have_cuda", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    plain = {"fused_rmsnorm": (rms, "fused_rmsnorm_plain"),
             "grouped_matmul": (gmm, "grouped_matmul_plain"),
             "flash_attention": (fa, "flash_attention_plain")}[op]

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(*plain, no_plain)
    with pytest.raises(DeviceError, match="CUDA tensors"):
        _op_calls("cuda")[op]()
    with pytest.raises(DeviceError, match="CUDA tensors"):
        _wrapper_calls()[op]()


def test_unknown_backend_raises():
    for op in ("fused_rmsnorm", "grouped_matmul", "flash_attention"):
        with pytest.raises(ValueError, match="backend"):
            _op_calls("pallas")[op]()


def test_cuda_sources_call_no_library_kernel():
    """The three kernels are written by hand: their sources include only
    the CUDA runtime, the driver API's declarations (for tensor maps),
    bf16, fp16 and WMMA-intrinsic headers and name no cuBLAS, cuDNN or
    CUTLASS/CuTe code, and the CUDA wrappers call no torch product or
    attention."""
    sources = sorted(PKG.glob("*/csrc/*.cu"))
    assert [p.parent.parent.name for p in sources] == [
        "flash_attention", "grouped_matmul", "rmsnorm"]
    for p in sources:
        text = p.read_text()
        assert set(re.findall(r"#include\s*[<\"]([^>\"]+)", text)) <= {
            "cuda.h", "cuda_runtime.h", "cuda_bf16.h", "cuda_fp16.h",
            "mma.h"}, p
        assert not re.search(r"cublas|cudnn|cutlass|cute::", text,
                             re.IGNORECASE), p
        assert "__global__" in text and "cudaGetLastError" in text, p
    banned = {"matmul", "bmm", "mm", "einsum", "baddbmm", "addmm",
              "scaled_dot_product_attention", "rms_norm", "linear",
              "repeat_interleave", "repeat", "expand"}
    for mod, fn in ((rms, "fused_rmsnorm_cuda"),
                    (gmm, "grouped_matmul_cuda"),
                    (fa, "flash_attention_cuda")):
        tree = ast.parse(inspect.getsource(getattr(mod, fn)))
        called = {n.func.attr for n in ast.walk(tree)
                  if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Attribute)}
        assert not called & banned, (fn, called & banned)


def test_inputs_have_the_same_bf16_bits_in_both_frameworks():
    a = samples.kernel_inputs("flash_attention", 9, q_shape=(2, 64, 32),
                              kv_shape=(2, 64, 32))["q"]
    want = samples.bf16_round(a)
    np.testing.assert_array_equal(_t(a, "bfloat16").float().numpy(), want)
    np.testing.assert_array_equal(_f32(_j(a, "bfloat16")), want)


def test_build_error_names_the_source(monkeypatch):
    """A model kernel that cannot build says which source it was, not a
    policy kernel."""
    from repro_torch.core import cudac

    monkeypatch.setattr(cudac, "nvcc_path", lambda: None)
    k = _build.CudaKernel("fused_rmsnorm", "rmsnorm/csrc/rmsnorm.cu",
                          {"rmsnorm_launch": "pppppiifi"})
    with pytest.raises(cudac.CudacError,
                       match=r"cannot build the fused_rmsnorm kernel "
                             r"\(kernels/rmsnorm/csrc/rmsnorm.cu\)"):
        k.build()
    assert k.launches == 0


# ---------------------------------------------------------------------------
# operand dtypes (ROADMAP C7): mixed and float16, as the reference takes
# them.  The Pallas kernels cast every operand to f32 as they load it and
# write x's (q's) dtype; the port's "torch" backend against the JAX op
# (Pallas interpreted) on the same seeded inputs, rtol = atol = 2e-5
# where the output is float32, 2e-2 where it is bfloat16 or float16.
# ---------------------------------------------------------------------------

MIXES = [("bfloat16", "float32"), ("float32", "bfloat16"),
         ("float16", "float16"), ("float16", "bfloat16"),
         ("bfloat16", "float16"), ("float32", "float16")]


def _same_dtype(port, ref) -> None:
    assert str(port.dtype) == f"torch.{jnp.asarray(ref).dtype}"


@pytest.mark.parametrize("xdt,odt", MIXES)
def test_fused_rmsnorm_operand_dtypes(xdt, odt):
    """x in ``xdt``; the residual and scale in ``odt``."""
    a = samples.kernel_inputs("rmsnorm", 9, T=64, D=256, with_residual=True)
    got = K.fused_rmsnorm(_t(a["x"], xdt), _t(a["scale"], odt),
                          _t(a["residual"], odt), backend="torch", bt=32)
    want = j_rms(_j(a["x"], xdt), _j(a["scale"], odt),
                 _j(a["residual"], odt), backend="pallas", bt=32)
    for port, ref in zip(got, want):
        _same_dtype(port, ref)
        np.testing.assert_allclose(_f32(port), _f32(ref), **_tol(xdt))


@pytest.mark.parametrize("xdt,wdt", MIXES)
def test_grouped_matmul_operand_dtypes(xdt, wdt):
    a = samples.kernel_inputs("grouped_matmul", 9, E=2, C=64, D=128, F=64)
    kw = dict(bc=64, bf=64, bd=64)
    got = K.grouped_matmul(_t(a["x"], xdt), _t(a["w"], wdt), backend="torch",
                           **kw)
    want = j_gmm(_j(a["x"], xdt), _j(a["w"], wdt), backend="pallas", **kw)
    _same_dtype(got, want)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(xdt))


@pytest.mark.parametrize("qdt,kdt,vdt", [
    (x, o, o) for x, o in MIXES] + [("bfloat16", "float32", "float16")])
def test_flash_attention_operand_dtypes(qdt, kdt, vdt):
    a = samples.kernel_inputs("flash_attention", 9, q_shape=(1, 4, 64, 32),
                              kv_shape=(1, 2, 64, 32))
    kw = dict(window=40, bq=32, bk=32)
    got = K.flash_attention(_t(a["q"], qdt), _t(a["k"], kdt),
                            _t(a["v"], vdt), backend="torch", **kw)
    want = j_flash(_j(a["q"], qdt), _j(a["k"], kdt), _j(a["v"], vdt),
                   backend="pallas", **kw)
    _same_dtype(got, want)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(qdt))


@pytest.fixture
def stub_card(monkeypatch):
    """The wrappers with the device check passed and the launch recorded
    in place of the kernel (ROADMAP C7's reproduction): what reaches the
    kernel, with no card."""
    launched = []
    for mod in (rms, gmm, fa):
        monkeypatch.setattr(mod, "on_card", lambda *a: None)
        monkeypatch.setattr(mod.KERNEL, "launch",
                            lambda entry, *args: launched.append(
                                (entry, args)))
    return launched


@pytest.mark.parametrize("xdt,odt", MIXES)
def test_cuda_wrappers_take_the_reference_dtypes(stub_card, xdt, odt):
    """No ``ValueError`` on mixed or float16 operands.  RMSNorm passes a
    dtype code per operand; the grouped matmul and attention widen to
    float32 and launch the float32 kernel; every output in x's (q's)
    dtype."""
    X, O = DTYPES[xdt][1], DTYPES[odt][1]
    code = _build.DTYPE_CODE
    x, r, s = torch.zeros(64, 128, dtype=X), torch.zeros(64, 128, dtype=O), \
        torch.zeros(128, dtype=O)
    y, res = rms.fused_rmsnorm_cuda(x, s, r, bt=64)
    assert y.dtype == res.dtype == X
    entry, args = stub_card.pop()
    assert entry == "rmsnorm_launch" and args[-2:] == (code[X], code[O])

    xg, wg = torch.zeros(2, 64, 128, dtype=X), torch.zeros(2, 128, 64,
                                                           dtype=O)
    assert gmm.grouped_matmul_cuda(xg, wg).dtype == X
    entry, args = stub_card.pop()
    assert entry == "gmm_launch" and args[-2] == gmm.GMM_ROUTES["cuda cores"]

    q, kv = torch.zeros(4, 64, 32, dtype=X), torch.zeros(2, 64, 32, dtype=O)
    assert fa.flash_attention_cuda(q, kv, kv, group=2).dtype == X
    entry, args = stub_card.pop()
    assert entry == "attn_launch" and args[-1] == code[torch.float32]
    assert not stub_card


def test_cuda_wrappers_keep_bf16_routes_and_refuse_other_dtypes(stub_card):
    """bfloat16 operands keep their tensor-core routes; float64 and ints
    still raise ``ValueError``, before any launch."""
    bf = torch.bfloat16
    xg, wg = torch.zeros(2, 64, 128, dtype=bf), torch.zeros(2, 128, 64,
                                                            dtype=bf)
    gmm.grouped_matmul_cuda(xg, wg)
    plan = gmm.gmm_plan(2, 64, 128, 64, bf, xg.data_ptr(), wg.data_ptr())
    assert stub_card.pop()[1][-2] == gmm.GMM_ROUTES[plan["route"]] != 0
    q, kv = torch.zeros(4, 64, 32, dtype=bf), torch.zeros(2, 64, 32, dtype=bf)
    fa.flash_attention_cuda(q, kv, kv, group=2)
    assert stub_card.pop()[1][-1] == _build.DTYPE_CODE[bf]
    assert fa.attention_plan(4, 64, 64, 32, 2, bf)["kernel"] == \
        "tensor cores"
    for bad in (torch.float64, torch.int32):
        with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
            rms.fused_rmsnorm_cuda(torch.zeros(64, 128, dtype=bad),
                                   torch.zeros(128), bt=64)
        with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
            rms.fused_rmsnorm_cuda(torch.zeros(64, 128), torch.zeros(128),
                                   torch.zeros(64, 128, dtype=bad), bt=64)
        with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
            gmm.grouped_matmul_cuda(xg, wg.to(bad))
        with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
            fa.flash_attention_cuda(q, kv.to(bad), kv, group=2)
    assert not stub_card
