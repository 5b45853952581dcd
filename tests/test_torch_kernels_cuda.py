"""The model kernels (B3-B5) on the card, each against its plain version.

Marked ``cuda``; every test skips without a CUDA device and nvcc.  Run
them on the card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Inputs are the CPU tests' (``torch_samples.kernel_inputs``), moved to
the card; the tolerance is the reference's, rtol = atol = 2e-5 in
float32 and 2e-2 in bfloat16 (``chip_smoke.py`` phase 10 runs the same
kernels at full width).
"""

import numpy as np
import pytest
import torch

import torch_samples as samples
from repro_torch import kernels as K
from repro_torch.device import DeviceError
from repro_torch.kernels._build import DTYPE_CODE
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.grouped_matmul import kernel as gmm
from repro_torch.kernels.rmsnorm import kernel as rms

pytestmark = pytest.mark.cuda
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import have_nvcc
    if not have_nvcc():
        pytest.skip("needs nvcc")
    return torch.device("cuda", torch.cuda.current_device())


def _tol(dtype: str) -> dict:
    return dict(rtol=2e-5, atol=2e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)


def _on(a: np.ndarray, dtype: str, card) -> torch.Tensor:
    return torch.from_numpy(a).to(card).to(DTYPES[dtype])


def _close(got, want, dtype: str) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **_tol(dtype))


def _launched(kernel, fn, n: int = 1):
    """``fn()``'s result, synchronised, checking it launched ``n`` times."""
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + n
    return out


# ---------------------------------------------------------------------------
# B3 fused RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,bt", [(256, 512, 128), (128, 1024, 64),
                                    (64, 256, 64), (8, 5120, 8),
                                    (8, 16384, 8), (4, 1000, 4),
                                    (64, 2048, 64), (8, 1001, 8)])
@pytest.mark.parametrize("with_residual", [False, True])
def test_rmsnorm_kernel_matches_plain(card, T, D, bt, dtype, with_residual):
    a = samples.kernel_inputs("rmsnorm", 0, T=T, D=D,
                              with_residual=with_residual)
    x, s = _on(a["x"], dtype, card), torch.from_numpy(a["scale"]).to(card)
    r = _on(a["residual"], dtype, card) if with_residual else None
    y, res = _launched(rms.KERNEL,
                       lambda: rms.fused_rmsnorm_cuda(x, s, r, bt=bt))
    py, pres = rms.fused_rmsnorm_plain(x, s, r, bt=bt)
    _close(y, py, dtype)
    if with_residual:
        # the residual stream is one cast of the same f32 sum
        assert torch.equal(res, pres)
    else:
        # T(f32(x)) is x: the stream is x itself, uncopied
        assert res is x and res.data_ptr() == x.data_ptr()


def _rms_views(card, T, D, dtype, with_residual, offset):
    """x (and the residual) as contiguous views ``offset`` elements into
    their buffers, with scale on the card."""
    a = samples.kernel_inputs("rmsnorm", 2, T=T, D=D,
                              with_residual=with_residual)

    def view(t):
        buf = torch.empty(t.size + offset, dtype=DTYPES[dtype], device=card)
        return buf[offset:].view(T, D).copy_(_on(t, dtype, card))
    return (view(a["x"]), torch.from_numpy(a["scale"]).to(card),
            view(a["residual"]) if with_residual else None)


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype,D", [("bfloat16", 2048), ("float32", 512),
                                     ("bfloat16", 5120)])
def test_rmsnorm_misaligned_base(card, dtype, D, with_residual):
    """A view one element (2 bytes in bf16) off 16-byte alignment takes
    the route rms_plan gives its pointers (smem), one launch, and the
    plain version's result."""
    T = 16
    x, s, r = _rms_views(card, T, D, dtype, with_residual, offset=1)
    plan = rms.rms_plan(T, D, x.dtype, r.dtype if r is not None else None,
                        [x.data_ptr()])
    assert plan["route"] == "smem"
    y, res = _launched(rms.KERNEL, lambda: rms.fused_rmsnorm_cuda(x, s, r,
                                                                  bt=T))
    py, pres = rms.fused_rmsnorm_plain(x, s, r, bt=T)
    _close(y, py, dtype)
    assert torch.equal(res, pres) and (r is not None or res is x)


@pytest.mark.parametrize("dtype,D,warps,nv", [
    ("bfloat16", 2048, 2, 4), ("bfloat16", 2048, 3, 4),
    ("bfloat16", 2048, 4, 2), ("bfloat16", 2048, 8, 1),
    ("bfloat16", 5120, 5, 4), ("bfloat16", 5120, 10, 2),
    ("bfloat16", 5120, 16, 2),
    ("float32", 1000, 4, 2)])
def test_rmsnorm_register_shapes(card, dtype, D, warps, nv):
    """Each register shape the vector route's launcher takes, on a
    persistent grid of 8 blocks (fewer than the rows): the plain
    version's result."""
    T = 300
    x, s, r = _rms_views(card, T, D, dtype, True, offset=0)
    assert rms.rms_plan(T, D, x.dtype, r.dtype)["route"] == "vector"
    y, res = torch.empty_like(x), torch.empty_like(x)
    code = DTYPE_CODE[x.dtype]
    _launched(rms.KERNEL, lambda: rms.KERNEL.launch(
        "rmsnorm_launch", x.data_ptr(), r.data_ptr(), s.data_ptr(),
        y.data_ptr(), res.data_ptr(), T, D, 1e-6, rms.RMS_ROUTES["vector"],
        warps, nv, 8, code, code))
    py, pres = rms.fused_rmsnorm_plain(x, s, r, bt=T)
    _close(y, py, dtype)
    assert torch.equal(res, pres)


# ---------------------------------------------------------------------------
# B4 grouped matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F,bc,bf,bd", [
    (4, 128, 256, 128, 64, 64, 128),
    (2, 256, 128, 256, 128, 128, 64),
    (8, 64, 64, 64, 64, 64, 64),
    (3, 100, 72, 40, 100, 40, 72),      # edges inside the kernel's tiles
])
def test_grouped_matmul_kernel_matches_plain(card, E, C, D, F, bc, bf, bd,
                                             dtype):
    a = samples.kernel_inputs("grouped_matmul", 0, E=E, C=C, D=D, F=F)
    x, w = _on(a["x"], dtype, card), _on(a["w"], dtype, card)
    got = _launched(gmm.KERNEL, lambda: gmm.grouped_matmul_cuda(
        x, w, bc=bc, bf=bf, bd=bd))
    _close(got, gmm.grouped_matmul_plain(x, w, bc=bc, bf=bf, bd=bd), dtype)


def _gmm_route(card, E, C, D, F, route, *, offset=0, seed=3):
    """bf16 x (E, C, D) and w (E, D, F), each a contiguous view starting
    ``offset`` elements into its buffer, through the wrapper: the route
    gmm_plan states, one launch, the plain version's result."""
    a = samples.kernel_inputs("grouped_matmul", seed, E=E, C=C, D=D, F=F)
    x, w = (torch.empty(t.size + offset, dtype=torch.bfloat16, device=card)
            [offset:].view(t.shape).copy_(_on(t, "bfloat16", card))
            for t in (a["x"], a["w"]))
    plan = gmm.gmm_plan(E, C, D, F, x.dtype, x.data_ptr(), w.data_ptr())
    assert plan["route"] == route and plan["launches"] == 1, plan
    got = _launched(gmm.KERNEL, lambda: gmm.grouped_matmul_cuda(
        x, w, bc=C, bf=F, bd=D))
    _close(got, gmm.grouped_matmul_plain(x, w, bc=C, bf=F, bd=D), "bfloat16")
    return plan


@pytest.mark.parametrize("E,C,D,F", [
    (2, 200, 200, 296),     # every tile edge: C, D and F ragged, E > 1
    (2, 300, 520, 264),     # D % 64 == 8: the K tail of each expert
    (3, 100, 72, 40),       # one tile smaller than the box in C and F
    (1, 128, 8, 8),         # one k-step of 8
    (2, 136, 64, 512),
])
def test_grouped_matmul_wgmma_route_edges(card, E, C, D, F):
    _gmm_route(card, E, C, D, F, "wgmma")


def test_grouped_matmul_wgmma_more_tiles_than_sms(card):
    """A persistent grid: each block walks several tiles, the ring wraps
    across them."""
    plan = _gmm_route(card, 8, 640, 320, 1024, "wgmma")
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert plan["tiles"] == 160 and plan["blocks"] == min(160, sms)


@pytest.mark.parametrize("E,C,D,F,offset", [
    (1, 128, 48, 130, 0),     # F % 8 != 0: no TMA row stride
    (2, 64, 36, 64, 0),       # D % 8 != 0
    (2, 100, 72, 40, 1),      # a view 2 bytes past 16-byte alignment
])
def test_grouped_matmul_wmma_route(card, E, C, D, F, offset):
    """Operands TMA cannot describe take the WMMA kernel, by plan."""
    _gmm_route(card, E, C, D, F, "wmma", offset=offset)


# ---------------------------------------------------------------------------
# B5 flash attention
# ---------------------------------------------------------------------------

def _attn(card, dtype, S, T, d, *, BH=3, seed=0, group=1, **kw):
    """The kernel on (BH, S, d) q and (BH / group, T, d) k/v against the
    plain version on k/v expanded as the reference's jnp.repeat, with
    the launches :func:`attention_plan` states."""
    a = samples.kernel_inputs("flash_attention", seed, q_shape=(BH, S, d),
                              kv_shape=(BH // group, T, d))
    q, k, v = (_on(a[n], dtype, card) for n in "qkv")
    plan = fa.attention_plan(BH, S, T, d, group, q.dtype)
    got = _launched(fa.KERNEL, lambda: fa.flash_attention_cuda(
        q, k, v, group=group, **kw), plan["launches"])
    kx, vx = (t.repeat_interleave(group, dim=0) for t in (k, v))
    _close(got, fa.flash_attention_plain(q, kx, vx, **kw), dtype)
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,T,d,bq,bk", [
    (128, 128, 64, 64, 64),
    (256, 256, 64, 128, 64),
    (128, 256, 128, 64, 128),
    (64, 64, 32, 64, 64),
])
def test_flash_attention_kernel_matches_plain(card, S, T, d, bq, bk, dtype):
    _attn(card, dtype, S, T, d, bq=bq, bk=bk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 128, 160, 256])
def test_flash_attention_head_dims(card, d, dtype):
    _attn(card, dtype, 256, 256, d, BH=2, seed=d)


@pytest.mark.parametrize("S,T", [(1, 256), (64, 256), (1, 4096)])
def test_flash_attention_queries_end_aligned(card, S, T):
    _attn(card, "float32", S, T, 128, BH=4, seed=5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_rows_without_keys_are_zero(card, dtype):
    S, T = 256, 64
    got = _attn(card, dtype, S, T, 64, seed=6, bq=64, bk=64)
    assert torch.equal(got[:, :S - T], torch.zeros_like(got[:, :S - T]))
    assert got[:, S - T:].abs().amax() > 0


@pytest.mark.parametrize("causal,window,S,T", [
    (True, 32, 256, 256), (True, 128, 256, 256), (True, 96, 64, 256),
    (False, 64, 128, 128), (True, 200, 512, 512),
])
def test_flash_attention_windows(card, causal, window, S, T):
    _attn(card, "float32", S, T, 64, seed=7, causal=causal, window=window,
          bq=64, bk=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,S,T,d,window", [
    (2, 128, 128, 64, 0), (4, 256, 256, 128, 0), (2, 96, 200, 160, 64),
    (8, 64, 64, 256, 0),
])
def test_flash_attention_kv_heads_indexed(card, group, S, T, d, window,
                                          dtype):
    _attn(card, dtype, S, T, d, BH=8, seed=10 + group, group=group,
          window=window, bq=S, bk=T)


@pytest.mark.parametrize("group,S,T,d,window,splits", [
    (2, 1, 4096, 128, 0, 8),          # decode
    (1, 1, 4096, 64, 0, 8),
    (4, 1, 2048, 256, 0, 4),
    (2, 64, 2048, 64, 10, 4),         # chunks masked off by the window
    (2, 1, 4096, 128, 100, 8),        # all but the last chunks empty
    (1, 1100, 1024, 32, 0, 2),        # rows without keys
])
def test_flash_attention_split_kv(card, group, S, T, d, window, splits):
    """The shapes choose the splits; both launches against the plain
    version."""
    assert fa.attention_plan(8, S, T, d, group, torch.bfloat16)[
        "splits"] == splits
    got = _attn(card, "bfloat16", S, T, d, BH=8, seed=20, group=group,
                window=window, bq=S, bk=T)
    if S > T:
        assert torch.equal(got[:, :S - T], torch.zeros_like(got[:, :S - T]))


# ---------------------------------------------------------------------------
# B5 for training: the forward with the log-sum-exp, the backward
# ---------------------------------------------------------------------------

# the training cells' head layouts at full shape: Qwen3-1.7B (B 4, 16 q
# heads over 8 kv heads, S 2048, 128 wide) and Moonlight-16B-A3B's latent
# attention (B 2, 16 heads, S 4096, q and k 192 wide, v 128)
TRAIN_CELLS = {"qwen3-1.7b": dict(BH=64, group=2, S=2048, d=128, dv=128),
               "moonlight-16b-a3b": dict(BH=32, group=1, S=4096, d=192,
                                         dv=128)}
# Bits of flash_attention_cuda's output, sha256 of its bfloat16 bytes, as
# the forward-only kernel gave them before it could write the
# log-sum-exp (NVIDIA H100 80GB HBM3); the inputs are _digest_inputs',
# the keys DIGEST_CASES' (BH, S, T, d, group, window).
FORWARD_DIGESTS = {
    "(16, 1024, 1024, 128, 2, 0)":
        "ee758ee064351669ee4cd3dca491ab8632f7515df0a385d80475d73481e0dee4",
    "(8, 1, 4096, 128, 2, 0)":
        "0449961dbdad35a38f172279d3ca59a07bfd6fc5161b5cd28ad6d2dcf87d4377",
    "(4, 512, 512, 256, 1, 200)":
        "c469ce8e7424513eecf5ecd98dac8b395c6c4f90c163129432bfbdce5e0abaeb",
    "(8, 384, 384, 160, 4, 0)":
        "32d29dbbbe1c317456e76d737f534e2781469f0b645acd6cb40c4a9e0ceec081",
    "(8, 256, 256, 64, 1, 0)":
        "0af2c4fff007a3984defa447f338a0967b9f2df94a285571a94db78f24fbf396",
    "(4, 200, 300, 96, 2, 64)":
        "ab9e9f48549b5c1b33c16ef0155a13be89a98cc9358b220495d834d43546e903",
}


def _steps_close(name, got, want):
    """Every element within 2^-6 |want| + 2^-8 rms(want): the bf16
    rounding of both outputs (2^-9 relative each) and f32 sums taken in
    another order, with room for the kernel's hi and lo halves of P and
    dS (about 16 bits) and its ex2, and for the elements near 0, where
    the sums cancel (phase 10's limit for the full-width cells)."""
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    limit = 2.0 ** -6 * w.abs() + 2.0 ** -8 * rms
    ratio = float(((g - w).abs() / limit).amax())
    assert ratio <= 1.0, (name, ratio, rms)


def _train_inputs(card, cell, seed):
    c = TRAIN_CELLS[cell]
    BH, g, S, d, dv = c["BH"], c["group"], c["S"], c["d"], c["dv"]
    a = samples.kernel_inputs("flash_attention_grad", seed,
                              q_shape=(BH, S, d), kv_shape=(BH // g, S, d),
                              v_shape=(BH // g, S, dv), do_shape=(BH, S, dv))
    return [_on(a[n], "bfloat16", card) for n in ("q", "k", "v", "do")], g


@pytest.mark.parametrize("cell", sorted(TRAIN_CELLS))
def test_flash_attention_forward_with_lse_at_the_cells(card, cell):
    """One launch writes the output and lse; the output's bits are the
    forward-only call's, lse the plain version's to 1e-4 (f32 sums over
    4096 keys in another order, the kernel's ex2 in units of log2 e)."""
    (q, k, v, _), g = _train_inputs(card, cell, 61)
    out, lse = _launched(fa.KERNEL, lambda: fa.flash_attention_cuda(
        q, k, v, group=g, with_lse=True))
    assert torch.equal(out, fa.flash_attention_cuda(q, k, v, group=g))
    kx, vx = (t.repeat_interleave(g, dim=0) for t in (k, v))
    want, want_lse = fa.flash_attention_plain(q, kx, vx, with_lse=True)
    _steps_close("out", out, want)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell", sorted(TRAIN_CELLS))
def test_flash_attention_backward_at_the_cells(card, cell):
    """Two launches; dq, dk and dv against the plain backward on the
    kernel's own output and lse, element by element (_steps_close)."""
    (q, k, v, do), g = _train_inputs(card, cell, 62)
    o, lse = fa.flash_attention_cuda(q, k, v, group=g, with_lse=True)
    got = _launched(fa.KERNEL, lambda: fa.flash_attention_bwd_cuda(
        q, k, v, o, do, lse, group=g), 2)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, group=g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == torch.bfloat16 and a.shape == b.shape
        _steps_close(name, a, b)


@pytest.mark.parametrize("BH,S,T,d,dv,group,causal,window", [
    (8, 256, 256, 64, 64, 2, True, 0),
    (4, 200, 200, 128, 128, 4, True, 64),
    (4, 192, 320, 192, 128, 1, True, 0),       # queries offset
    (4, 160, 160, 256, 256, 2, True, 0),       # dK and dV columns split
    (4, 320, 128, 160, 160, 1, True, 0),       # rows without keys
    (6, 130, 130, 72, 40, 3, False, 0),        # no mask, v narrower
    (2, 96, 96, 36, 36, 1, True, 0),           # rows of 4.5 chunks
])
def test_flash_attention_backward_shapes(card, BH, S, T, d, dv, group,
                                         causal, window):
    """The backward's tiles, masks and widths against the plain backward;
    a query row without keys has dq 0."""
    a = samples.kernel_inputs("flash_attention_grad", 63,
                              q_shape=(BH, S, d), kv_shape=(BH // group, T, d),
                              v_shape=(BH // group, T, dv),
                              do_shape=(BH, S, dv))
    q, k, v, do = (_on(a[n], "bfloat16", card) for n in ("q", "k", "v", "do"))
    kw = dict(group=group, causal=causal, window=window)
    o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True, bq=S, bk=T,
                                     **kw)
    got = _launched(fa.KERNEL, lambda: fa.flash_attention_bwd_cuda(
        q, k, v, o, do, lse, **kw), 2)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        _steps_close(name, x, y)
    if causal and S > T:
        assert torch.equal(got[0][:, :S - T], torch.zeros_like(
            got[0][:, :S - T]))


def test_flash_attention_backward_repeats_its_bits(card):
    """No float atomics: the same inputs give the same dq, dk and dv bits
    twice, at Qwen3's layout."""
    (q, k, v, do), g = _train_inputs(card, "qwen3-1.7b", 64)
    o, lse = fa.flash_attention_cuda(q, k, v, group=g, with_lse=True)
    one = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, group=g)
    two = fa.flash_attention_bwd_cuda(q, k, v, o, do, lse, group=g)
    for x, y in zip(one, two):
        assert torch.equal(x, y)


def _digest_inputs(card, case):
    BH, S, T, d, group, window = case
    a = samples.kernel_inputs("flash_attention", 70 + S % 7,
                              q_shape=(BH, S, d), kv_shape=(BH // group, T, d))
    return [_on(a[n], "bfloat16", card) for n in "qkv"], group, window


DIGEST_CASES = ((16, 1024, 1024, 128, 2, 0), (8, 1, 4096, 128, 2, 0),
                (4, 512, 512, 256, 1, 200), (8, 384, 384, 160, 4, 0),
                (8, 256, 256, 64, 1, 0), (4, 200, 300, 96, 2, 64))


def forward_digests(card) -> dict:
    """sha256 of flash_attention_cuda's bfloat16 output at each of
    DIGEST_CASES (split-KV decode, windows, each padded width)."""
    import hashlib
    out = {}
    for case in DIGEST_CASES:
        (q, k, v), g, w = _digest_inputs(card, case)
        o = fa.flash_attention_cuda(q, k, v, group=g, window=w,
                                    bq=case[1], bk=case[2])
        out[str(case)] = hashlib.sha256(
            o.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    return out


def test_forward_only_calls_keep_their_bits(card):
    """The forward-only kernel gives the bits it gave before it could
    write the log-sum-exp (FORWARD_DIGESTS)."""
    assert forward_digests(card) == FORWARD_DIGESTS


def test_flash_attention_train_op_on_the_card(card):
    """The differentiable op: its forward's one launch and backward's
    two, counted in FlashAttention.launches; outputs and gradients
    against the same op on the CPU (the plain versions) on the same bf16
    inputs; FlopCounterMode counts the same FLOPs on both (the ops'
    formula: it sees the kernels' launches as one op each)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention.ops import FlashAttention
    a = samples.kernel_inputs("flash_attention_grad", 65,
                              q_shape=(2, 8, 256, 64),
                              kv_shape=(2, 4, 256, 64),
                              v_shape=(2, 4, 256, 64),
                              do_shape=(2, 8, 256, 64))
    ins = [torch.from_numpy(a[n]).to(torch.bfloat16) for n in "qkv"]
    do = torch.from_numpy(a["do"]).to(torch.bfloat16)
    res, flops = {}, []
    for dev in ("cpu", card):
        x = [t.detach().to(dev).requires_grad_() for t in ins]
        before = FlashAttention.launches
        with FlopCounterMode(display=False) as counter:
            out = K.flash_attention_train(*x, window=100)
            out.backward(do.to(dev))
        torch.cuda.synchronize()
        n = FlashAttention.launches - before
        assert n == (3 if dev == card else 0)
        res[str(dev)] = [out] + [t.grad for t in x]
        flops.append(counter.get_total_flops())
    # 2 (d + dv) a query-key pair forward, twice that backward
    assert flops == [3 * 2 * 16 * 256 * 256 * 128] * 2
    for name, g, w in zip(("out", "dq", "dk", "dv"), res[str(card)],
                          res["cpu"]):
        _steps_close(name, g.cpu(), w)


def test_remat_keeps_no_square_tensor(card):
    """attention_train under torch.utils.checkpoint at S 4096, 16 heads:
    the recompute reruns the fused forward (two attn.kernel counts a
    step) and the step's peak stays under one (16, 4096, 4096) f32
    tensor above what it holds at the start."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.configs import get_config
    from repro_torch.models import attention as att
    from repro_torch.models.layers import MeshAxes
    from repro_torch.obs import trace
    cfg = get_config("qwen3-1.7b")
    ax = MeshAxes(dp=1, tp=1)
    g = torch.Generator(device="cpu").manual_seed(0)
    D, hd = cfg.d_model, cfg.hd

    def w(*shape):
        return (torch.randn(*shape, generator=g) * 0.02).to(
            card, torch.bfloat16).requires_grad_()
    p = {"wq": w(D, cfg.n_heads * hd), "wk": w(D, cfg.n_kv_heads * hd),
         "wv": w(D, cfg.n_kv_heads * hd), "wo": w(cfg.n_heads * hd, D),
         "q_norm": torch.ones(hd, device=card, dtype=torch.bfloat16),
         "k_norm": torch.ones(hd, device=card, dtype=torch.bfloat16)}
    x = (torch.randn(1, 4096, D, generator=g)).to(
        card, torch.bfloat16).requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        y = checkpoint(lambda h: att.attention_train(p, h, cfg, ax), x,
                       use_reentrant=False)
        y.float().square().mean().backward()
        torch.cuda.synchronize()
    assert trace.counter("attn.kernel") == {"total": 2, "additions": 2}
    assert trace.counter("attn.plain") is None
    square = cfg.n_heads * 4096 * 4096 * 4
    assert torch.cuda.max_memory_allocated() - base < square


# ---------------------------------------------------------------------------
# the ops on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,KV", [(8, 2), (8, 4), (16, 1)])
def test_flash_attention_op_gqa(card, H, KV, monkeypatch):
    """The op hands the kv heads to the kernel unexpanded."""
    a = samples.kernel_inputs("flash_attention", 8, q_shape=(2, H, 128, 64),
                              kv_shape=(2, KV, 128, 64))
    q, k, v = (_on(a[n], "bfloat16", card) for n in "qkv")
    expand = torch.repeat_interleave
    with monkeypatch.context() as m:
        m.setattr(torch, "repeat_interleave", None)
        got = _launched(fa.KERNEL, lambda: K.flash_attention(q, k, v))
    assert torch.repeat_interleave is expand
    _close(got, K.flash_attention(q, k, v, backend="torch"), "bfloat16")


def test_ops_default_to_the_kernels(card):
    a = samples.kernel_inputs("rmsnorm", 1, T=4, D=64, with_residual=True)
    x = _on(a["x"], "bfloat16", card).reshape(2, 2, 64)
    r = _on(a["residual"], "bfloat16", card).reshape(2, 2, 64)
    s = torch.from_numpy(a["scale"]).to(card)
    y, res = _launched(rms.KERNEL, lambda: K.fused_rmsnorm(x, s, r))
    py, pres = K.fused_rmsnorm(x, s, r, backend="torch")
    _close(y, py, "bfloat16")
    _close(res, pres, "bfloat16")
    g = samples.kernel_inputs("grouped_matmul", 2, E=2, C=64, D=64, F=64)
    gx, gw = _on(g["x"], "float32", card), _on(g["w"], "float32", card)
    _close(_launched(gmm.KERNEL, lambda: K.grouped_matmul(gx, gw)),
           K.grouped_matmul(gx, gw, backend="torch"), "float32")


def test_cuda_backend_raises_on_cpu_tensors(card):
    x = torch.zeros(64, 32)
    q = torch.zeros(1, 2, 64, 32)
    before = [k.launches for k in (rms.KERNEL, gmm.KERNEL, fa.KERNEL)]
    for call in (lambda: K.fused_rmsnorm(x, torch.ones(32)),
                 lambda: K.grouped_matmul(torch.zeros(2, 64, 32),
                                          torch.zeros(2, 32, 64)),
                 lambda: K.flash_attention(q, q, q),
                 lambda: K.flash_attention(q.to(card), q, q.to(card)),
                 lambda: rms.fused_rmsnorm_cuda(x, torch.ones(32)),
                 lambda: gmm.grouped_matmul_cuda(torch.zeros(2, 64, 32),
                                                 torch.zeros(2, 32, 64)),
                 lambda: fa.flash_attention_cuda(q[0], q[0], q[0])):
        with pytest.raises(DeviceError):
            call()
    assert before == [k.launches for k in (rms.KERNEL, gmm.KERNEL,
                                            fa.KERNEL)]


# ---------------------------------------------------------------------------
# operand dtypes (ROADMAP C7): mixed and float16 on the card
# ---------------------------------------------------------------------------

MIXES = [("bfloat16", "float32"), ("float32", "bfloat16"),
         ("float16", "float16"), ("float16", "bfloat16")]


@pytest.mark.parametrize("xdt,odt", MIXES)
def test_fused_rmsnorm_operand_dtypes(card, xdt, odt):
    """The residual and scale in ``odt``: one launch reading each operand
    in its own dtype, both outputs in x's."""
    a = samples.kernel_inputs("rmsnorm", 9, T=64, D=1000,
                              with_residual=True)
    x, r, s = _on(a["x"], xdt, card), _on(a["residual"], odt, card), \
        _on(a["scale"], odt, card)
    y, res = _launched(rms.KERNEL, lambda: rms.fused_rmsnorm_cuda(
        x, s, r, bt=64))
    py, pres = rms.fused_rmsnorm_plain(x, s, r, bt=64)
    _close(y, py, xdt)
    assert torch.equal(res, pres)


@pytest.mark.parametrize("xdt,wdt", MIXES)
def test_grouped_matmul_operand_dtypes(card, xdt, wdt):
    """Widened to float32 on the card, the CUDA-core kernel, one launch,
    the output in x's dtype."""
    a = samples.kernel_inputs("grouped_matmul", 9, E=3, C=100, D=72, F=40)
    x, w = _on(a["x"], xdt, card), _on(a["w"], wdt, card)
    plan = gmm.gmm_plan(3, 100, 72, 40, x.dtype, w_dtype=w.dtype)
    assert (plan["route"], plan["upcast"]) == ("cuda cores", True)
    got = _launched(gmm.KERNEL, lambda: gmm.grouped_matmul_cuda(x, w))
    _close(got, gmm.grouped_matmul_plain(x, w, bc=100, bf=40, bd=72), xdt)


@pytest.mark.parametrize("qdt,kvdt", MIXES)
def test_flash_attention_operand_dtypes(card, qdt, kvdt):
    """Widened to float32 on the card, the CUDA-core kernel with the kv
    heads indexed, one launch, the output in q's dtype."""
    BH, S, T, d, group = 8, 96, 200, 64, 2
    a = samples.kernel_inputs("flash_attention", 9, q_shape=(BH, S, d),
                              kv_shape=(BH // group, T, d))
    q = _on(a["q"], qdt, card)
    k, v = (_on(a[n], kvdt, card) for n in "kv")
    plan = fa.attention_plan(BH, S, T, d, group, q.dtype, k.dtype, v.dtype)
    assert (plan["kernel"], plan["upcast"], plan["launches"]) == (
        "cuda cores", True, 1)
    kw = dict(window=64, bq=S, bk=T)
    got = _launched(fa.KERNEL, lambda: fa.flash_attention_cuda(
        q, k, v, group=group, **kw))
    kx, vx = (t.repeat_interleave(group, dim=0) for t in (k, v))
    _close(got, fa.flash_attention_plain(q, kx, vx, **kw), qdt)
