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
                                    (8, 16384, 8), (4, 1000, 4)])
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
    # the residual stream is one cast of the same f32 sum
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
