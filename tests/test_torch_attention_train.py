"""Training attention through B5 (``kernels.flash_attention_train``), on
the CPU.

The differentiable op's plain versions (the forward with its log-sum-exp
and the hand-written backward's arithmetic, ``flash_attention_bwd_plain``)
are held to autograd through the models' ``_sdpa`` in f64 and in f32:
``_sdpa`` takes its logits in f32 whatever the operands, so both dtypes
agree with it to f32's rounding (rtol 1e-5 of the largest gradient in
f64, 2e-5 in f32).  The route (``attention.fused_route``) takes the op
only on a CUDA device (or meta tensors, the dry run's) with bfloat16
operands and a causal, window or no mask: on the CPU ``attention_train`` and ``mla_train`` keep ``_sdpa``'s
bits, held to sha256 digests taken before the route existed.  Forced on
the CPU, the route runs the op's plain versions, which agree with
``_sdpa``; remat reruns the op's forward and no S x S tensor is saved.
``FlopCounterMode`` and the dry run's trace count the op's FLOPs as they
count ``_sdpa``'s.
The kernels themselves are held to these plain versions on the card
(``tests/test_torch_kernels_cuda.py``) and under the CPU emulation
(``tests/test_torch_kernels_emulated.py``).
"""

import hashlib
import types

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import flash_attention_train
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.roofline import TraceAnalyzer
from repro_torch.models import attention as att
from repro_torch.models.layers import MeshAxes
from repro_torch.obs import trace

AX = MeshAxes(dp=1, tp=1)


def _inputs(seed, B, H, KV, S, T, d, dv, dtype):
    rng = np.random.RandomState(seed)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape)).to(dtype) \
            .requires_grad_()
    # the models' layout: (B, S, heads, width)
    return t(B, S, H, d), t(B, T, KV, d), t(B, T, KV, dv), \
        torch.from_numpy(rng.randn(B, S, H, dv)).to(dtype)


def _sdpa_grads(q, k, v, do, *, causal, window):
    S, T = q.shape[1], k.shape[1]
    H, KV = q.shape[2], k.shape[2]
    pq = torch.arange(S)[None] + (T - S)
    pk = torch.arange(T)[None]
    if causal:
        mask = att.causal_mask(S, pq, pk, window=window)
    else:
        mask = torch.ones((1, S, T), dtype=torch.bool)
    out = att._sdpa(q, k, v, mask, scale=q.shape[-1] ** -0.5,
                    kv_map=torch.arange(H) // (H // KV))
    return [out] + list(torch.autograd.grad(out, (q, k, v), do))


def _op_grads(q, k, v, do, *, causal, window):
    out = flash_attention_train(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window).transpose(1, 2)
    return [out] + list(torch.autograd.grad(out, (q, k, v), do))


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-5),
                                        (torch.float32, 2e-5)])
@pytest.mark.parametrize("case,B,H,KV,S,d,dv,causal,window", [
    ("gqa group 2", 2, 4, 2, 40, 16, 16, False, 0),
    ("gqa group 2, causal", 2, 4, 2, 40, 16, 16, True, 0),
    ("latent widths 24 / 16", 1, 2, 2, 33, 24, 16, True, 0),
    ("window", 1, 4, 2, 48, 16, 16, True, 9),
    ("window, group 4", 1, 4, 1, 37, 8, 12, True, 5),
])
def test_plain_op_matches_autograd_through_sdpa(case, B, H, KV, S, d, dv,
                                                causal, window, dtype,
                                                rtol):
    """The output and dq, dk, dv of the op on CPU tensors (the plain
    forward with lse, then flash_attention_bwd_plain) against autograd
    through _sdpa on the same operands."""
    q, k, v, do = _inputs(7, B, H, KV, S, S, d, dv, dtype)
    want = _sdpa_grads(q, k, v, do, causal=causal, window=window)
    got = _op_grads(q, k, v, do, causal=causal, window=window)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(
            g.detach().numpy(), w.detach().numpy(), rtol=0,
            atol=rtol * float(w.detach().abs().max()), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_lse_is_the_masked_logsumexp(dtype):
    """lse = m + log(l) of the plain forward is the log-sum-exp of each
    row's open scaled logits, over kv tiles of 16 keys."""
    q, k, v, _ = _inputs(8, 1, 2, 2, 64, 64, 16, 8, dtype)
    qf, kf, vf = (t.detach().transpose(1, 2).reshape(2, 64, -1)
                  for t in (q, k, v))
    _, lse = fa.flash_attention_plain(qf, kf, vf, window=20, bk=16,
                                      with_lse=True)
    s = qf.double() @ kf.double().transpose(1, 2) / 4.0
    pos = torch.arange(64)
    mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - 20)
    want = torch.where(mask, s, -torch.inf).logsumexp(-1)
    assert lse.dtype == torch.promote_types(dtype, torch.float32)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-5)


def test_rows_without_keys_c5():
    """S > T under causal: the first S - T query rows see no key; the
    forward gives them 0 (ROADMAP C5, where _sdpa gives the mean of v) and
    the plain backward gives them dq 0 and adds nothing of theirs to dk
    and dv: the backward of the plain forward itself, by autograd."""
    BH, S, T, d = 3, 40, 24, 16
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rng.randn(*s)).requires_grad_()
               for s in ((BH, S, d), (BH, T, d), (BH, T, d)))
    do = torch.from_numpy(rng.randn(BH, S, d))
    out, lse = fa.flash_attention_plain(q, k, v, bk=8, with_lse=True)
    assert torch.equal(out[:, :S - T].detach(), torch.zeros(BH, S - T, d))
    want = torch.autograd.grad(out, (q, k, v), do)
    got = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                       out.detach(), do, lse.detach(), bk=8)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-10)
    assert torch.equal(got[0][:, :S - T], torch.zeros(BH, S - T, d))


def test_plain_backward_sums_a_kv_heads_group():
    """dk and dv of a kv head shared by ``group`` query heads are the sum
    of the expanded heads' gradients."""
    rng = np.random.RandomState(10)
    q, do = (torch.from_numpy(rng.randn(6, 32, 8)) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(2, 32, 8)) for _ in range(2))
    kx, vx = (t.repeat_interleave(3, dim=0) for t in (k, v))
    o, lse = fa.flash_attention_plain(q, kx, vx, with_lse=True)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, group=3)
    ex = fa.flash_attention_bwd_plain(q, kx, vx, o, do, lse)
    assert torch.equal(dq, ex[0])
    for g, e in zip((dk, dv), ex[1:]):
        np.testing.assert_allclose(g.numpy(),
                                   e.reshape(2, 3, 32, 8).sum(1).numpy(),
                                   rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def _smoke_params(cfg, seed):
    rng = np.random.RandomState(seed)
    D = cfg.d_model

    def w(*s):
        return torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.1)
    if cfg.is_mla:
        H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
            cfg.v_head_dim
        return {"wq": w(D, H * (dn + dr)),
                "wkv_a": w(D, cfg.kv_lora_rank + dr),
                "kv_norm": 1 + w(cfg.kv_lora_rank),
                "wkv_b": w(cfg.kv_lora_rank, H * (dn + dv)),
                "wo": w(H * dv, D)}
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": w(D, H * hd), "wk": w(D, KV * hd), "wv": w(D, KV * hd),
         "wo": w(H * hd, D)}
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = 1 + w(hd), 1 + w(hd)
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = w(H * hd), w(KV * hd), w(KV * hd)
    return p


def _layer(name, causal, *, seed=5, S=80):
    """One attention layer of ``name``'s smoke config on CPU f32 inputs:
    its output and the gradients of x and of every weight."""
    cfg = get_smoke_config(name)
    p = {k: v.requires_grad_() for k, v in _smoke_params(cfg, seed).items()}
    x = torch.from_numpy(np.random.RandomState(seed + 1).randn(
        2, S, cfg.d_model).astype(np.float32)).requires_grad_()
    y = att.mla_train(p, x, cfg, AX) if cfg.is_mla \
        else att.attention_train(p, x, cfg, AX, causal=causal)
    (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    return [y] + [x.grad] + [p[k].grad for k in sorted(p)]


# sha256 of _layer's tensors, taken before the route existed: every
# training attention ran _sdpa (full and GQA, sliding windows of 64 and
# 32 that bite at S 80, chunked, no mask, latent attention)
SDPA_DIGESTS = {
    ("qwen3-1.7b", True):
        "8c16cb5624c99d2a37f8af920377d1031fdfdeb0d974bdfef1dc3e918d6f5109",
    ("llava-next-mistral-7b", True):
        "943bcf7e2cd2c976683cb231e39bcbab5e9435e3591fcdca47c78fbbd8d78e93",
    ("llama4-scout-17b-a16e", True):
        "5e2089aa86a20708114944360853335d5629502b9767ff09e69633923965bdef",
    ("whisper-large-v3", False):
        "4ab5d74ea9246ebad7263a6b045feb3f681c40478bb57472ac6c3ff6dd549a1c",
    ("moonlight-16b-a3b", True):
        "77b1b542dbbc6f408ede10209e7d8565e364b8a7cd061c069d9b96fcdaed95ea",
    ("recurrentgemma-9b", True):
        "d0f948e988ad6235fa79ee6790e00ce037a0348a9d6c4c45d0d151646d5ab622",
}


@pytest.mark.parametrize("name,causal", sorted(SDPA_DIGESTS))
def test_cpu_training_attention_keeps_sdpa_bits(name, causal):
    """On the CPU the route keeps _sdpa: attention_train and mla_train
    give the bits they gave before the route, forward and backward."""
    h = hashlib.sha256()
    for t in _layer(name, causal):
        h.update(t.detach().numpy().tobytes())
    assert h.hexdigest() == SDPA_DIGESTS[(name, causal)]


def _fake(device="cuda", dtype=torch.bfloat16, d=128):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                 shape=(2, 64, 4, d))


@pytest.mark.parametrize("q,k,v,mask,want", [
    (_fake(), _fake(), _fake(), "causal", True),
    (_fake(), _fake(), _fake(), "window", True),
    (_fake(), _fake(), _fake(), "none", True),
    (_fake(d=192), _fake(d=192), _fake(d=128), "causal", True),
    (_fake(d=256), _fake(d=256), _fake(d=256), "causal", True),
    (_fake(), _fake(), _fake(), "chunked", False),
    (_fake("cpu"), _fake("cpu"), _fake("cpu"), "causal", False),
    (_fake("meta"), _fake("meta"), _fake("meta"), "causal", True),
    (_fake("meta"), _fake("meta"), _fake("meta"), "chunked", False),
    (_fake(dtype=torch.float32), _fake(dtype=torch.float32),
     _fake(dtype=torch.float32), "causal", False),
    (_fake(), _fake(dtype=torch.float16), _fake(), "causal", False),
    (_fake(d=320), _fake(d=320), _fake(), "causal", False),
    (_fake(), _fake(), _fake(d=264), "window", False),
])
def test_fused_route_predicate(q, k, v, mask, want):
    """B5 only for CUDA (and meta, the dry run's stand-in for the card),
    bfloat16 q, k and v, a causal, window or no mask, and widths up to
    256."""
    assert att.fused_route(q, k, v, mask) is want


def _record_route(monkeypatch, force: bool):
    """Record each mask kind the route is asked about; with ``force`` take
    the op wherever the mask allows it, CPU tensors included."""
    seen = []

    def route(q, k, v, mask):
        seen.append(mask)
        return mask in att.FUSED_MASKS if force \
            else att_fused_route(q, k, v, mask)
    att_fused_route = att.fused_route
    monkeypatch.setattr(att, "fused_route", route)
    return seen


def test_chunked_decode_and_cross_keep_sdpa(monkeypatch):
    """The chunked-local mask asks the route and keeps _sdpa even where
    the route is forced; decode and cross attention never ask it."""
    seen = _record_route(monkeypatch, force=True)

    def refuse(*a, **kw):
        raise AssertionError("flash_attention_train called")
    monkeypatch.setattr(att, "flash_attention_train", refuse)
    _layer("llama4-scout-17b-a16e", True, S=24)
    assert seen == ["chunked"]
    cfg = get_smoke_config("qwen3-1.7b")
    p = _smoke_params(cfg, 3)
    x = torch.randn(2, 1, cfg.d_model)
    cache = att.init_cache(cfg, 2, 16, AX, torch.float32, "cpu")
    att.attention_decode(p, x, cache, cfg, AX, torch.tensor([0, 3]))
    k, v = att.encode_kv(p, torch.randn(2, 9, cfg.d_model), cfg, AX)
    att.cross_attention(p, torch.randn(2, 5, cfg.d_model), (k, v), cfg, AX)
    assert seen == ["chunked"]


@pytest.mark.parametrize("name,causal,mask", [
    ("qwen3-1.7b", True, "causal"),
    ("llava-next-mistral-7b", True, "window"),
    ("recurrentgemma-9b", True, "window"),
    ("whisper-large-v3", False, "none"),
    ("moonlight-16b-a3b", True, "causal"),
])
def test_forced_route_matches_sdpa(monkeypatch, name, causal, mask):
    """With the route forced on the CPU, the layer runs the op's plain
    versions (no S x S logits kept) and agrees with _sdpa's layer in f32:
    output and every gradient within 1e-4 of its largest element."""
    want = _layer(name, causal)
    seen = _record_route(monkeypatch, force=True)
    got = _layer(name, causal)
    assert seen == [mask]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                   rtol=0,
                                   atol=1e-4 * float(w.detach().abs().max()))


@pytest.mark.parametrize("n_heads,n_kv,tp,want", [
    (8, 2, 1, 4), (8, 2, 2, 4), (8, 8, 2, 1),
    (8, 2, 4, None),        # kv heads replicated, two q heads a kv head
    (6, 6, 4, None),        # pad heads
    (10, 2, 4, None),
])
def test_kv_group_is_the_kv_map(monkeypatch, n_heads, n_kv, tp, want):
    """_kv_group gives a group only where _kv_map is local head j ->
    j // group on every rank; elsewhere None, and the op takes k and v as
    _kv_map expands them."""
    cfg = get_smoke_config("qwen3-1.7b").with_overrides(
        n_heads=n_heads, n_kv_heads=n_kv)
    ax = types.SimpleNamespace(tp=tp)
    for r in range(tp):
        monkeypatch.setattr(att, "model_rank", lambda _ax, r=r: r)
        group = att._kv_group(cfg, ax)
        assert group == want
        if group is not None:
            kv_map = att._kv_map(cfg, ax, "cpu").tolist()
            assert kv_map == [j // group for j in range(len(kv_map))]


def test_counters_bump_once_a_call(monkeypatch):
    """attn.plain or attn.kernel, once a training attention call, forward
    or recompute, and only while a profiler session runs."""
    trace.clear()
    _layer("qwen3-1.7b", True, S=16)
    assert trace.counter("attn.plain") is None
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        _layer("qwen3-1.7b", True, S=16)
        _layer("moonlight-16b-a3b", True, S=16)
    assert trace.counter("attn.plain") == {"total": 2, "additions": 2}
    assert trace.counter("attn.kernel") is None
    trace.clear()
    _record_route(monkeypatch, force=True)
    cfg = get_smoke_config("qwen3-1.7b")
    p = {k: v.requires_grad_() for k, v in _smoke_params(cfg, 4).items()}
    x = torch.randn(1, 16, cfg.d_model, requires_grad=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        y = checkpoint(lambda h: att.attention_train(p, h, cfg, AX), x,
                       use_reentrant=False)
        y.sum().backward()
    # the forward, then the recompute in the backward
    assert trace.counter("attn.kernel") == {"total": 2, "additions": 2}
    assert trace.counter("attn.plain") is None
    trace.clear()


def test_remat_reruns_the_op_and_saves_no_square(monkeypatch):
    """Under torch.utils.checkpoint the recompute reruns the op's forward
    and the gradients are the ones without remat; without remat, the
    tensors autograd saves hold no S x S one (where _sdpa's do)."""
    _record_route(monkeypatch, force=True)
    cfg = get_smoke_config("qwen3-1.7b")
    S = 48
    p = {k: v.requires_grad_() for k, v in _smoke_params(cfg, 6).items()}
    x = torch.randn(1, S, cfg.d_model, requires_grad=True)
    calls = []
    forward = fa_ops.FlashAttention.forward

    def counted(ctx, *a):
        calls.append(1)
        return forward(ctx, *a)
    monkeypatch.setattr(fa_ops.FlashAttention, "forward",
                        staticmethod(counted))

    def grads(remat):
        for t in [x, *p.values()]:
            t.grad = None
        fn = lambda h: att.attention_train(p, h, cfg, AX)  # noqa: E731
        y = checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
        y.square().sum().backward()
        return [x.grad.clone()] + [p[k].grad.clone() for k in sorted(p)]
    plain = grads(False)
    assert len(calls) == 1
    for a, b in zip(grads(True), plain):
        assert torch.equal(a, b)
    assert len(calls) == 3

    def squares(route):
        monkeypatch.setattr(att, "fused_route", route)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
            att.attention_train(p, x, cfg, AX).sum()
        return [s for s in saved if len(s) >= 2 and s[-2:] == (S, S)]
    assert squares(lambda q, k, v, m: m in att.FUSED_MASKS) == []
    assert squares(lambda q, k, v, m: False)


# ---------------------------------------------------------------------------
# what a dispatch mode counts: FlopCounterMode on the card, the dry run's
# trace on meta tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen3-1.7b", "moonlight-16b-a3b"])
def test_flop_count_is_the_same_on_either_route(monkeypatch, name):
    """FlopCounterMode over a layer's forward and backward counts the same
    FLOPs when its attention takes the op (its forward and backward each
    one op, counted by their formulas) as when it takes _sdpa's einsums."""
    def count(route):
        monkeypatch.setattr(att, "fused_route", route)
        with FlopCounterMode(display=False) as c:
            _layer(name, True, S=32)
        return c.get_total_flops(), c.get_flop_counts()["Global"]
    fused, by_op = count(lambda q, k, v, m: m in att.FUSED_MASKS)
    plain, _ = count(lambda q, k, v, m: False)
    assert fused == plain
    assert by_op[torch.ops.repro_torch.flash_attention_fwd] > 0
    assert by_op[torch.ops.repro_torch.flash_attention_bwd] == \
        2 * by_op[torch.ops.repro_torch.flash_attention_fwd]


def test_meta_tensors_take_the_op(monkeypatch):
    """bfloat16 training attention on meta tensors takes the op, as the
    card would: the roofline trace counts the FLOPs _sdpa's route counts,
    and its working set no longer holds the S x S logits."""
    cfg = get_smoke_config("qwen3-1.7b")
    B, S = 2, 64
    p = {k: v.to("meta", torch.bfloat16).requires_grad_()
         for k, v in _smoke_params(cfg, 3).items()}
    x = torch.empty(B, S, cfg.d_model, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    seen = []
    route = att.fused_route

    def run(force_plain):
        monkeypatch.setattr(att, "fused_route", lambda *a: seen.append(
            route(*a)) or (route(*a) and not force_plain))
        an = TraceAnalyzer()
        with an:
            att.attention_train(p, x, cfg, AX).sum().backward()
        return an
    fused, plain = run(False), run(True)
    assert seen == [True, True]
    assert fused.flops == plain.flops > 0
    square = B * cfg.n_heads * S * S * 4              # f32 logits
    assert fused.peak_bytes + square <= plain.peak_bytes
