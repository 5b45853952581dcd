"""GQA attention: full / sliding-window / chunked-local, train + decode;
and multi-head latent attention (``mla_train``), training only.

The port of ``repro/models/attention.py``.  Tensor layout (per rank):
  activations x: (B, S, D)
  wq:  (D, Hp*hd // tp)                   — column-parallel (pad heads)
  wk/wv: (D, KV*hd // tp) if n_kv % tp == 0 else (D, KV*hd) replicated
  wo:  (Hp*hd // tp, D)                   — row-parallel + all-reduce

When tp > n_kv, each rank keeps ALL kv heads (the standard KV-replication
scheme for GQA under wide TP) and uses the group its local q heads map to.

Decode and cross attention run ``_sdpa``: f32 logits, f32 softmax, P
cast to v's dtype before P·V, as the reference computes it.  Training
attention (``attention_train``, ``mla_train``) takes B5 instead,
``kernels.flash_attention_train``: the hand-written forward and backward,
no S x S tensor in device memory, wherever :func:`fused_route` holds (a
CUDA device or meta tensors, bfloat16 operands, a causal, sliding-window
or no mask, widths up to 256); elsewhere, the CPU and the chunked-local
mask included, ``_sdpa`` as before.  The reference's models call no attention
kernel (ROADMAP C6); the port's training path calls B5.  Each training
attention call, forward or recompute, bumps the trace counter
``attn.kernel`` or ``attn.plain``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels.flash_attention.kernel import MAX_HEAD_DIM
from ..kernels.flash_attention.ops import flash_attention_train
from ..obs import trace as _trace
from .config import ModelConfig
from .layers import (MeshAxes, apply_rope, col_linear, model_rank, rms_norm,
                     rope_freqs, row_linear)

NEG_INF = -1e30
# the masks B5 computes itself
FUSED_MASKS = ("causal", "window", "none")


def kv_split(cfg: ModelConfig, ax: MeshAxes) -> bool:
    """KV heads are TP-split only when they divide evenly; otherwise the
    standard KV-replication scheme for GQA under wide TP."""
    return ax.tp > 1 and cfg.n_kv_heads % ax.tp == 0


def _local_heads(cfg: ModelConfig, ax: MeshAxes) -> Tuple[int, int]:
    """(q heads per rank, kv heads per rank)."""
    hp = cfg.padded_heads(ax.tp)
    h_loc = hp // ax.tp
    kv_loc = cfg.n_kv_heads // ax.tp if kv_split(cfg, ax) else cfg.n_kv_heads
    return h_loc, kv_loc


def _kv_map(cfg: ModelConfig, ax: MeshAxes, device):
    """(h_loc,) int64: local q head -> local kv head index (by rank)."""
    h_loc, kv_loc = _local_heads(cfg, ax)
    g = max(1, cfg.n_heads // cfg.n_kv_heads)
    j = torch.arange(h_loc, device=device)
    r = model_rank(ax)
    gq = torch.clamp(r * h_loc + j, max=cfg.n_heads - 1)  # clamp pad heads
    gkv = gq // g
    if kv_split(cfg, ax):
        return torch.clamp(gkv - r * kv_loc, 0, kv_loc - 1)
    return gkv


def _kv_group(cfg: ModelConfig, ax: MeshAxes):
    """The query heads each local kv head serves where ``_kv_map`` sends
    local q head ``j`` to local kv head ``j // group`` (B5's order); None
    where it is another map (pad heads under wide TP)."""
    h_loc, kv_loc = _local_heads(cfg, ax)
    if h_loc % kv_loc:
        return None
    group = h_loc // kv_loc
    m = _kv_map(cfg, ax, "cpu").tolist()
    return group if m == [j // group for j in range(h_loc)] else None


def qkv_project(p, x, cfg: ModelConfig, ax: MeshAxes, positions,
                *, use_rope: bool = True):
    """Returns q (B,S,h_loc,hd), k/v (B,S,kv_loc,hd)."""
    hd = cfg.hd
    h_loc, kv_loc = _local_heads(cfg, ax)
    q = col_linear(x, p["wq"], ax, bias=p.get("bq"), fsdp_dim=0)
    k = col_linear(x, p["wk"], ax, bias=p.get("bk"), fsdp_dim=0)
    v = col_linear(x, p["wv"], ax, bias=p.get("bv"), fsdp_dim=0)
    B, S = x.shape[0], x.shape[1]
    q = q.reshape(B, S, h_loc, hd)
    k = k.reshape(B, S, kv_loc, hd)
    v = v.reshape(B, S, kv_loc, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if use_rope:
        ang = rope_freqs(hd, cfg.rope_theta, positions)
        q = apply_rope(q, ang)
        k = apply_rope(k, ang)
    return q, k, v


def _sdpa(q, k, v, mask, *, scale, kv_map):
    """(B,S,h,hd) x (B,T,kv,hd) x (B,T,kv,dv) -> (B,S,h,dv).

    ``kv_map`` (h,) maps each local q head to its local kv head; None
    where k and v have a head for each q head already."""
    B, S, H, hd = q.shape
    if kv_map is not None:
        k = k.index_select(2, kv_map)   # (B, T, H, hd)
        v = v.index_select(2, kv_map)
    logits = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    logits = torch.where(mask[:, None, :, :], logits,
                         torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", w.to(v.dtype), v)
    return out.reshape(B, S, H, v.shape[-1])


def fused_route(q, k, v, mask: str) -> bool:
    """Whether training attention runs B5 (``flash_attention_train``):
    q on a CUDA device (or on meta tensors, the dry run's stand-in for the
    card), q, k and v bfloat16, ``mask`` one of ``FUSED_MASKS``
    ("chunked" is not), q/k's and v's widths at most ``MAX_HEAD_DIM``.
    Only what the call observes decides."""
    return (q.device.type in ("cuda", "meta")
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and mask in FUSED_MASKS
            and max(q.shape[-1], v.shape[-1]) <= MAX_HEAD_DIM)


def _fused(q, k, v, *, causal: bool, window: int, scale: float, group,
           kv_map):
    """B5 on the model's layout: q (B, S, h, d), k (B, S, kv, d), v (B, S,
    kv, dv), local q head ``j`` reading kv head ``j // group`` (k and v
    first taken by ``kv_map`` where ``group`` is None).  (B, S, h, dv)."""
    if group is None:
        k, v = k.index_select(2, kv_map), v.index_select(2, kv_map)
    out = flash_attention_train(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window, scale=scale)
    return out.transpose(1, 2)


def causal_mask(S: int, positions, kv_positions, *, window: int = 0):
    """(B|1, S, T) boolean mask; window > 0 = sliding window."""
    pq = positions[..., :, None]          # (B|1, S, 1)
    pk = kv_positions[..., None, :]       # (B|1, 1, T)
    m = pk <= pq
    if window > 0:
        m = m & (pk > pq - window)
    return m


def _window(cfg: ModelConfig) -> int:
    return cfg.window if cfg.attention in ("sliding", "chunked") else 0


def attention_train(p, x, cfg: ModelConfig, ax: MeshAxes, *,
                    use_rope: bool = True, causal: bool = True):
    """Training/prefill path, no cache.  Sliding window per cfg.attention."""
    B, S, D = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    q, k, v = qkv_project(p, x, cfg, ax, positions[0], use_rope=use_rope)
    window = _window(cfg) if causal else 0
    if not causal:
        kind = "none"
    elif cfg.attention == "chunked":
        kind = "chunked"
    else:
        kind = "window" if window else "causal"
    if fused_route(q, k, v, kind):
        _trace.bump(_trace.ATTN_KERNEL)
        group = _kv_group(cfg, ax)
        out = _fused(q, k, v, causal=causal, window=window,
                     scale=cfg.hd ** -0.5, group=group,
                     kv_map=None if group else _kv_map(cfg, ax, x.device))
    else:
        _trace.bump(_trace.ATTN_PLAIN)
        if causal:
            mask = causal_mask(S, positions, positions, window=window)
        else:
            mask = torch.ones((1, S, S), dtype=torch.bool, device=x.device)
        out = _sdpa(q, k, v, mask, scale=cfg.hd ** -0.5,
                    kv_map=_kv_map(cfg, ax, x.device))
    out = out.reshape(B, S, -1)
    return row_linear(out, p["wo"], ax, fsdp_dim=1)


def mla_train(p, x, cfg: ModelConfig, ax: MeshAxes):
    """Multi-head latent attention (DeepSeek-V3, no query LoRA), causal,
    training/prefill path: ``q = x wq`` split per head into ``q_nope``
    and ``q_pe``; ``[c, k_pe] = x wkv_a``, ``c`` RMS-normed;
    ``[k_nope, v] = c wkv_b``; RoPE on ``q_pe`` and on ``k_pe``, one
    head shared by every q head, rotating the two halves; softmax over
    ``[q_nope, q_pe] . [k_nope, k_pe]`` scaled by ``(nope + rope)^-0.5``;
    ``o = attn . v``, then ``wo``.  Heads are not split (tp == 1)."""
    if ax.tp > 1:
        raise NotImplementedError("latent attention runs at tp == 1")
    B, S, D = x.shape
    H, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    q = col_linear(x, p["wq"], ax, fsdp_dim=0).reshape(B, S, H, dn + dr)
    c, k_pe = col_linear(x, p["wkv_a"], ax, fsdp_dim=0).split(
        [cfg.kv_lora_rank, dr], dim=-1)
    c = rms_norm(c, p["kv_norm"], cfg.rms_eps)
    k_nope, v = col_linear(c, p["wkv_b"], ax, fsdp_dim=0).reshape(
        B, S, H, dn + dv).split([dn, dv], dim=-1)
    ang = rope_freqs(dr, cfg.rope_theta, positions[0])
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    q = torch.cat([q_nope, apply_rope(q_pe, ang)], dim=-1)
    k_pe = apply_rope(k_pe[:, :, None, :], ang).expand(B, S, H, dr)
    k = torch.cat([k_nope, k_pe], dim=-1)
    if fused_route(q, k, v, "causal"):
        _trace.bump(_trace.ATTN_KERNEL)
        out = _fused(q, k, v, causal=True, window=0,
                     scale=(dn + dr) ** -0.5, group=1, kv_map=None)
    else:
        _trace.bump(_trace.ATTN_PLAIN)
        mask = causal_mask(S, positions, positions)
        out = _sdpa(q, k, v, mask, scale=(dn + dr) ** -0.5, kv_map=None)
    return row_linear(out.reshape(B, S, H * dv), p["wo"], ax, fsdp_dim=1)


def attention_decode(p, x, cache, cfg: ModelConfig, ax: MeshAxes, pos,
                     *, use_rope: bool = True):
    """One-token decode against a KV cache.

    cache: dict(k=(B, C, kv_loc, hd), v=..., pos=(B, C), idx=() int32
    write index shared by every row).  For sliding-window configs C ==
    window (ring buffer); for full attention C == max context.  pos: (B,)
    absolute positions.  Returns (y, new cache); ``cache`` is unchanged.
    """
    B, S, D = x.shape
    assert S == 1
    q, k, v = qkv_project(p, x, cfg, ax, pos[:, None], use_rope=use_rope)
    C = cache["k"].shape[1]
    slot = torch.remainder(cache["idx"], C).long().reshape(1)
    # write the new kv at the ring slot (no host read of the index)
    ck = cache["k"].index_copy(1, slot, k)
    cv = cache["v"].index_copy(1, slot, v)
    # kv positions for masking: the ring buffer holds absolute positions
    kpos = cache["pos"].index_copy(1, slot, pos[:, None].to(torch.int32))
    mask = causal_mask(1, pos[:, None], kpos, window=_window(cfg))
    mask = mask & (kpos[:, None, :] >= 0)
    out = _sdpa(q, ck, cv, mask, scale=cfg.hd ** -0.5,
                kv_map=_kv_map(cfg, ax, x.device))
    out = out.reshape(B, 1, -1)
    y = row_linear(out, p["wo"], ax, fsdp_dim=1)
    new_cache = dict(k=ck, v=cv, pos=kpos, idx=cache["idx"] + 1)
    return y, new_cache


def cross_attention(p, x, enc_kv, cfg: ModelConfig, ax: MeshAxes):
    """Encoder-decoder cross attention (whisper). enc_kv: (k, v) tensors."""
    B, S, D = x.shape
    hd = cfg.hd
    h_loc, kv_loc = _local_heads(cfg, ax)
    q = col_linear(x, p["wq"], ax, fsdp_dim=0).reshape(B, S, h_loc, hd)
    k, v = enc_kv
    T = k.shape[1]
    mask = torch.ones((1, S, T), dtype=torch.bool, device=x.device)
    out = _sdpa(q, k, v, mask, scale=hd ** -0.5,
                kv_map=_kv_map(cfg, ax, x.device))
    return row_linear(out.reshape(B, S, -1), p["wo"], ax, fsdp_dim=1)


def encode_kv(p, enc_out, cfg: ModelConfig, ax: MeshAxes):
    """Precompute cross-attention K/V from encoder output."""
    B, T, D = enc_out.shape
    _, kv_loc = _local_heads(cfg, ax)
    k = col_linear(enc_out, p["wk"], ax, fsdp_dim=0).reshape(B, T, kv_loc,
                                                             cfg.hd)
    v = col_linear(enc_out, p["wv"], ax, fsdp_dim=0).reshape(B, T, kv_loc,
                                                             cfg.hd)
    return k, v


def init_cache(cfg: ModelConfig, B: int, ctx: int, ax: MeshAxes, dtype,
               device):
    """KV cache tree for one attention layer."""
    _, kv_loc = _local_heads(cfg, ax)
    window = _window(cfg)
    C = min(ctx, window) if window else ctx
    return dict(
        k=torch.zeros((B, C, kv_loc, cfg.hd), dtype=dtype, device=device),
        v=torch.zeros((B, C, kv_loc, cfg.hd), dtype=dtype, device=device),
        pos=torch.full((B, C), -1, dtype=torch.int32, device=device),
        idx=torch.zeros((), dtype=torch.int32, device=device),
    )
