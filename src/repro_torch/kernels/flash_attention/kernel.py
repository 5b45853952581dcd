"""Flash attention (causal / sliding window): the CUDA kernels and their
plain version.

The port of ``repro/kernels/flash_attention/kernel.py`` (B5,
``flash_attention_tpu``).  The Pallas grid ``(BH, S/bq, T/bk)`` walks kv
tiles as sequential steps and carries the online-softmax state in VMEM;
on Hopper ``csrc/flash_attention.cu`` runs one block per 64 or 128
query rows and loops over the kv tiles the masks leave open, so
``bq``/``bk`` only shape the contract (``S % bq == T % bk == 0`` after
the ``min`` with the shape).  Head dims up to 256; v may have its own
width ``dv`` (latent attention's 192-wide q and k beside a 128-wide v).
k and v hold the kv heads unexpanded: query head ``qh`` of q ``(BH, S,
d)`` reads kv head ``qh // group`` of k ``(BH / group, T, d)`` and v
``(BH / group, T, dv)``, the reference's ``jnp.repeat`` order.

* :func:`flash_attention_cuda` — checks, then the launches on the current
  stream, each counted in ``KERNEL.launches``: bfloat16 on the tensor
  cores (one launch, or two for a split-KV call: the chunks, then their
  combine; :func:`attention_plan`), float32 on the CUDA cores (one);
  any other mix of float32, bfloat16 and float16 (float16, or q and k/v
  of two dtypes) on the float32 kernel after widening q, k and v to
  float32 on the card (exact), with one cast of its output to q's
  dtype: the Pallas kernel's arithmetic, which casts each operand to
  f32 as it loads it.  With ``with_lse`` (bfloat16) it also returns
  each row's log-sum-exp ``m + log(max(l, 1e-30))`` in f32, for the
  backward; the output's bits do not change.  Raises ``DeviceError`` on
  tensors that are not on the current CUDA device.
* :func:`flash_attention_plain` — ``_attn_kernel``'s arithmetic over
  ``bk``-wide kv tiles in order, every query row at once, on expanded
  k/v: the same query offset, masks, ``NEG_INF``, ``alpha`` guard and
  ``max(l, 1e-30)`` floor, so a query row that sees no key is 0 (ROADMAP
  C5); f32, or f64 for f64 operands.
* :func:`flash_attention_bwd_cuda` — the backward's two launches
  (bfloat16): dQ and D = rowsum(dO o) a row tile, then dK and dV a kv
  tile, each kv head's over its group; no atomics.
* :func:`flash_attention_bwd_plain` — its arithmetic over ``bk``-wide
  kv tiles: P = exp(s scale - lse), D, dS = P (dP - D), dQ, dK and dV
  in f32 (f64 for f64 operands; the kernel's hi and lo halves of P and
  dS keep about 16 bits of it), on kv heads ``group`` query heads
  share, their dK and dV summed.
"""

from __future__ import annotations

import math

import torch

from .._build import CudaKernel, check_operand, kernel_dtype, on_card

NEG_INF = -1e30
DEFAULT_BQ = 128
DEFAULT_BK = 128
MAX_HEAD_DIM = 256
# The tensor-core kernel's tiles (flash_attention.cu, Tiles): the widths
# the configs take, q/k and v each at the smallest of TC_HEAD_DIMS that
# holds the wider of the two, except latent attention's q/k of 161-192
# beside v of 65-128, which runs at LATENT_WIDTHS (with_widths); the
# group query heads of one kv head packed into a block's rows: 16 rows
# where S group <= 16 (decode: the 4 warps share them and split each kv
# tile's keys), 128 where the padded d is at most 160 and S group >= 128
# (two m-tiles a warp), else 64; kv tiles of 64 keys, 32 at a padded dv
# above 160 and at 160 with 128 rows.
TC_HEAD_DIMS = (64, 128, 160, 256)
LATENT_WIDTHS = (192, 128)
# Split-KV, a function of the shapes only: a bfloat16 call whose blocks
# fill less than one wave of SPLIT_BLOCKS (two on each of an H100's 132
# SMs) splits each block's kv tiles into as many chunks as keep the
# blocks within that wave, none shorter than SPLIT_MIN_TILES tiles on
# average.  A second, partial wave costs more than the chunks gain.
SPLIT_BLOCKS = 264
SPLIT_MIN_TILES = 8

KERNEL = CudaKernel("flash_attention",
                    "flash_attention/csrc/flash_attention.cu",
                    {"attn_launch": "ppppppppiiiiifiiiiii",
                     "attn_combine_launch": "pppppiiiii",
                     "attn_bwd_dq_launch": "ppppppppppiiiiifiiii",
                     "attn_bwd_dkv_launch": "ppppppppppiiiiifiiii"})


def tc_widths(d: int, dv: int = None) -> tuple:
    """(padded q/k width, padded v width) of the tensor-core kernels."""
    dv = d if dv is None else dv
    if 160 < d <= 192 and 64 < dv <= 128:
        return LATENT_WIDTHS
    w = next(p for p in TC_HEAD_DIMS if max(d, dv) <= p)
    return w, w


def tc_tiles(d: int, rows: int, dv: int = None) -> tuple:
    """(padded head dim, query rows a block, keys per kv tile) of the
    tensor-core kernel for head dims ``d`` (q, k) and ``dv`` (v; ``d``
    when not given) and ``rows`` = S group."""
    dp, dvp = tc_widths(d, dv)
    if rows <= 16:
        return dp, 16, 64
    if dp <= 160 and rows >= 128:
        return dp, 128, 32 if dvp == 160 else 64
    return dp, 64, 32 if dvp > 160 else 64


def kv_splits(BH: int, S: int, T: int, d: int, group: int,
              dv: int = None) -> int:
    """The chunks each block's kv tiles are split into (bfloat16)."""
    _, rows, keys = tc_tiles(d, S * group, dv)
    blocks = BH // group * math.ceil(S * group / rows)
    return max(1, min(SPLIT_BLOCKS // blocks,
                      math.ceil(T / keys) // SPLIT_MIN_TILES))


def attention_plan(BH: int, S: int, T: int, d: int, group: int,
                   dtype: torch.dtype, *kv_dtypes: torch.dtype,
                   dv: int = None) -> dict:
    """What :func:`flash_attention_cuda` launches for these shapes, q of
    ``dtype`` and k and v of ``kv_dtypes`` (``dtype`` when not given), v
    ``dv`` wide (``d`` when not given): the kernel, its tiles, the kv
    splits, the launches it counts and whether the operands are widened
    to float32 first (``upcast``)."""
    dtypes = {dtype, *kv_dtypes}
    for dt in dtypes:
        kernel_dtype("flash_attention", dt)
    if dtypes == {torch.bfloat16}:
        dp, rows, keys = tc_tiles(d, S * group, dv)
        n = kv_splits(BH, S, T, d, group, dv)
        return {"kernel": "tensor cores", "rows_per_block": rows,
                "keys_per_tile": keys, "head_dim_padded": dp, "splits": n,
                "launches": 2 if n > 1 else 1, "upcast": False}
    return {"kernel": "cuda cores", "rows_per_block": 64,
            "keys_per_tile": 64, "head_dim_padded": d, "splits": 1,
            "launches": 1,
            "upcast": dtypes != {torch.float32}}


def _check_blocks(S: int, T: int, bq: int, bk: int):
    bq, bk = min(bq, S), min(bk, T)
    for name, n, b in (("S", S, bq), ("T", T, bk)):
        if b <= 0 or n % b:
            raise ValueError(f"flash_attention: {name}={n} is not a "
                             f"multiple of b{'q' if name == 'S' else 'k'}"
                             f"={b}")
    return bq, bk


def _shapes(q, k, v, group: int = 1):
    BH, S, d = q.shape
    T, dv = k.shape[1], v.shape[-1]
    if not isinstance(group, int) or group < 1 or BH % group:
        raise ValueError(f"flash_attention: group={group!r} must be a "
                         f"positive int dividing the {BH} query heads")
    if tuple(k.shape) != (BH // group, T, d) \
            or tuple(v.shape) != (BH // group, T, dv):
        raise ValueError(f"flash_attention: k and v must be (BH / group, "
                         f"T, d) = ({BH // group}, T, {d}) and (BH / "
                         f"group, T, dv), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    return BH, S, T, d, dv


def _mask(S: int, T: int, k0: int, bk: int, causal: bool, window: int,
          dev):
    """(S, bk): the keys ``k0 ..`` each query row sees (queries aligned
    to the end)."""
    q_pos = torch.arange(S, device=dev)[:, None] + (T - S)
    k_pos = k0 + torch.arange(bk, device=dev)[None, :]
    mask = torch.ones((S, bk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    return mask


def _compute_dtype(q) -> torch.dtype:
    """f32, or f64 for f64 operands."""
    return torch.promote_types(q.dtype, torch.float32)


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale=None, bq: int = DEFAULT_BQ,
                          bk: int = DEFAULT_BK, with_lse: bool = False):
    """q: (BH, S, d); k: (BH, T, d), v: (BH, T, dv) — heads
    pre-flattened/kv-expanded.  Returns (BH, S, dv) in q's dtype, and
    with ``with_lse`` also each row's log-sum-exp (BH, S) in the compute
    dtype (f32; f64 for f64 operands)."""
    BH, S, T, d, dv = _shapes(q, k, v)
    scale = scale if scale is not None else d ** -0.5
    _, bk = _check_blocks(S, T, bq, bk)
    dev, ct = q.device, _compute_dtype(q)
    qf = q.to(ct)
    m = torch.full((BH, S, 1), NEG_INF, dtype=ct, device=dev)
    l = torch.zeros((BH, S, 1), dtype=ct, device=dev)
    acc = torch.zeros((BH, S, dv), dtype=ct, device=dev)
    for k0 in range(0, T, bk):
        kf = k[:, k0:k0 + bk].to(ct)
        vf = v[:, k0:k0 + bk].to(ct)
        s = torch.matmul(qf, kf.transpose(1, 2)) * scale
        mask = _mask(S, T, k0, bk, causal, window, dev)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        l = alpha * l + p.sum(dim=2, keepdim=True)
        acc = alpha * acc + torch.matmul(p, vf)
        m = m_new
    lf = torch.clamp(l, min=1e-30)
    out = (acc / lf).to(q.dtype)
    if with_lse:
        return out, (m + torch.log(lf))[..., 0]
    return out


def flash_attention_cuda(q, k, v, *, group: int = 1, causal: bool = True,
                         window: int = 0, scale=None, bq: int = DEFAULT_BQ,
                         bk: int = DEFAULT_BK, with_lse: bool = False):
    """q: (BH, S, d); k: (BH / group, T, d), v: (BH / group, T, dv), query
    head ``qh`` reading kv head ``qh // group``.  Returns (BH, S, dv) in
    ``q.dtype``, and with ``with_lse`` (bfloat16 operands) also each
    row's log-sum-exp (BH, S) in f32, written by the same launches."""
    BH, S, T, d, dv = _shapes(q, k, v, group)
    _check_blocks(S, T, bq, bk)
    on_card("flash_attention", q, k, v)
    plan = attention_plan(BH, S, T, d, group, q.dtype, k.dtype, v.dtype,
                          dv=dv)
    if max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the CUDA kernel takes head dims "
                         f"up to {MAX_HEAD_DIM}, got {d} and {dv}")
    if plan["kernel"] != "tensor cores" and (dv != d or with_lse):
        raise ValueError("flash_attention: v of its own width and the "
                         "log-sum-exp need bfloat16 q, k and v")
    check_operand("q", q, (BH, S, d), q.dtype)
    check_operand("k", k, (BH // group, T, d), k.dtype)
    check_operand("v", v, (BH // group, T, dv), v.dtype)
    scale = scale if scale is not None else d ** -0.5
    out_dtype = q.dtype
    if plan["upcast"]:
        q, k, v = q.float(), k.float(), v.float()
    code = kernel_dtype("flash_attention", q.dtype)
    out = q.new_empty((BH, S, dv))
    f32 = dict(dtype=torch.float32, device=q.device)
    lse = torch.empty(BH, S, **f32) if with_lse else None
    if not out.numel():
        return (out, lse) if with_lse else out.to(out_dtype)
    n = plan["splits"]
    # 16-byte copies need rows of whole 16-byte chunks, aligned
    vec = int(d % 8 == 0 and dv % 8 == 0
              and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    part = [None] * 3
    if n > 1:
        part = [torch.empty(n, BH * S, **f32), torch.empty(n, BH * S, **f32),
                torch.empty(n, BH * S, dv, **f32)]
    ptrs = [t.data_ptr() if t is not None else None for t in part]
    lse_ptr = lse.data_ptr() if with_lse else None
    KERNEL.launch("attn_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), *ptrs, lse_ptr if n == 1 else None, BH, S,
                  T, d, dv, scale, int(causal), int(window), group, n, vec,
                  code)
    if n > 1:
        KERNEL.launch("attn_combine_launch", *ptrs, out.data_ptr(), lse_ptr,
                      BH * S, S, dv, group, n)
    if with_lse:
        return out, lse
    return out.to(out_dtype)


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, group: int = 1,
                              causal: bool = True, window: int = 0,
                              scale=None, bk: int = DEFAULT_BK):
    """The backward's arithmetic on q: (BH, S, d), k: (BH / group, T, d),
    v: (BH / group, T, dv), the forward's o and its gradient do: (BH, S,
    dv) and lse: (BH, S).  Returns dq, dk, dv in the operands' dtypes."""
    BH, S, T, d, dv = _shapes(q, k, v, group)
    scale = scale if scale is not None else d ** -0.5
    bk = min(bk, T) if T else 1
    dev, ct = q.device, _compute_dtype(q)
    qf, dof = q.to(ct), do.to(ct)
    delta = (dof * o.to(ct)).sum(-1, keepdim=True)
    lse_c = lse.to(ct)[..., None]
    kx, vx = (t.repeat_interleave(group, dim=0) for t in (k, v))
    dq = torch.zeros((BH, S, d), dtype=ct, device=dev)
    dks, dvs = [], []
    for k0 in range(0, T, bk):
        kf = kx[:, k0:k0 + bk].to(ct)
        vf = vx[:, k0:k0 + bk].to(ct)
        mask = _mask(S, T, k0, kf.shape[1], causal, window, dev)
        s = torch.matmul(qf, kf.transpose(1, 2)) * scale
        p = torch.where(mask, torch.exp(s - lse_c), 0.0)
        dp = torch.matmul(dof, vf.transpose(1, 2))
        ds = p * (dp - delta)
        dq = dq + torch.matmul(ds, kf)
        dks.append(torch.matmul(ds.transpose(1, 2), qf) * scale)
        dvs.append(torch.matmul(p.transpose(1, 2), dof))
    dkx = torch.cat(dks, dim=1) if dks else kx.to(ct) * 0
    dvx = torch.cat(dvs, dim=1) if dvs else vx.to(ct) * 0
    dk = dkx.reshape(BH // group, group, T, d).sum(1)
    dvv = dvx.reshape(BH // group, group, T, dv).sum(1)
    return (dq * scale).to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


def flash_attention_bwd_cuda(q, k, v, o, do, lse, *, group: int = 1,
                             causal: bool = True, window: int = 0,
                             scale=None):
    """The backward kernels (bfloat16) on the operands of
    :func:`flash_attention_bwd_plain`: dq, dk, dv, each in two launches
    counted in ``KERNEL.launches``."""
    BH, S, T, d, dv = _shapes(q, k, v, group)
    on_card("flash_attention", q, k, v, o, do, lse)
    if max(d, dv) > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the CUDA kernel takes head dims "
                         f"up to {MAX_HEAD_DIM}, got {d} and {dv}")
    bf16 = torch.bfloat16
    check_operand("q", q, (BH, S, d), bf16)
    check_operand("k", k, (BH // group, T, d), bf16)
    check_operand("v", v, (BH // group, T, dv), bf16)
    check_operand("o", o, (BH, S, dv), bf16)
    check_operand("do", do, (BH, S, dv), bf16)
    check_operand("lse", lse, (BH, S), torch.float32)
    scale = scale if scale is not None else d ** -0.5
    gq, gk, gv = (torch.empty_like(t) for t in (q, k, v))
    if not (q.numel() and k.numel()):
        return gq.zero_(), gk.zero_(), gv.zero_()
    delta = torch.empty(BH, S, dtype=torch.float32, device=q.device)
    vec = int(d % 8 == 0 and dv % 8 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, o, do, gq, gk, gv)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), gq.data_ptr(),
            gk.data_ptr(), gv.data_ptr(), BH, S, T, d, dv, scale,
            int(causal), int(window), group, vec)
    KERNEL.launch("attn_bwd_dq_launch", *args)
    KERNEL.launch("attn_bwd_dkv_launch", *args)
    return gq, gk, gv
