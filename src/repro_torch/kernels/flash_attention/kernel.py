"""Flash attention (causal / sliding window): the CUDA kernels and their
plain version.

The port of ``repro/kernels/flash_attention/kernel.py`` (B5,
``flash_attention_tpu``).  The Pallas grid ``(BH, S/bq, T/bk)`` walks kv
tiles as sequential steps and carries the online-softmax state in VMEM;
on Hopper ``csrc/flash_attention.cu`` runs one block per 64 or 128
query rows and loops over the kv tiles the masks leave open, so
``bq``/``bk`` only shape the contract (``S % bq == T % bk == 0`` after
the ``min`` with the shape).  Head dims up to 256.  k and v hold the kv
heads unexpanded: query head ``qh`` of q ``(BH, S, d)`` reads kv head
``qh // group`` of k/v ``(BH / group, T, d)``, the reference's
``jnp.repeat`` order.

* :func:`flash_attention_cuda` — checks, then the launches on the current
  stream, each counted in ``KERNEL.launches``: bfloat16 on the tensor
  cores (one launch, or two for a split-KV call: the chunks, then their
  combine; :func:`attention_plan`), float32 on the CUDA cores (one);
  raises ``DeviceError`` on tensors that are not on the current CUDA
  device.
* :func:`flash_attention_plain` — ``_attn_kernel``'s arithmetic over
  ``bk``-wide kv tiles in order, every query row at once, on expanded
  k/v: the same query offset, masks, ``NEG_INF``, ``alpha`` guard and
  ``max(l, 1e-30)`` floor, so a query row that sees no key is 0 (ROADMAP
  C5).
"""

from __future__ import annotations

import math

import torch

from .._build import CudaKernel, check_operand, kernel_dtype, on_card

NEG_INF = -1e30
DEFAULT_BQ = 128
DEFAULT_BK = 128
MAX_HEAD_DIM = 256
# The tensor-core kernel's tiles (flash_attention.cu, Tiles): d padded
# up to the next of TC_HEAD_DIMS; the group query heads of one kv head
# packed into a block's rows: 16 rows where S group <= 16 (decode: the 4
# warps share them and split each kv tile's keys), 128 where the padded
# d is at most 160 and S group >= 128 (two m-tiles a warp), else 64; kv
# tiles of 64 keys, 32 at a padded d of 256 and at 160 with 128 rows.
TC_HEAD_DIMS = (64, 128, 160, 256)
# Split-KV, a function of the shapes only: a bfloat16 call whose blocks
# fill less than one wave of SPLIT_BLOCKS (two on each of an H100's 132
# SMs) splits each block's kv tiles into as many chunks as keep the
# blocks within that wave, none shorter than SPLIT_MIN_TILES tiles on
# average.  A second, partial wave costs more than the chunks gain.
SPLIT_BLOCKS = 264
SPLIT_MIN_TILES = 8

KERNEL = CudaKernel("flash_attention",
                    "flash_attention/csrc/flash_attention.cu",
                    {"attn_launch": "pppppppiiiifiiiiii",
                     "attn_combine_launch": "ppppiiiii"})


def tc_tiles(d: int, rows: int) -> tuple:
    """(padded head dim, query rows a block, keys per kv tile) of the
    tensor-core kernel for head dim ``d`` and ``rows`` = S group."""
    dp = next(p for p in TC_HEAD_DIMS if d <= p)
    if rows <= 16:
        return dp, 16, 64
    if dp <= 160 and rows >= 128:
        return dp, 128, 32 if dp == 160 else 64
    return dp, 64, 32 if dp > 160 else 64


def kv_splits(BH: int, S: int, T: int, d: int, group: int) -> int:
    """The chunks each block's kv tiles are split into (bfloat16)."""
    _, rows, keys = tc_tiles(d, S * group)
    blocks = BH // group * math.ceil(S * group / rows)
    return max(1, min(SPLIT_BLOCKS // blocks,
                      math.ceil(T / keys) // SPLIT_MIN_TILES))


def attention_plan(BH: int, S: int, T: int, d: int, group: int,
                   dtype: torch.dtype) -> dict:
    """What :func:`flash_attention_cuda` launches for these shapes: the
    kernel, its tiles, the kv splits and the launches it counts."""
    if dtype == torch.bfloat16:
        dp, rows, keys = tc_tiles(d, S * group)
        n = kv_splits(BH, S, T, d, group)
        return {"kernel": "tensor cores", "rows_per_block": rows,
                "keys_per_tile": keys, "head_dim_padded": dp, "splits": n,
                "launches": 2 if n > 1 else 1}
    return {"kernel": "cuda cores", "rows_per_block": 64,
            "keys_per_tile": 64, "head_dim_padded": d, "splits": 1,
            "launches": 1}


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
    T = k.shape[1]
    if not isinstance(group, int) or group < 1 or BH % group:
        raise ValueError(f"flash_attention: group={group!r} must be a "
                         f"positive int dividing the {BH} query heads")
    if tuple(k.shape) != (BH // group, T, d) \
            or tuple(v.shape) != (BH // group, T, d):
        raise ValueError(f"flash_attention: k and v must be (BH / group, "
                         f"T, d) = ({BH // group}, T, {d}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    return BH, S, T, d


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale=None, bq: int = DEFAULT_BQ,
                          bk: int = DEFAULT_BK):
    """q: (BH, S, d); k/v: (BH, T, d) — heads pre-flattened/kv-expanded."""
    BH, S, T, d = _shapes(q, k, v)
    scale = scale if scale is not None else d ** -0.5
    _, bk = _check_blocks(S, T, bq, bk)
    dev = q.device
    qf = q.float()
    q_pos = torch.arange(S, device=dev)[:, None] + (T - S)
    m = torch.full((BH, S, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((BH, S, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((BH, S, d), dtype=torch.float32, device=dev)
    for k0 in range(0, T, bk):
        kf = k[:, k0:k0 + bk].float()
        vf = v[:, k0:k0 + bk].float()
        s = torch.matmul(qf, kf.transpose(1, 2)) * scale
        k_pos = k0 + torch.arange(bk, device=dev)[None, :]
        mask = torch.ones((S, bk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window > 0:
            mask = mask & (k_pos > q_pos - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        l = alpha * l + p.sum(dim=2, keepdim=True)
        acc = alpha * acc + torch.matmul(p, vf)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention_cuda(q, k, v, *, group: int = 1, causal: bool = True,
                         window: int = 0, scale=None, bq: int = DEFAULT_BQ,
                         bk: int = DEFAULT_BK):
    """q: (BH, S, d); k/v: (BH / group, T, d), query head ``qh`` reading
    kv head ``qh // group``.  Returns (BH, S, d) in ``q.dtype``."""
    BH, S, T, d = _shapes(q, k, v, group)
    _check_blocks(S, T, bq, bk)
    on_card("flash_attention", q, k, v)
    code = kernel_dtype("flash_attention", q.dtype)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the CUDA kernel takes head dims "
                         f"up to {MAX_HEAD_DIM}, got {d}")
    check_operand("q", q, (BH, S, d), q.dtype)
    check_operand("k", k, (BH // group, T, d), q.dtype)
    check_operand("v", v, (BH // group, T, d), q.dtype)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if not out.numel():
        return out
    n = attention_plan(BH, S, T, d, group, q.dtype)["splits"]
    # 16-byte copies need rows of whole 16-byte chunks, aligned
    vec = int(d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    part = [None] * 3
    if n > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        part = [torch.empty(n, BH * S, **f32), torch.empty(n, BH * S, **f32),
                torch.empty(n, BH * S, d, **f32)]
    ptrs = [t.data_ptr() if t is not None else None for t in part]
    KERNEL.launch("attn_launch", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  out.data_ptr(), *ptrs, BH, S, T, d, scale, int(causal),
                  int(window), group, n, vec, code)
    if n > 1:
        KERNEL.launch("attn_combine_launch", *ptrs, out.data_ptr(), BH * S,
                      S, d, group, n)
    return out
