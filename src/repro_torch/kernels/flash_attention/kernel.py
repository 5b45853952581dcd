"""Flash attention (causal / sliding window): the CUDA kernel and its
plain version.

The port of ``repro/kernels/flash_attention/kernel.py`` (B5,
``flash_attention_tpu``).  The Pallas grid ``(BH, S/bq, T/bk)`` walks kv
tiles as sequential steps and carries the online-softmax state in VMEM;
on Hopper ``csrc/flash_attention.cu`` runs one block per 64 query rows
of one head and loops over the kv tiles the masks leave open, so
``bq``/``bk`` only shape the contract (``S % bq == T % bk == 0`` after
the ``min`` with the shape).  Head dims up to 256.

* :func:`flash_attention_cuda` — checks, then one launch on the current
  stream (counted in ``KERNEL.launches``); raises ``DeviceError`` on
  tensors that are not on the current CUDA device.
* :func:`flash_attention_plain` — ``_attn_kernel``'s arithmetic over
  ``bk``-wide kv tiles in order, every query row at once: the same
  query offset, masks, ``NEG_INF``, ``alpha`` guard and ``max(l,
  1e-30)`` floor, so a query row that sees no key is 0 (ROADMAP C5).
"""

from __future__ import annotations

import torch

from .._build import CudaKernel, check_operand, kernel_dtype, on_card

NEG_INF = -1e30
DEFAULT_BQ = 128
DEFAULT_BK = 128
MAX_HEAD_DIM = 256

KERNEL = CudaKernel("flash_attention",
                    "flash_attention/csrc/flash_attention.cu",
                    {"attn_launch": "ppppiiiifiii"})


def _check_blocks(S: int, T: int, bq: int, bk: int):
    bq, bk = min(bq, S), min(bk, T)
    for name, n, b in (("S", S, bq), ("T", T, bk)):
        if b <= 0 or n % b:
            raise ValueError(f"flash_attention: {name}={n} is not a "
                             f"multiple of b{'q' if name == 'S' else 'k'}"
                             f"={b}")
    return bq, bk


def _shapes(q, k, v):
    BH, S, d = q.shape
    T = k.shape[1]
    if tuple(k.shape) != (BH, T, d) or tuple(v.shape) != (BH, T, d):
        raise ValueError(f"flash_attention: k and v must be (BH, T, d) = "
                         f"({BH}, T, {d}), got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
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


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         scale=None, bq: int = DEFAULT_BQ,
                         bk: int = DEFAULT_BK):
    """q: (BH, S, d); k/v: (BH, T, d) — heads pre-flattened/kv-expanded.
    Returns (BH, S, d) in ``q.dtype``."""
    BH, S, T, d = _shapes(q, k, v)
    _check_blocks(S, T, bq, bk)
    on_card("flash_attention", q, k, v)
    code = kernel_dtype("flash_attention", q.dtype)
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: the CUDA kernel takes head dims "
                         f"up to {MAX_HEAD_DIM}, got {d}")
    check_operand("q", q, (BH, S, d), q.dtype)
    check_operand("k", k, (BH, T, d), q.dtype)
    check_operand("v", v, (BH, T, d), q.dtype)
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    if out.numel():
        KERNEL.launch("attn_launch", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), BH, S, T, d, scale,
                      int(causal), int(window), code)
    return out
