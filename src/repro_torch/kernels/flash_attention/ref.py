"""Plain-torch oracle for flash attention (causal / sliding-window GQA).

The port of ``repro/kernels/flash_attention/ref.py``, with its dense
softmax: a row that sees no key (``S > T`` under ``causal``) is a
softmax over ``NEG_INF`` only, which is uniform, so the oracle returns
the mean of ``v`` there where the kernel returns 0 (ROADMAP C5).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: float | None = None):
    """q: (B, H, S, d); k/v: (B, H, T, d).  Heads already kv-expanded.
    Returns (B, H, S, d) in q.dtype; math in f32."""
    B, H, S, d = q.shape
    T = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    pq = torch.arange(S, device=q.device)[:, None] + (T - S)
    pk = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = pk <= pq
    if window > 0:
        mask = mask & (pk > pq - window)
    logits = torch.where(mask[None, None], logits,
                         torch.tensor(NEG_INF, dtype=logits.dtype,
                                      device=logits.device))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, v.float()).to(q.dtype)
