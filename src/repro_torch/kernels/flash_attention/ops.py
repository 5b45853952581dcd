"""Public flash-attention op: GQA heads + backend selection.

The port of ``repro/kernels/flash_attention/ops.py``.  Backends:
``"cuda"`` (default) the hand-written kernels, which index the kv heads
themselves (query head ``h`` reads kv head ``h // (H / KV)``, the order
of the reference's ``jnp.repeat(k, rep, axis=1)``), so nothing is
expanded, raising :class:`~repro_torch.device.DeviceError` without a
CUDA device or on tensors elsewhere; ``"torch"`` the plain version and
``"ref"`` the oracle, both on the inputs' device after the reference's
expansion, each head repeated in place (``[k0, k0, k1, k1, ...]``:
``torch.repeat_interleave``).
"""

from __future__ import annotations

import torch

from .._build import on_card
from .kernel import flash_attention_cuda, flash_attention_plain
from .ref import flash_attention_ref

BACKENDS = ("cuda", "torch", "ref")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    backend: str = "cuda", bq: int = 128, bk: int = 128):
    """q: (B, H, S, d); k/v: (B, KV, T, d) with H % KV == 0."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "cuda":
        on_card("flash_attention", q, k, v)
    B, H, S, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"flash_attention: the {H} query heads are not a "
                         f"multiple of the {KV} kv heads")
    if backend == "cuda":
        out = flash_attention_cuda(
            q.reshape(B * H, S, d).contiguous(),
            k.reshape(B * KV, T, d).contiguous(),
            v.reshape(B * KV, T, d).contiguous(), group=H // KV,
            causal=causal, window=window, bq=bq, bk=bk)
        return out.reshape(B, H, S, d)
    if H != KV:
        k = torch.repeat_interleave(k, H // KV, dim=1)
        v = torch.repeat_interleave(v, H // KV, dim=1)
    if backend == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    out = flash_attention_plain(
        q.reshape(B * H, S, d).contiguous(),
        k.reshape(B * H, T, d).contiguous(),
        v.reshape(B * H, T, d).contiguous(), causal=causal, window=window,
        bq=bq, bk=bk)
    return out.reshape(B, H, S, d)
