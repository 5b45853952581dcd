"""Public flash-attention op: GQA head expansion + backend selection.

The port of ``repro/kernels/flash_attention/ops.py``.  The kv heads are
expanded as the reference's ``jnp.repeat(k, rep, axis=1)`` does, each
head repeated in place (``[k0, k0, k1, k1, ...]``):
``torch.repeat_interleave``.  Backends: ``"cuda"`` (default) the
hand-written kernel, raising :class:`~repro_torch.device.DeviceError`
without a CUDA device or on tensors elsewhere; ``"torch"`` the plain
version on the inputs' device; ``"ref"`` the oracle.
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
    if H != KV:
        rep = H // KV
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    if backend == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    qf = q.reshape(B * H, S, d)
    kf = k.reshape(B * H, T, d)
    vf = v.reshape(B * H, T, d)
    fn = flash_attention_plain if backend == "torch" else flash_attention_cuda
    out = fn(qf.contiguous(), kf.contiguous(), vf.contiguous(),
             causal=causal, window=window, bq=bq, bk=bk)
    return out.reshape(B, H, S, d)
