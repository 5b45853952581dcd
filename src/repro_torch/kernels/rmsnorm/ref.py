"""Plain-torch oracle for fused RMSNorm (+ optional residual add).

The port of ``repro/kernels/rmsnorm/ref.py``.  It keeps the oracle's
order, which is not the kernel's: the residual is added in the input
dtype, then the norm is taken in f32.
"""

from __future__ import annotations

import torch


def fused_rmsnorm_ref(x, scale, residual=None, *, eps: float = 1e-6):
    """x: (..., D); scale: (D,).  Returns (y, new_residual_stream)."""
    if residual is not None:
        x = x + residual
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)
    return y, x
