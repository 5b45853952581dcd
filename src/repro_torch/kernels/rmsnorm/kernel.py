"""Fused residual-add + RMSNorm: the CUDA kernel and its plain version.

The port of ``repro/kernels/rmsnorm/kernel.py`` (B3,
``fused_rmsnorm_tpu``).  The Pallas kernel walks row tiles ``(bt, D)``
in VMEM; on Hopper ``csrc/rmsnorm.cu`` runs one block per row and keeps
the row's f32 sum in shared memory, so ``bt`` only shapes the contract
(``T % bt == 0``), as it does for the reference's callers.

* :func:`fused_rmsnorm_cuda` — checks, then one launch on the current
  stream (counted in ``KERNEL.launches``); raises ``DeviceError`` on
  tensors that are not on the current CUDA device.  x and the residual
  may each be float32, bfloat16 or float16: the kernel reads each in its
  own dtype (a code per operand) and writes both outputs in x's.
* :func:`fused_rmsnorm_plain` — the Pallas kernel's arithmetic step for
  step in torch: the residual added in f32, ``y`` cast to the output
  dtype before the multiply by ``scale`` cast to it, the residual stream
  the f32 sum cast once and returned even without a residual.
"""

from __future__ import annotations

import torch

from .._build import (CudaKernel, check_operand, kernel_dtype, on_card)

KERNEL = CudaKernel("fused_rmsnorm", "rmsnorm/csrc/rmsnorm.cu",
                    {"rmsnorm_launch": "pppppiifii"})


def _check_rows(T: int, bt: int) -> int:
    bt = min(bt, T)
    if bt <= 0 or T % bt:
        raise ValueError(f"fused_rmsnorm: T={T} is not a multiple of "
                         f"bt={bt}")
    return bt


def fused_rmsnorm_plain(x, scale, residual=None, *, eps: float = 1e-6,
                        bt: int = 128):
    """x: (T, D); scale: (D,); residual: optional (T, D)."""
    _check_rows(x.shape[0], bt)
    xf = x.float()
    if residual is not None:
        xf = xf + residual.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale.to(x.dtype), xf.to(x.dtype)


def fused_rmsnorm_cuda(x, scale, residual=None, *, eps: float = 1e-6,
                       bt: int = 128):
    """x: (T, D); scale: (D,); residual: optional (T, D).  Returns
    ``(normed * scale, residual stream)`` in ``x.dtype``."""
    T, D = x.shape
    _check_rows(T, bt)
    operands = [x, scale] + ([residual] if residual is not None else [])
    on_card("fused_rmsnorm", *operands)
    code = kernel_dtype("fused_rmsnorm", x.dtype)
    rcode = code
    check_operand("x", x, (T, D), x.dtype)
    if residual is not None:
        rcode = kernel_dtype("fused_rmsnorm residual", residual.dtype)
        check_operand("residual", residual, (T, D), residual.dtype)
    # the kernel reads scale in f32 and casts it to x.dtype, as the
    # Pallas kernel does; float32 holds every bf16 value exactly
    scale = scale.float()
    check_operand("scale", scale, (D,), torch.float32)
    y = torch.empty_like(x)
    res = torch.empty_like(x)
    if T:
        KERNEL.launch("rmsnorm_launch", x.data_ptr(),
                      residual.data_ptr() if residual is not None else None,
                      scale.data_ptr(), y.data_ptr(), res.data_ptr(), T, D,
                      eps, code, rcode)
    return y, res
