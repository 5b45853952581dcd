"""Fused residual-add + RMSNorm: the CUDA kernel and its plain version.

The port of ``repro/kernels/rmsnorm/kernel.py`` (B3,
``fused_rmsnorm_tpu``).  The Pallas kernel walks row tiles ``(bt, D)``
in VMEM; on Hopper ``csrc/rmsnorm.cu`` walks rows with a persistent
grid sized to the card, so ``bt`` only shapes the contract
(``T % bt == 0``), as it does for the reference's callers.

* :func:`rms_plan` — the route a call takes, chosen from D, the dtypes
  and the base pointers: ``"vector"`` (every operand's base 16-byte
  aligned, D a multiple of one 16-byte vector of x, the row held by at
  most 16 warps of 4 vectors a thread) holds a row in registers, 16
  bytes a load; ``"smem"`` (any other D or base)
  stages the f32 row through shared memory, one element a load.  It
  states the warps a row, the units a thread, the grid and the one
  launch.
* :func:`fused_rmsnorm_cuda` — checks, then one launch of the planned
  kernel on the current stream (counted in ``KERNEL.launches``); raises
  ``DeviceError`` on tensors that are not on the current CUDA device.
  x and the residual may each be float32, bfloat16 or float16: the
  kernel reads each in its own dtype (a code per operand) and writes
  the outputs in x's.  Without a residual the residual stream is
  ``T(f32(x))``, which is x bit for bit: the kernel writes only ``y``
  and the wrapper returns x itself (the same storage) as the stream.
* :func:`fused_rmsnorm_plain` — the Pallas kernel's arithmetic step for
  step in torch: the residual added in f32, ``y`` cast to the output
  dtype before the multiply by ``scale`` cast to it, the residual stream
  the f32 sum cast once and returned even without a residual.
"""

from __future__ import annotations

import torch

from .._build import (CudaKernel, check_operand, kernel_dtype, on_card)
from ..grouped_matmul.kernel import _sms

KERNEL = CudaKernel("fused_rmsnorm", "rmsnorm/csrc/rmsnorm.cu",
                    {"rmsnorm_launch": "pppppiifiiiiii"})
# the launcher's route codes
RMS_ROUTES = {"vector": 0, "smem": 1}
# a vector-route block holds whole rows up to ROW_THREADS threads, or
# one row of up to MAX_WARPS warps; the kernel's __launch_bounds__(512,
# min_blocks) keeps 1024 threads on an SM with at most 2 vectors a
# thread, else 512
ROW_THREADS = 256
MAX_WARPS = 16
# vectors a thread, most preferred first: 2 keep a thread within 64
# registers (two 512-thread blocks an SM), 4 need up to 128
VECTOR_NVS = (2, 4, 1)
SMEM_THREADS = 256
SMEM_BYTES = 232448             # an H100 block's shared memory at most


def _fit(units: int) -> tuple:
    """(warps a row, vectors a thread) holding ``units`` vectors with the
    fewest idle slots, then the vectors a thread ``VECTOR_NVS`` prefers,
    then the fewest warps; None when none fits."""
    fits = [(32 * w * nv - units, VECTOR_NVS.index(nv), w, nv)
            for w in range(1, MAX_WARPS + 1) for nv in VECTOR_NVS
            if 32 * w * nv >= units]
    return min(fits)[2:] if fits else None


def rms_plan(T: int, D: int, dtype: torch.dtype, residual_dtype=None,
             ptrs=(), *, sms=None) -> dict:
    """What :func:`fused_rmsnorm_cuda` launches for x (T, D) of
    ``dtype`` with a residual of ``residual_dtype`` (None: none) and the
    operands' base pointers ``ptrs``: the route
    and why, the elements a load (``unit``), the warps a row, the units
    a thread (``nv``), the rows and threads a block, the blocks the card
    keeps resident (``resident``, on ``sms`` SMs: the current device's,
    or an H100's without one) and the grid (``blocks``), one launch.

    The grid is persistent (``resident`` blocks walking the rows, each
    reading T(scale) once) where a block that read T(scale) for each row
    group would move at least as many bytes for it (4 D) as the row
    itself (x read and y written, 2-byte x without a residual); else one
    block a row group, whose last blocks the card balances as they
    finish."""
    kernel_dtype("fused_rmsnorm", dtype)
    if residual_dtype is not None:
        kernel_dtype("fused_rmsnorm residual", residual_dtype)
    unit, shape = 16 // dtype.itemsize, None
    if D % unit:
        why = f"D={D} is not a multiple of {unit} (16 bytes of x)"
    elif any(p % 16 for p in ptrs):
        why = "a base pointer is not 16-byte aligned"
    else:
        shape = _fit(D // unit)
        why = ("16-byte loads and stores" if shape else
               f"D={D} is wider than {MAX_WARPS} warps of registers hold")
    sms = _sms() if sms is None else sms
    if shape is None:
        if 4 * D > SMEM_BYTES:
            raise ValueError(f"fused_rmsnorm: D={D} f32 values exceed a "
                             "block's shared memory")
        route, unit, w, n, threads, per_block = (
            "smem", 1, SMEM_THREADS // 32, 1, SMEM_THREADS, 1)
        per_sm = max(1, min(2048 // SMEM_THREADS, SMEM_BYTES // (4 * D)))
    else:
        route, (w, n) = "vector", shape
        per_block = max(1, ROW_THREADS // (32 * w))
        threads = 32 * w * per_block
        per_sm = (1024 if n <= 2 else 512) // threads
    groups = -(-T // per_block)
    resident = max(1, min(groups, sms * per_sm))
    row_bytes = D * (2 * dtype.itemsize + (
        residual_dtype.itemsize + dtype.itemsize
        if residual_dtype is not None else 0))
    persistent = route == "smem" or 4 * D >= row_bytes
    return {"route": route, "why": why, "unit": unit, "warps": w, "nv": n,
            "rows_per_block": per_block, "threads": threads,
            "resident": resident, "persistent": persistent,
            "blocks": resident if persistent else groups, "launches": 1,
            "writes_res": residual_dtype is not None}


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
    ``(normed * scale, residual stream)`` in ``x.dtype``; without a
    residual the stream is ``x`` itself (the reference's
    ``T(f32(x))``), not a copy: a caller must not write to it in
    place."""
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
    res = torch.empty_like(x) if residual is not None else None
    if T:
        ptrs = [t.data_ptr() for t in (x, scale, y, residual, res)
                if t is not None]
        plan = rms_plan(T, D, x.dtype,
                        residual.dtype if residual is not None else None,
                        ptrs)
        KERNEL.launch("rmsnorm_launch", x.data_ptr(),
                      residual.data_ptr() if residual is not None else None,
                      scale.data_ptr(), y.data_ptr(),
                      res.data_ptr() if res is not None else None, T, D,
                      eps, RMS_ROUTES[plan["route"]], plan["warps"],
                      plan["nv"], plan["blocks"], code, rcode)
    return y, (res if res is not None else x)
