"""MoE grouped matmul: the CUDA kernel and its plain version.

The port of ``repro/kernels/grouped_matmul/kernel.py`` (B4,
``grouped_matmul_tpu``): per expert ``(C, D) @ (D, F)`` with f32
accumulation across the contraction, cast once at the end.  The Pallas
grid walks ``(E, C/bc, F/bf, D/bd)`` with D innermost; on Hopper
``csrc/grouped_matmul.cu`` tiles internally with D innermost (float32
on the CUDA cores, bfloat16 on the tensor cores through WMMA), so
``bc``/``bf``/``bd`` only shape the contract (``C % bc == F % bf ==
D % bd == 0`` after taking the ``min`` with the shape).

* :func:`grouped_matmul_cuda` — checks, then one launch on the current
  stream (counted in ``KERNEL.launches``); raises ``DeviceError`` on
  tensors that are not on the current CUDA device.
* :func:`grouped_matmul_plain` — the Pallas kernel's arithmetic: the f32
  sum over ``bd``-wide slices of D in order, cast once.
"""

from __future__ import annotations

import torch

from .._build import CudaKernel, check_operand, kernel_dtype, on_card

KERNEL = CudaKernel("grouped_matmul", "grouped_matmul/csrc/grouped_matmul.cu",
                    {"gmm_launch": "pppiiiii"})


def _check_tiles(C: int, D: int, F: int, bc: int, bf: int, bd: int):
    bc, bf, bd = min(bc, C), min(bf, F), min(bd, D)
    for name, n, b in (("C", C, bc), ("F", F, bf), ("D", D, bd)):
        if b <= 0 or n % b:
            raise ValueError(f"grouped_matmul: {name}={n} is not a multiple "
                             f"of b{name.lower()}={b}")
    return bc, bf, bd


def _shapes(x, w):
    E, C, D = x.shape
    if w.dim() != 3 or w.shape[0] != E or w.shape[1] != D:
        raise ValueError(f"grouped_matmul: w must be (E, D, F) = ({E}, {D}, "
                         f"F), got {tuple(w.shape)}")
    return E, C, D, w.shape[2]


def grouped_matmul_plain(x, w, *, bc: int = 128, bf: int = 128,
                         bd: int = 512):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F)."""
    E, C, D, F = _shapes(x, w)
    _, _, bd = _check_tiles(C, D, F, bc, bf, bd)
    acc = torch.zeros((E, C, F), dtype=torch.float32, device=x.device)
    for k0 in range(0, D, bd):
        acc += torch.matmul(x[:, :, k0:k0 + bd].float(),
                            w[:, k0:k0 + bd, :].float())
    return acc.to(x.dtype)


def grouped_matmul_cuda(x, w, *, bc: int = 128, bf: int = 128,
                        bd: int = 512):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F) in ``x.dtype``."""
    E, C, D, F = _shapes(x, w)
    _check_tiles(C, D, F, bc, bf, bd)
    on_card("grouped_matmul", x, w)
    code = kernel_dtype("grouped_matmul", x.dtype)
    check_operand("x", x, (E, C, D), x.dtype)
    check_operand("w", w, (E, D, F), x.dtype)
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel():
        KERNEL.launch("gmm_launch", x.data_ptr(), w.data_ptr(),
                      out.data_ptr(), E, C, D, F, code)
    return out
