"""MoE grouped matmul: the CUDA kernel and its plain version.

The port of ``repro/kernels/grouped_matmul/kernel.py`` (B4,
``grouped_matmul_tpu``): per expert ``(C, D) @ (D, F)`` with f32
accumulation across the contraction, cast once at the end.  The Pallas
grid walks ``(E, C/bc, F/bf, D/bd)`` with D innermost; on Hopper
``csrc/grouped_matmul.cu`` tiles internally with D innermost, so
``bc``/``bf``/``bd`` only shape the contract (``C % bc == F % bf ==
D % bd == 0`` after taking the ``min`` with the shape).

* :func:`gmm_plan` — the route a call takes, chosen by dtype, shape and
  alignment: bfloat16 that TMA can describe (``D % 8 == F % 8 == 0``,
  both base pointers 16-byte aligned) on ``wgmma`` fed by TMA, a
  persistent grid of one block per SM over 128 x 256 tiles; other
  bfloat16 on WMMA (128 x 128 tiles, a block each); float32 on the
  CUDA cores (64 x 64 tiles, no TF32).  Any other mix of float32,
  bfloat16 and float16 (float16 alone, or x and w of two dtypes) takes
  the float32 route: both operands widened to float32 on the card
  (exact), the float32 kernel, one cast of its output to x's dtype,
  which is the Pallas kernel's arithmetic (it casts each operand to f32
  as it loads it).  Always one launch.
* :func:`grouped_matmul_cuda` — checks, then one launch of the planned
  kernel on the current stream (counted in ``KERNEL.launches``); raises
  ``DeviceError`` on tensors that are not on the current CUDA device.
* :func:`grouped_matmul_plain` — the Pallas kernel's arithmetic: the f32
  sum over ``bd``-wide slices of D in order, cast once.
"""

from __future__ import annotations

import torch

from ...device import have_cuda
from .._build import CudaKernel, check_operand, kernel_dtype, on_card

KERNEL = CudaKernel("grouped_matmul", "grouped_matmul/csrc/grouped_matmul.cu",
                    {"gmm_launch": "pppiiiiii"})
# the launcher's route codes
GMM_ROUTES = {"cuda cores": 0, "wmma": 1, "wgmma": 2}
# output tile rows (of C) x columns (of F) x depth (of D) a step
GMM_TILES = {"cuda cores": (64, 64, 16), "wmma": (128, 128, 32),
             "wgmma": (128, 256, 64)}
WGMMA_STAGES = 4
H100_SMS = 132


def _sms() -> int:
    if have_cuda():
        return torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    return H100_SMS


def gmm_plan(E: int, C: int, D: int, F: int, dtype: torch.dtype,
             x_ptr: int = 0, w_ptr: int = 0, *, sms=None,
             w_dtype=None) -> dict:
    """What :func:`grouped_matmul_cuda` launches for x (E, C, D) of
    ``dtype`` at ``x_ptr`` and w (E, D, F) of ``w_dtype`` (``dtype``
    when None) at ``w_ptr``: the route, its tiles, the output tiles and
    the blocks, one launch; ``upcast`` where the operands are widened
    to float32 first.  ``sms``: the card's SM count (the current
    device's, or an H100's without one), which sizes the persistent
    grid of the ``wgmma`` route."""
    w_dtype = dtype if w_dtype is None else w_dtype
    kernel_dtype("grouped_matmul x", dtype)
    kernel_dtype("grouped_matmul w", w_dtype)
    upcast = False
    if dtype == w_dtype == torch.float32:
        route, why = "cuda cores", "float32 stays float32 (no TF32)"
    elif not dtype == w_dtype == torch.bfloat16:
        route, upcast = "cuda cores", True
        why = (f"x {dtype} with w {w_dtype}: both widened to float32 "
               "(exact), the float32 kernel, one cast to x's dtype")
    elif D % 8 or F % 8:
        route, why = "wmma", (f"TMA needs rows of 16 bytes: D={D} and "
                              f"F={F} must be multiples of 8")
    elif x_ptr % 16 or w_ptr % 16:
        route, why = "wmma", "TMA needs 16-byte-aligned base pointers"
    else:
        route, why = "wgmma", "TMA describes x and w"
    bm, bn, bk = GMM_TILES[route]
    tiles = E * -(-C // bm) * -(-F // bn)
    plan = {"route": route, "why": why, "tile": (bm, bn, bk),
            "tiles": tiles, "blocks": tiles, "launches": 1,
            "upcast": upcast}
    if route == "wgmma":
        sms = _sms() if sms is None else sms
        plan.update(blocks=min(tiles, sms), stages=WGMMA_STAGES,
                    waves=tiles / sms)
    return plan


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
    plan = gmm_plan(E, C, D, F, x.dtype, x.data_ptr(), w.data_ptr(),
                    w_dtype=w.dtype)
    check_operand("x", x, (E, C, D), x.dtype)
    check_operand("w", w, (E, D, F), w.dtype)
    xk, wk = (x.float(), w.float()) if plan["upcast"] else (x, w)
    out = torch.empty((E, C, F), dtype=xk.dtype, device=x.device)
    if out.numel():
        KERNEL.launch("gmm_launch", xk.data_ptr(), wk.data_ptr(),
                      out.data_ptr(), E, C, D, F, GMM_ROUTES[plan["route"]],
                      plan["blocks"])
    return out.to(x.dtype)
