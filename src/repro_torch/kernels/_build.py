"""Build, bind and launch the model kernels' CUDA sources.

Each kernel's ``csrc/*.cu`` is one self-contained translation unit with
a plain C interface: ``extern "C"`` launch functions that take device
pointers, sizes and PyTorch's current stream and return
``cudaGetLastError()``.  :class:`CudaKernel` builds it at first use
through :func:`repro_torch.core.cudac.compile_library` (``nvcc`` for
``sm_90a`` into a ctypes library under ``build/repro_torch_kernels/``,
cached by the hash of the source), launches its entry points, raises
:class:`~repro_torch.core.cudac.CudacError` on a nonzero status and
counts its launches in :attr:`CudaKernel.launches`.

:func:`on_card` is the wrappers' device check: every tensor on the
current CUDA device, or :class:`~repro_torch.device.DeviceError`.
Nothing here touches the device or the compiler at import time.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from ..core.cudac import CudacError, compile_library
from ..device import DeviceError, have_cuda

PKG = Path(__file__).resolve().parent
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
# the dtypes the kernels take, by the code their launch functions read
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


class CudaKernel:
    """One ``.cu`` source and its ``extern "C"`` launch functions.

    ``entries`` maps each launch function to its argument codes
    (``p`` pointer, ``i`` int, ``f`` float), the stream left out: it is
    always the last argument."""

    def __init__(self, name: str, source: str, entries: Dict[str, str]):
        self.name = name
        self.source = PKG / source
        self.entries = entries
        self.launches = 0
        self._fns = None

    def build(self) -> "CudaKernel":
        if self._fns is None:
            lib = compile_library(self.source.read_text(),
                                  f"the {self.name} kernel "
                                  f"({self.source.relative_to(PKG.parent)})")
            fns = {}
            for sym, codes in self.entries.items():
                fn = getattr(lib, sym)
                fn.argtypes = [_CTYPES[c] for c in codes] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
                fns[sym] = fn
            self._fns = fns
        return self

    def launch(self, entry: str, *args) -> None:
        """Call ``entry`` on the current stream; raises on a nonzero
        status (a launch the card refused never runs)."""
        self.build()
        err = self._fns[entry](*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise CudacError(f"{self.name} kernel: {entry} failed with "
                             f"CUDA error {err}")
        self.launches += 1


def on_card(what: str, *tensors: torch.Tensor) -> None:
    """Raise :class:`DeviceError` unless torch sees a CUDA device and every
    tensor lies on the current one (the kernel launches on that device's
    current stream).  Never copies to another device."""
    if not have_cuda():
        raise DeviceError(f"{what}: the CUDA kernel needs a CUDA device and "
                          f"torch sees none (torch {torch.__version__}); "
                          "pass backend='torch' for the plain version")
    for t in tensors:
        if t.device.type != "cuda":
            raise DeviceError(f"{what}: the CUDA kernel needs CUDA tensors, "
                              f"got one on {t.device}; pass backend='torch' "
                              "to run the plain version there")
        if t.device.index != torch.cuda.current_device():
            raise DeviceError(f"{what}: a tensor on {t.device} but the "
                              f"current device is cuda:"
                              f"{torch.cuda.current_device()}")


def check_operand(what: str, t: torch.Tensor, shape, dtype) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor
    of ``shape`` (what the kernel reads)."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")


def kernel_dtype(what: str, dtype: torch.dtype) -> int:
    """The launch functions' code for ``dtype``; ``ValueError`` for a
    dtype the kernels do not take (the reference's Pallas kernels cast
    float32, bfloat16 and float16 operands to f32 as they load them)."""
    if dtype not in DTYPE_CODE:
        raise ValueError(f"{what}: the CUDA kernel takes float32, bfloat16 "
                         f"or float16, got {dtype}")
    return DTYPE_CODE[dtype]
