"""Device choice for the PyTorch port — the counterpart of ``repro.compat``.

The port runs on an NVIDIA card unless the caller asks for the CPU: the
default execution tier is ``"cuda"``, and asking for it on a machine
without a CUDA device raises :class:`DeviceError` instead of quietly
running somewhere else.  There are no x64 shims here: torch has
``int64``, and every u64 the policy machine holds travels as its
two's-complement bit pattern in an ``int64`` tensor.

``have_cuda()`` and ``have_nvcc()`` are probes only; nothing in this
module touches the device at import time.
"""

from __future__ import annotations

import functools
import os
import shutil
from typing import Optional

import torch


class DeviceError(RuntimeError):
    """The requested device (or the toolchain that builds for it) is
    missing."""


def have_cuda() -> bool:
    """True iff torch sees at least one CUDA device."""
    return torch.cuda.is_available()


@functools.lru_cache(maxsize=1)
def nvcc_path() -> Optional[str]:
    """Absolute path of ``nvcc`` (``PATH`` first, then the toolkit's
    conventional ``/usr/local/cuda``), or None."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.access(cand, os.X_OK):
                return cand
    return None


def have_nvcc() -> bool:
    """True iff a CUDA compiler is available to build policy kernels."""
    return nvcc_path() is not None


def require_cuda(what: str) -> torch.device:
    """The CUDA device ``what`` runs on; raises :class:`DeviceError` when
    there is none (no silent CPU fallback)."""
    if not have_cuda():
        raise DeviceError(
            f"{what} needs a CUDA device and torch sees none "
            f"(torch {torch.__version__}, built for CUDA "
            f"{torch.version.cuda}); pass tier='torch' (plain PyTorch "
            "on the CPU) or tier='interp' (the reference interpreter) to "
            "run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device, what: str) -> torch.device:
    """``device`` in the one form a tensor made there reports, so that
    two spellings of one device compare equal.

    ``None``, ``"cuda"`` and ``"cuda:<current>"`` all name the card,
    ``cuda:N`` (:func:`require_cuda`: no card raises
    :class:`DeviceError`, as does a CUDA index other than the current
    device's); ``"cpu"`` and ``"cpu:0"`` are ``cpu``; any other device
    (``"meta"``) passes through as given."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        card = require_cuda(what)
        if dev.index is not None and dev.index != card.index:
            raise DeviceError(
                f"{what}: asked for {dev} but the current device is "
                f"{card}; select it with torch.cuda.set_device first")
        return card
    if dev.type == "cpu":
        return torch.device("cpu")
    return dev
