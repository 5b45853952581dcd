"""Public grouped-matmul op.

The port of ``repro/kernels/grouped_matmul/ops.py``.  Backends:
``"cuda"`` (default) the hand-written kernel, raising
:class:`~repro_torch.device.DeviceError` without a CUDA device or on
tensors elsewhere; ``"torch"`` the plain version on the inputs' device;
``"ref"`` the oracle.
"""

from __future__ import annotations

from .._build import on_card
from .kernel import grouped_matmul_cuda, grouped_matmul_plain
from .ref import grouped_matmul_ref

BACKENDS = ("cuda", "torch", "ref")


def grouped_matmul(x, w, *, backend: str = "cuda", bc: int = 128,
                   bf: int = 128, bd: int = 512):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "ref":
        return grouped_matmul_ref(x, w)
    if backend == "torch":
        return grouped_matmul_plain(x, w, bc=bc, bf=bf, bd=bd)
    on_card("grouped_matmul", x, w)
    return grouped_matmul_cuda(x.contiguous(), w.contiguous(), bc=bc,
                               bf=bf, bd=bd)
