"""Plain-torch oracle for the MoE grouped matmul.

The port of ``repro/kernels/grouped_matmul/ref.py``.
"""

from __future__ import annotations

import torch


def grouped_matmul_ref(x, w):
    """x: (E, C, D); w: (E, D, F) -> (E, C, F).  One matmul per expert."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
