"""pair — the pair layout of the policy state (the ``cuda32`` tier).

The counterpart of the reference's host conversions for the pair form
(``repro/core/lower32.py:574-605``: ``map_to_array32``,
``array32_to_map``, ``ctx_to_vec32``, ``vec32_to_bytes``,
``ret32_to_int``).  Every u64 word of the ctx, of each map and of the
return value is a ``[lo, hi]`` pair on a trailing axis of 2, which has
the bytes of a little-endian u64 array, so every conversion here is a
view of the u64 image and no arithmetic is split.  The reference splits
the arithmetic too (``lower32._Lowerer32``: carry chains, a 16-bit-limb
multiply, a 64-step long division) because Mosaic lowers no 64-bit
integers; Hopper's compiler lowers ``u64`` itself, so the pair-form
kernel (:meth:`repro_torch.core.cudac.PolicyKernel.launch32`) runs the
u64 decision over these operands viewed as words.

The lanes are ``torch.int32`` holding the bits of the reference's
``uint32``: torch's ``uint32`` has views and copies but no add or clamp
(the in-graph counters and the domain clamp need both), and the lo lane
read as ``int32`` is exactly the reference's ``.astype(jnp.int32)``.
Compare against the reference through ``numpy .view("<u4")``.
"""

from __future__ import annotations

import numpy as np
import torch

from .maps import BpfMap
from .torchc import map_to_array, pairs_to_words, words_to_pairs

__all__ = ["words_to_pairs", "pairs_to_words",
           "map_to_array32", "array32_to_map", "ctx_to_vec32",
           "vec32_to_bytes", "ret32_to_int"]


def map_to_array32(m: BpfMap, device=None) -> torch.Tensor:
    """Host map -> ``int32[rows, cols, 2]``, the pair view of its
    ``to_device`` image; control and metadata rows ride along."""
    return words_to_pairs(map_to_array(m, device))


def array32_to_map(arr: torch.Tensor, m: BpfMap) -> None:
    """Write pair-form map state back into the host map."""
    host = np.ascontiguousarray(arr.detach().cpu().numpy()).view("<u8")
    m.from_device(host.reshape(host.shape[0], host.shape[1]))


def ctx_to_vec32(ctx_buf, device=None) -> torch.Tensor:
    """ctx bytes -> ``int32[n_fields, 2]``."""
    t = torch.from_numpy(
        np.frombuffer(bytes(ctx_buf), dtype="<i4").reshape(-1, 2).copy())
    return t.to(device) if device is not None else t


def vec32_to_bytes(arr: torch.Tensor) -> bytes:
    return arr.detach().cpu().numpy().astype("<i4").tobytes()


def ret32_to_int(ret: torch.Tensor) -> int:
    r = ret.detach().cpu().numpy().view("<u4")
    return int(r[0]) | (int(r[1]) << 32)
