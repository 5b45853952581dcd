"""Branch selection on the card inside a CUDA-graph capture.

The counterpart of ``lax.switch`` in the reference's jitted step
(``repro/collectives/ingraph.py``, ``all_reduce``): a captured step
holds every branch, and a device int picks the one each replay runs,
with no host read.  CUDA graphs do this with a conditional node.  The
torch the port runs on the card (2.11) binds no conditional node
(``CUDAGraph.begin_capture_to_if_node`` came later), so this module
adds one switch node through ``csrc/graph_switch.cu``, built with
``nvcc`` by :func:`repro_torch.core.cudac.compile_library` like the
policy kernels:

* on the capturing stream, ``bpf_switch_begin`` captures a ``<<<1,1>>>``
  kernel that sets the node's handle from ``*index`` and adds the
  switch node (``cudaGraphCondTypeSwitch``, CUDA 12.8) after it;
* each body is captured on a second stream into its body graph
  (``cudaStreamBeginCaptureToGraph``) while the branch's torch ops run
  with that stream current; the body copies its result into one output
  tensor allocated before the node, so what follows the node reads
  fixed addresses whichever body ran.

A body's own allocations come from a ``torch.cuda.MemPool`` that the
caller keeps alive as long as the graph: the graph's private pool
serves only the stream torch's capture began on.

A node CUDA refuses raises :class:`GraphSwitchError` with the CUDA
error; nothing falls back to a host read.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Sequence

import torch

from . import cudac

SOURCE = "src/repro_torch/core/csrc/graph_switch.cu"


class GraphSwitchError(RuntimeError):
    """A switch node could not be captured."""


_lock = threading.Lock()
_lib = None
# switch nodes captured (one per captured_switch call), a plain count as
# the kernels keep their launches
captures = 0


def capturing() -> bool:
    """True iff the current stream is capturing a CUDA graph (never
    without a card: a torch built without CUDA raises on the probe)."""
    return torch.cuda.is_available() \
        and torch.cuda.is_current_stream_capturing()


def build():
    """Build and bind ``csrc/graph_switch.cu`` (once per process); call
    it before a capture begins, as any kernel is built."""
    global _lib
    with _lock:
        if _lib is None:
            lib = cudac.compile_library(
                (cudac.CSRC / "graph_switch.cu").read_text(), SOURCE)
            lib.bpf_switch_begin.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint,
                ctypes.POINTER(ctypes.c_void_p)]
            for fn in (lib.bpf_body_begin, lib.bpf_body_end):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            for fn in (lib.bpf_switch_begin, lib.bpf_body_begin,
                       lib.bpf_body_end):
                fn.restype = ctypes.c_int
            lib.bpf_error_string.argtypes = [ctypes.c_int]
            lib.bpf_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(lib, err: int, what: str) -> None:
    if err == -1:
        raise GraphSwitchError(f"{what}: the current stream is not "
                               "capturing a CUDA graph")
    if err:
        name = lib.bpf_error_string(err).decode() if err > 0 \
            else "body capture ended into another graph"
        raise GraphSwitchError(f"{what}: CUDA error {err} ({name})")


def captured_switch(index: torch.Tensor,
                    branches: Sequence[Callable[[], torch.Tensor]],
                    out: torch.Tensor,
                    pool: "torch.cuda.MemPool") -> torch.Tensor:
    """Inside a capture on the current stream: one switch node whose
    body ``i`` runs ``branches[i]()`` and copies its result into
    ``out``; at each replay the body ``index`` (an int32 scalar on the
    card) names runs, and none when it is outside the range.  Returns
    ``out``.  ``pool`` serves the bodies' allocations and must outlive
    the graph."""
    global captures
    if index.dtype != torch.int32 or index.numel() != 1 \
            or not index.is_cuda:
        raise GraphSwitchError("the switch index must be one int32 on the "
                               f"card, got {index.dtype}{list(index.shape)} "
                               f"on {index.device}")
    lib = build()
    main = torch.cuda.current_stream()
    bodies = (ctypes.c_void_p * len(branches))()
    _check(lib, lib.bpf_switch_begin(main.cuda_stream, index.data_ptr(),
                                     len(branches), bodies), "switch node")
    side = torch.cuda.Stream(device=index.device)
    if side.cuda_stream == main.cuda_stream:
        # torch hands out its pool's streams in turn, so a draw can be
        # the capturing stream itself, which cannot begin a body capture
        side = torch.cuda.Stream(device=index.device)
    for i, branch in enumerate(branches):
        _check(lib, lib.bpf_body_begin(side.cuda_stream, bodies[i]),
               f"body {i}: begin capture")
        try:
            with torch.cuda.stream(side), \
                    torch.cuda.use_mem_pool(pool, index.device):
                out.copy_(branch())
        except BaseException:
            # close the body's capture; the branch's error is the one
            lib.bpf_body_end(side.cuda_stream, bodies[i])
            raise
        _check(lib, lib.bpf_body_end(side.cuda_stream, bodies[i]),
               f"body {i}: end capture")
    captures += 1
    return out


__all__ = ["GraphSwitchError", "SOURCE", "build", "captured_switch",
           "captures", "capturing"]
