"""Hand-written Hopper kernels for the framework's compute hot-spots.

The port of ``repro.kernels``.  Each kernel ships the reference's three
files and its CUDA source:
  kernel.py — the CUDA wrapper (``*_cuda``: checks, one launch, counted
              in ``KERNEL.launches``) and its plain PyTorch version
              (``*_plain``: the Pallas kernel's arithmetic step for step)
  ops.py    — the public op with the reference's shape handling;
              ``backend="cuda"`` (default), ``"torch"`` or ``"ref"``
  ref.py    — the oracle, a torch copy of the reference's
  csrc/*.cu — the kernel, CUDA C++ for sm_90a, built with nvcc at first
              use (``_build.py``)

B3 ``fused_rmsnorm``, B4 ``grouped_matmul``, B5 ``flash_attention``
(and ``flash_attention_train``, its differentiable op: B5's forward and
its hand-written backward).
"""

from .flash_attention.ops import flash_attention, flash_attention_train
from .grouped_matmul.ops import grouped_matmul
from .rmsnorm.ops import fused_rmsnorm

__all__ = ["flash_attention", "flash_attention_train", "grouped_matmul",
           "fused_rmsnorm"]
