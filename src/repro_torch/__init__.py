"""repro_torch — the NCCLbpf policy runtime on PyTorch and CUDA.

A port of the JAX package ``repro`` to an NVIDIA H100.  It imports
nothing from ``repro``: the JAX-free core (bytecode, verifier, maps, VM)
and the policy zoo are copies, held equal to the reference by the
``tests/test_torch_*`` differential tests.  The policy kernel that the
JAX package ran as one Pallas call is a hand-written CUDA kernel here
(:mod:`repro_torch.core.cudac`), with its plain PyTorch version beside
it (:mod:`repro_torch.core.torchc`).

Entry points run on the card by default (``PolicyRuntime(tier="cuda")``);
CPU callers ask for ``tier="torch"`` or ``tier="interp"``.
"""
