"""repro_torch.core — verified, composable policy execution on PyTorch/CUDA.

Layers (copies of the reference's JAX-free core unless noted):
  isa / asm / frontend   — bytecode, assembler, restricted-Python compiler
  verifier               — load-time static verification
  vm                     — interpreter (oracle)
  torchc                 — the plain PyTorch policy kernel (port)
  cudac                  — the hand-written CUDA policy kernel, u64 words
                           and the pair form (port)
  pair                   — the pair layout of the policy state (port)
  bridge                 — device-resident map state behind the runtime,
                           single-shard or one copy per shard
  shardmerge             — the deterministic merge of per-shard state
  maps                   — typed cross-plugin state
  runtime                — load/attach/hot-reload lifecycle, tier selection,
                           per-link circuit breakers (port: cuda/cuda32/
                           torch/interp)
  faults                 — deterministic fault injection at trust boundaries
"""

from .asm import AsmError, assemble
from .context import (Algo, AxisKind, CollType, PolicyContextValues,
                      ProfEvent, Proto, make_ctx)
from .faults import FaultInjector, InjectedFault
from .frontend import (CompileError, compile_policy, map_decl, policy,
                       subroutine)
from .isa import Insn
from .maps import ArrayMap, BpfMap, HashMap, MapRegistry, PerCpuArrayMap
from .program import MapDecl, Program
from .runtime import (BreakerConfig, LinkError, LoadedProgram, PolicyLink,
                      PolicyRuntime, global_runtime, reset_global_runtime)
from .verifier import VerifierError, verify
from .vm import VM, VMError

__all__ = [
    "AsmError", "assemble", "Algo", "AxisKind", "CollType",
    "PolicyContextValues", "ProfEvent", "Proto", "make_ctx",
    "FaultInjector", "InjectedFault",
    "CompileError", "compile_policy", "map_decl", "policy",
    "subroutine", "Insn",
    "ArrayMap", "BpfMap", "HashMap", "MapRegistry", "PerCpuArrayMap",
    "MapDecl", "Program", "BreakerConfig", "LinkError", "LoadedProgram",
    "PolicyLink", "PolicyRuntime",
    "global_runtime", "reset_global_runtime", "VerifierError", "verify",
    "VM", "VMError",
]
