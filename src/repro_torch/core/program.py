"""Program container — the "BPF ELF object" analogue.

A :class:`Program` bundles a section type (tuner/profiler/net), the
instruction list, and declared map dependencies.  Loading a program into the
runtime verifies it against its declared section's context type and resolves
map names against the shared registry.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .context import CTX_TYPES, CtxType
from .isa import Insn, validate_insn


@dataclasses.dataclass(frozen=True)
class MapDecl:
    name: str
    kind: str               # array | hash | percpu_array
    key_size: int = 4
    value_size: int = 8
    max_entries: int = 64
    # shared=True pins the map into the registry's cross-plugin namespace
    # at load time (MapRegistry.get_pinned) — the paper's composability
    # substrate: profiler and tuner programs share state by name
    shared: bool = False
    # per-value-slot shard-merge reduce for mesh-scale telemetry
    # (core.shardmerge): "sum" merges per-shard deltas by wrapping u64
    # addition (the counter idiom), "max" takes the cell from the shard
    # with the highest write cursor (the EMA / last-writer idiom).
    # Shorter tuples pad with "sum"; () means every slot is a counter.
    merge: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SubProgram:
    """A callee reachable via ``call_fn`` — the "static function in the
    same ELF" analogue.  Arguments arrive in r1..r5 (scalars only, the
    verifier enforces it), the result returns in r0, and each activation
    gets a fresh 512-byte stack frame."""
    name: str
    insns: Tuple[Insn, ...]
    n_args: int = 0


@dataclasses.dataclass
class Program:
    name: str
    section: str            # tuner | profiler | net
    insns: List[Insn]
    maps: Tuple[MapDecl, ...] = ()
    source: Optional[str] = None   # original restricted-Python/asm text
    subprogs: Tuple[SubProgram, ...] = ()

    def __post_init__(self):
        if self.section not in CTX_TYPES:
            raise ValueError(f"unknown section {self.section!r}")
        for i, insn in enumerate(self.insns):
            validate_insn(insn, i)
            self._check_call_fn(insn, i, "main")
        for sp in self.subprogs:
            for i, insn in enumerate(sp.insns):
                validate_insn(insn, i)
                self._check_call_fn(insn, i, sp.name)

    def _check_call_fn(self, insn: Insn, i: int, where: str) -> None:
        if insn.op == "call_fn" and not (0 <= insn.imm < len(self.subprogs)):
            raise ValueError(
                f"{where} insn {i}: call_fn fn{insn.imm} out of range "
                f"(program has {len(self.subprogs)} subprogram(s))")

    @property
    def ctx_type(self) -> CtxType:
        return CTX_TYPES[self.section]

    def map_decl(self, name: str) -> MapDecl:
        for d in self.maps:
            if d.name == name:
                return d
        raise KeyError(f"program {self.name}: map {name!r} not declared")

    def disasm(self) -> str:
        return "\n".join(f"{i:4d}: {insn!r}" for i, insn in enumerate(self.insns))

    def __len__(self) -> int:
        return len(self.insns)
