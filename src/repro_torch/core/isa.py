"""eBPF-compatible instruction set for repro policy programs.

We model the real eBPF ISA closely (opcodes, 11 registers, 512-byte stack)
so that the verifier, interpreter, JIT and jaxc tiers all agree on one
well-specified semantics.  Opcode encodings follow the Linux kernel's
``bpf.h`` where practical; we do not need binary compatibility, but keeping
the same structure makes the verifier logic recognizably PREVAIL-shaped.

An instruction is ``Insn(op, dst, src, off, imm)``:
  * ``op``  — mnemonic string (e.g. ``"add64"``, ``"jeq"``, ``"ldxw"``)
  * ``dst`` — destination register index 0..10
  * ``src`` — source register index 0..10
  * ``off`` — 16-bit signed offset (memory ops, jumps)
  * ``imm`` — 64-bit signed immediate

Register convention (matches eBPF):
  r0        return value / scratch
  r1..r5    arguments / caller-saved scratch
  r6..r9    callee-saved
  r10       frame pointer (read-only), points one past the top of the
            512-byte stack; valid stack slots are [r10-512, r10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

NUM_REGS = 11
FP_REG = 10
STACK_SIZE = 512

U64 = (1 << 64) - 1
S64_MIN = -(1 << 63)
S64_MAX = (1 << 63) - 1


def u64(x: int) -> int:
    return x & U64


def s64(x: int) -> int:
    x &= U64
    return x - (1 << 64) if x >= (1 << 63) else x


def u32(x: int) -> int:
    return x & 0xFFFFFFFF


def s32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


# ---------------------------------------------------------------------------
# Opcode tables
# ---------------------------------------------------------------------------

# ALU ops exist in 64-bit ("<op>64") and 32-bit ("<op>32") widths, each with
# a register-source form and an immediate-source form ("<op>64i"/"<op>32i").
ALU_OPS = (
    "add", "sub", "mul", "div", "mod", "and", "or", "xor",
    "lsh", "rsh", "arsh", "mov", "neg",
)

# Conditional jumps: register form ("jeq") and immediate form ("jeqi").
JMP_COND = (
    "jeq", "jne", "jgt", "jge", "jlt", "jle",  # unsigned
    "jsgt", "jsge", "jslt", "jsle",            # signed
    "jset",                                    # dst & src != 0
)

# Memory sizes: b=1, h=2, w=4, dw=8 bytes.
MEM_SIZES = {"b": 1, "h": 2, "w": 4, "dw": 8}

LOAD_OPS = {f"ldx{sz}": n for sz, n in MEM_SIZES.items()}
STORE_REG_OPS = {f"stx{sz}": n for sz, n in MEM_SIZES.items()}
STORE_IMM_OPS = {f"st{sz}": n for sz, n in MEM_SIZES.items()}

# Pseudo instructions:
#   lddw    — load 64-bit immediate (one slot in our IR, two in real eBPF)
#   ldmap   — load map pointer by map name stored in imm-slot (string)
#   call    — call helper by id (imm)
#   call_fn — bpf-to-bpf call: imm indexes Program.subprogs; args in
#             r1..r5, result in r0, r6..r9 preserved (fresh frame),
#             r1..r5 clobbered to 0 on return
#   exit    — return r0
MISC_OPS = ("lddw", "ldmap", "call", "call_fn", "exit", "ja")


@dataclasses.dataclass(frozen=True)
class Insn:
    op: str
    dst: int = 0
    src: int = 0
    off: int = 0
    imm: int = 0
    # ldmap carries the map name symbolically (resolved at load time).
    map_name: Optional[str] = None

    def __repr__(self) -> str:  # compact, objdump-ish
        parts = [self.op]
        if self.op in ("exit",):
            return self.op
        parts.append(f"r{self.dst}")
        if self.op == "call":
            return f"call #{self.imm}"
        if self.op == "call_fn":
            return f"call_fn fn{self.imm}"
        if self.op == "ja":
            return f"ja +{self.off}"
        if self.op == "ldmap":
            return f"ldmap r{self.dst}, map:{self.map_name}"
        if self.op.endswith("i") or self.op in ("lddw",) or self.op.startswith("st"):
            parts.append(f"off={self.off}" if self.off else "")
            parts.append(f"imm={self.imm}")
        else:
            parts.append(f"r{self.src}")
            if self.off:
                parts.append(f"off={self.off}")
        return " ".join(p for p in parts if p)


def alu_width(op: str) -> Optional[int]:
    """Return 64 or 32 for an ALU op mnemonic, else None."""
    base = op[:-1] if op.endswith("i") else op
    for width, bits in (("64", 64), ("32", 32)):
        if base.endswith(width) and base[: -len(width)] in ALU_OPS:
            return bits
    return None


def alu_base(op: str) -> str:
    """``add64i`` -> ``add``."""
    base = op[:-1] if op.endswith("i") else op
    if base.endswith("64"):
        return base[:-2]
    if base.endswith("32"):
        return base[:-2]
    raise ValueError(f"not an ALU op: {op}")


def is_alu(op: str) -> bool:
    return alu_width(op) is not None


def is_jump_cond(op: str) -> bool:
    base = op[:-1] if op.endswith("i") else op
    return base in JMP_COND


def jump_base(op: str) -> str:
    return op[:-1] if op.endswith("i") else op


def is_imm_form(op: str) -> bool:
    return op.endswith("i") and (is_alu(op) or is_jump_cond(op))


def is_load(op: str) -> bool:
    return op in LOAD_OPS


def is_store(op: str) -> bool:
    return op in STORE_REG_OPS or op in STORE_IMM_OPS


def mem_size(op: str) -> int:
    for table in (LOAD_OPS, STORE_REG_OPS, STORE_IMM_OPS):
        if op in table:
            return table[op]
    raise ValueError(f"not a memory op: {op}")


def validate_insn(insn: Insn, index: int) -> None:
    """Structural validation (well-formedness, not safety)."""
    op = insn.op
    ok = (
        is_alu(op)
        or is_jump_cond(op)
        or is_load(op)
        or is_store(op)
        or op in MISC_OPS
    )
    if not ok:
        raise ValueError(f"insn {index}: unknown opcode {op!r}")
    if not (0 <= insn.dst < NUM_REGS and 0 <= insn.src < NUM_REGS):
        raise ValueError(f"insn {index}: register out of range in {insn!r}")
    if op == "ldmap" and not insn.map_name:
        raise ValueError(f"insn {index}: ldmap needs map_name")
