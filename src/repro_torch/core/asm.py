"""Tiny eBPF assembler: text mnemonics + labels -> Insn list.

Used by the safety test suite (hand-crafted unsafe programs that must hit a
precise verifier bug class) and by anyone who wants to write policies below
the restricted-Python frontend.

Syntax (one insn per line, ``;`` comments, ``label:`` on its own line)::

    mov64   r2, 123            ; imm form auto-selected
    mov64   r2, r3             ; reg form
    ldxdw   r2, [r1+8]         ; load 8 bytes from r1+8
    stxdw   [r10-16], r2       ; store reg
    stdw    [r10-16], 7        ; store imm
    lddw    r2, 0x123456789    ; 64-bit imm
    ldmap   r1, my_map         ; load map pointer
    call    map_lookup_elem    ; or: call 1
    jeq     r0, 0, out         ; cond jump to label (imm or reg form)
    ja      out
  out:
    exit

Field names may be used as load/store offsets when the section is known:
``ldxdw r2, [r1+msg_size]``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from .context import CTX_TYPES
from .helpers import HELPER_IDS
from .isa import (Insn, LOAD_OPS, STORE_IMM_OPS, STORE_REG_OPS, is_alu,
                  is_jump_cond)
from .program import MapDecl, Program

_REG = re.compile(r"^r(\d+)$")
_MEM = re.compile(r"^\[r(\d+)([+-]\w+)?\]$")


class AsmError(Exception):
    pass


def _parse_int(tok: str) -> Optional[int]:
    try:
        return int(tok, 0)
    except ValueError:
        return None


def _split_operands(rest: str) -> List[str]:
    return [t.strip() for t in rest.split(",") if t.strip()]


def assemble(text: str, *, name: str = "prog", section: str = "tuner",
             maps: Tuple[MapDecl, ...] = ()) -> Program:
    ctx = CTX_TYPES[section]
    lines = []
    for raw in text.splitlines():
        line = raw.split(";", 1)[0].strip()
        if line:
            lines.append(line)

    # pass 1: label addresses
    labels: Dict[str, int] = {}
    pc = 0
    body: List[str] = []
    for line in lines:
        if line.endswith(":"):
            labels[line[:-1].strip()] = pc
        else:
            body.append(line)
            pc += 1

    def _field_off(tok: str) -> int:
        v = _parse_int(tok)
        if v is not None:
            return v
        if tok in ctx.fields:
            return ctx.fields[tok].offset
        raise AsmError(f"unknown offset token {tok!r}")

    def _mem(tok: str) -> Tuple[int, int]:
        m = _MEM.match(tok.replace(" ", ""))
        if not m:
            raise AsmError(f"bad memory operand {tok!r}")
        reg = int(m.group(1))
        off_tok = m.group(2) or "+0"
        sign = -1 if off_tok[0] == "-" else 1
        return reg, sign * _field_off(off_tok[1:])

    insns: List[Insn] = []
    for i, line in enumerate(body):
        parts = line.split(None, 1)
        op = parts[0]
        ops = _split_operands(parts[1]) if len(parts) > 1 else []

        if op == "exit":
            insns.append(Insn("exit"))
        elif op == "call":
            (h,) = ops
            hid = _parse_int(h)
            if hid is None:
                hid = HELPER_IDS.get(h)
                if hid is None:
                    raise AsmError(f"insn {i}: unknown helper {h!r}")
            insns.append(Insn("call", imm=hid))
        elif op == "ja":
            (lbl,) = ops
            tgt = labels.get(lbl)
            if tgt is None:
                raise AsmError(f"insn {i}: unknown label {lbl!r}")
            insns.append(Insn("ja", off=tgt - (i + 1)))
        elif op == "lddw":
            dst, imm = ops
            m = _REG.match(dst)
            insns.append(Insn("lddw", dst=int(m.group(1)), imm=_parse_int(imm)))
        elif op == "ldmap":
            dst, mname = ops
            m = _REG.match(dst)
            insns.append(Insn("ldmap", dst=int(m.group(1)), map_name=mname))
        elif op in LOAD_OPS:
            dst, mem = ops
            m = _REG.match(dst)
            base, off = _mem(mem)
            insns.append(Insn(op, dst=int(m.group(1)), src=base, off=off))
        elif op in STORE_REG_OPS:
            mem, src = ops
            base, off = _mem(mem)
            m = _REG.match(src)
            if m:
                insns.append(Insn(op, dst=base, src=int(m.group(1)), off=off))
            else:  # allow stx with imm -> rewrite to st
                insns.append(Insn("st" + op[3:], dst=base, off=off,
                                  imm=_parse_int(src)))
        elif op in STORE_IMM_OPS:
            mem, imm = ops
            base, off = _mem(mem)
            insns.append(Insn(op, dst=base, off=off, imm=_parse_int(imm)))
        elif is_jump_cond(op) or is_jump_cond(op + "i"):
            dst, other, lbl = ops
            m = _REG.match(dst)
            tgt = labels.get(lbl)
            if tgt is None:
                raise AsmError(f"insn {i}: unknown label {lbl!r}")
            off = tgt - (i + 1)
            ms = _REG.match(other)
            if ms:
                insns.append(Insn(op.rstrip("i"), dst=int(m.group(1)),
                                  src=int(ms.group(1)), off=off))
            else:
                base = op if op.endswith("i") else op + "i"
                insns.append(Insn(base, dst=int(m.group(1)), off=off,
                                  imm=_parse_int(other)))
        elif is_alu(op) or is_alu(op + "i"):
            if op.rstrip("i").startswith("neg"):
                (dst,) = ops
                m = _REG.match(dst)
                insns.append(Insn(op.rstrip("i"), dst=int(m.group(1))))
                continue
            dst, other = ops
            m = _REG.match(dst)
            ms = _REG.match(other)
            if ms:
                insns.append(Insn(op.rstrip("i"), dst=int(m.group(1)),
                                  src=int(ms.group(1))))
            else:
                base = op if op.endswith("i") else op + "i"
                val = other
                if not other.lstrip("+-").isdigit() and not other.startswith("0x"):
                    # symbolic ctx field offset as immediate
                    val = str(_field_off(other))
                insns.append(Insn(base, dst=int(m.group(1)), imm=_parse_int(val)))
        else:
            raise AsmError(f"insn {i}: cannot parse {line!r}")

    return Program(name=name, section=section, insns=insns, maps=maps,
                   source=text)
