"""Reference interpreter for repro policy bytecode.

The interpreter is the semantic ground truth: the host JIT and the jaxc
in-graph compiler are both property-tested against it.  It performs dynamic
checks (bounds, null deref, div-by-zero) so that tests can also demonstrate
what *would* happen if an unverified program ran — e.g. the SIGSEGV analogue
in the paper's safety comparison.

Values:
  * scalars       — python ints, u64 wrap-around semantics
  * pointers      — ``Ptr(kind, mem, off)`` where mem is a bytearray
                    (ctx / stack / map value) or a BpfMap (map pointer)
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Callable, Dict, List, Optional

from . import faults as _faults
from . import helpers as H
from .context import PolicyContextValues
from .isa import (FP_REG, Insn, STACK_SIZE, alu_base, alu_width, is_alu,
                  is_imm_form, is_jump_cond, is_load, is_store, jump_base,
                  mem_size, s64, u32, u64)
from .maps import BpfMap

INSN_BUDGET = 1_000_000  # kernel-style dynamic budget (default fuel)


class VMError(Exception):
    """Runtime fault — the analogue of SIGSEGV / lockup in a native plugin."""


@dataclasses.dataclass
class Ptr:
    kind: str          # "ctx" | "stack" | "mapval" | "map"
    mem: object        # bytearray | BpfMap
    off: int = 0
    # mapval pointers remember their owning map so stores through them
    # bump the map's content version (device-bridge dirty tracking)
    owner: object = None

    def __add__(self, k: int) -> "Ptr":
        return Ptr(self.kind, self.mem, self.off + k, self.owner)


def _load(mem: bytearray, off: int, size: int, what: str) -> int:
    if off < 0 or off + size > len(mem):
        raise VMError(f"out-of-bounds read: {what}[{off}:{off+size}] of {len(mem)}B")
    return int.from_bytes(mem[off:off + size], "little", signed=False)


def _store(mem: bytearray, off: int, size: int, value: int, what: str) -> None:
    if off < 0 or off + size > len(mem):
        raise VMError(f"out-of-bounds write: {what}[{off}:{off+size}] of {len(mem)}B")
    mem[off:off + size] = (value & ((1 << (8 * size)) - 1)).to_bytes(size, "little")


def _alu(base: str, width: int, a: int, b: int) -> int:
    if width == 32:
        a, b = u32(a), u32(b)
    if base == "add":
        r = a + b
    elif base == "sub":
        r = a - b
    elif base == "mul":
        r = a * b
    elif base == "div":
        if b == 0:
            raise VMError("division by zero")
        r = a // b
    elif base == "mod":
        if b == 0:
            raise VMError("modulo by zero")
        r = a % b
    elif base == "and":
        r = a & b
    elif base == "or":
        r = a | b
    elif base == "xor":
        r = a ^ b
    elif base == "lsh":
        r = a << (b & (width - 1))
    elif base == "rsh":
        r = a >> (b & (width - 1))
    elif base == "arsh":
        sa = s64(a) if width == 64 else (u32(a) - (1 << 32) if u32(a) >= (1 << 31) else u32(a))
        r = sa >> (b & (width - 1))
    elif base == "mov":
        r = b
    elif base == "neg":
        r = -a
    else:
        raise VMError(f"bad ALU base {base}")
    return u64(r) if width == 64 else u32(r)


def _cmp(base: str, a, b) -> bool:
    # Pointer comparisons: only eq/ne against 0 (null) or same-region ptrs.
    if isinstance(a, Ptr) or isinstance(b, Ptr):
        av = 0 if (isinstance(a, int) and a == 0) else a
        bv = 0 if (isinstance(b, int) and b == 0) else b
        if base == "jeq":
            return (av == 0 and bv == 0) if not (isinstance(av, Ptr) and isinstance(bv, Ptr)) \
                else (av.mem is bv.mem and av.off == bv.off)
        if base == "jne":
            return not _cmp("jeq", a, b)
        raise VMError(f"illegal pointer comparison {base}")
    ua, ub = u64(a), u64(b)
    sa, sb = s64(a), s64(b)
    return {
        "jeq": ua == ub, "jne": ua != ub,
        "jgt": ua > ub, "jge": ua >= ub, "jlt": ua < ub, "jle": ua <= ub,
        "jsgt": sa > sb, "jsge": sa >= sb, "jslt": sa < sb, "jsle": sa <= sb,
        "jset": (ua & ub) != 0,
    }[base]


class VM:
    """Interprets one program against a ctx buffer and resolved maps."""

    CALL_DEPTH_LIMIT = 8   # frames, kernel MAX_CALL_FRAMES

    def __init__(self, insns: List[Insn], resolved_maps: Dict[str, BpfMap],
                 *, printk: Optional[Callable[[int], None]] = None,
                 fuel: Optional[int] = None, subprogs=()):
        """``fuel`` caps dynamic instruction count.  The runtime passes the
        verifier's proven step bound here so that even with bounded loops
        accepted statically, the interpreter keeps a runtime
        defense-in-depth: a bug in the bound proof (or a hand-run
        unverified program) trips the fuel check instead of spinning.
        ``subprogs`` are the program's ``call_fn`` callees (SubProgram
        sequence); each activation runs in a fresh frame."""
        self.insns = insns
        self.maps = resolved_maps
        self.printk = printk or (lambda v: None)
        self.fuel = INSN_BUDGET if fuel is None else max(1, int(fuel))
        self.subprogs = tuple(subprogs)

    def run(self, ctx_buf: bytearray) -> int:
        regs: List[object] = [0] * 11
        stack = bytearray(STACK_SIZE)
        regs[1] = Ptr("ctx", ctx_buf, 0)
        regs[FP_REG] = Ptr("stack", stack, STACK_SIZE)
        # fuel is shared across every frame of the call tree (one global
        # dynamic budget, kernel-style), so the counter travels by cell
        return self._exec(self.insns, regs, stack, [0], 1)

    def _exec(self, insns: List[Insn], regs: List[object],
              stack: bytearray, steps: List[int], depth: int) -> int:
        pc = 0
        fuel = self.fuel
        n = len(insns)
        while True:
            steps[0] += 1
            if steps[0] > fuel:
                raise VMError(
                    f"instruction budget exceeded ({fuel} steps): runaway "
                    "loop (verifier bound violated or unverified program)")
            if not (0 <= pc < n):
                raise VMError(f"pc {pc} out of program bounds")
            insn = insns[pc]
            op = insn.op
            if op == "exit":
                r0 = regs[0]
                if isinstance(r0, Ptr):
                    raise VMError("exit with pointer in r0")
                return u64(r0)
            if op == "ja":
                pc += 1 + insn.off
                continue
            if op == "lddw":
                regs[insn.dst] = u64(insn.imm)
                pc += 1
                continue
            if op == "ldmap":
                regs[insn.dst] = Ptr("map", self.maps[insn.map_name], 0)
                pc += 1
                continue
            if op == "call":
                self._call(insn.imm, regs, stack)
                pc += 1
                continue
            if op == "call_fn":
                if not (0 <= insn.imm < len(self.subprogs)):
                    raise VMError(f"call_fn fn{insn.imm} out of range")
                if depth >= self.CALL_DEPTH_LIMIT:
                    raise VMError(
                        f"call depth exceeds {self.CALL_DEPTH_LIMIT} frames")
                sp = self.subprogs[insn.imm]
                _faults.fire("call_fn", sp.name)
                # fresh frame: args r1..r5 copy in, r6..r9 zero-init,
                # own 512-byte stack; only r0 flows back
                cstack = bytearray(STACK_SIZE)
                cregs: List[object] = [0] * 11
                for r in (1, 2, 3, 4, 5):
                    cregs[r] = regs[r]
                cregs[FP_REG] = Ptr("stack", cstack, STACK_SIZE)
                regs[0] = self._exec(list(sp.insns), cregs, cstack,
                                     steps, depth + 1)
                for r in (1, 2, 3, 4, 5):
                    regs[r] = 0   # caller-saved, like helper calls
                pc += 1
                continue
            if is_alu(op):
                width = alu_width(op)
                base = alu_base(op)
                a = regs[insn.dst]
                b = insn.imm if is_imm_form(op) else regs[insn.src]
                if base == "neg":
                    b = 0
                # pointer arithmetic: ptr +/- scalar allowed
                if isinstance(a, Ptr) or isinstance(b, Ptr):
                    regs[insn.dst] = self._ptr_alu(base, width, a, b)
                else:
                    if insn.dst == FP_REG:
                        raise VMError("write to frame pointer r10")
                    regs[insn.dst] = _alu(base, width, int(a), int(b))
                pc += 1
                continue
            if is_jump_cond(op):
                a = regs[insn.dst]
                b = insn.imm if is_imm_form(op) else regs[insn.src]
                pc += 1 + (insn.off if _cmp(jump_base(op), a, b) else 0)
                continue
            if is_load(op):
                p = regs[insn.src]
                if not isinstance(p, Ptr):
                    raise VMError(f"load via non-pointer r{insn.src} (null/scalar deref)")
                if p.kind == "map":
                    raise VMError("load through raw map pointer")
                regs[insn.dst] = _load(p.mem if p.kind != "ctx" else p.mem,
                                       p.off + insn.off, mem_size(op), p.kind)
                pc += 1
                continue
            if is_store(op):
                p = regs[insn.dst]
                if not isinstance(p, Ptr):
                    raise VMError(f"store via non-pointer r{insn.dst} (null/scalar deref)")
                if p.kind == "map":
                    raise VMError("store through raw map pointer")
                val = insn.imm if op.startswith("st") and not op.startswith("stx") \
                    else regs[insn.src]
                if isinstance(val, Ptr):
                    if p.kind != "stack":
                        raise VMError("pointer spill outside stack")
                    # spill: store the Ptr object in a side table keyed by slot
                    raise VMError("pointer spill unsupported in interpreter tier")
                _store(p.mem, p.off + insn.off, mem_size(op), int(val), p.kind)
                if p.kind == "mapval" and p.owner is not None:
                    p.owner.touch()   # version-tracked for bridge caches
                pc += 1
                continue
            raise VMError(f"unhandled opcode {op}")

    def _ptr_alu(self, base: str, width: int, a, b):
        if width != 64:
            raise VMError("32-bit pointer arithmetic")
        if base == "mov":
            return b
        if base == "add":
            if isinstance(a, Ptr) and isinstance(b, int):
                return a + s64(b)
            if isinstance(b, Ptr) and isinstance(a, int):
                return b + s64(a)
        if base == "sub" and isinstance(a, Ptr) and isinstance(b, int):
            return a + (-s64(b))
        if base == "sub" and isinstance(a, Ptr) and isinstance(b, Ptr) \
                and a.mem is b.mem:
            return u64(a.off - b.off)
        raise VMError(f"illegal pointer arithmetic {base}")

    # -- helper dispatch ----------------------------------------------------
    def _call(self, hid: int, regs: List[object], stack: bytearray) -> None:
        h = H.HELPERS.get(hid)
        if h is None:
            raise VMError(f"unknown helper id {hid}")
        _faults.fire("helper", h.name)

        def stack_bytes(p: object, size: int) -> bytes:
            if not isinstance(p, Ptr) or p.kind != "stack":
                raise VMError(f"{h.name}: argument must be a stack pointer")
            if p.off < 0 or p.off + size > STACK_SIZE:
                raise VMError(f"{h.name}: stack buffer out of bounds")
            return bytes(p.mem[p.off:p.off + size])

        if h.name == "map_lookup_elem":
            mp, kp = regs[1], regs[2]
            if not (isinstance(mp, Ptr) and mp.kind == "map"):
                raise VMError("map_lookup_elem: r1 must be a map pointer")
            m: BpfMap = mp.mem
            key = stack_bytes(kp, m.key_size)
            # live view: the program dereferences the returned pointer
            # (kernel semantics); host-side readers get copies instead
            v = m.lookup_ref(key)
            regs[0] = 0 if v is None else Ptr("mapval", v, 0, m)
        elif h.name == "map_update_elem":
            mp, kp, vp = regs[1], regs[2], regs[3]
            if not (isinstance(mp, Ptr) and mp.kind == "map"):
                raise VMError("map_update_elem: r1 must be a map pointer")
            m = mp.mem
            key = stack_bytes(kp, m.key_size)
            if isinstance(vp, Ptr) and vp.kind == "mapval":
                value = bytes(vp.mem[vp.off:vp.off + m.value_size])
            else:
                value = stack_bytes(vp, m.value_size)
            if m.kind == "hash":
                _faults.fire("hash_rmw", m.name)
            regs[0] = u64(m.update(key, value))
        elif h.name == "map_delete_elem":
            mp, kp = regs[1], regs[2]
            m = mp.mem if isinstance(mp, Ptr) else None
            if m is None or mp.kind != "map":
                raise VMError("map_delete_elem: r1 must be a map pointer")
            regs[0] = u64(m.delete(stack_bytes(kp, m.key_size)))
        elif h.name == "ktime_get_ns":
            regs[0] = u64(H.ktime_get_ns())
        elif h.name == "get_prandom_u32":
            regs[0] = H.get_prandom_u32()
        elif h.name == "trace_printk":
            self.printk(int(regs[1]) if not isinstance(regs[1], Ptr) else -1)
            regs[0] = 0
        elif h.name == "ringbuf_reserve":
            mp = regs[1]
            if not (isinstance(mp, Ptr) and mp.kind == "map"):
                raise VMError("ringbuf_reserve: r1 must be a map pointer")
            m = mp.mem
            if not hasattr(m, "reserve_ref"):
                raise VMError(f"ringbuf_reserve on non-ringbuf map {m.name}")
            v = m.reserve_ref()
            regs[0] = 0 if v is None else Ptr("mapval", v, 0, m)
        elif h.name == "ringbuf_submit":
            mp = regs[1]
            if not (isinstance(mp, Ptr) and mp.kind == "map"):
                raise VMError("ringbuf_submit: r1 must be a map pointer")
            regs[0] = u64(mp.mem.submit())
        elif h.name == "ringbuf_discard":
            mp = regs[1]
            if not (isinstance(mp, Ptr) and mp.kind == "map"):
                raise VMError("ringbuf_discard: r1 must be a map pointer")
            regs[0] = u64(mp.mem.discard())
        elif h.name == "ema_update":
            mp, kp, sample, weight = regs[1], regs[2], regs[3], regs[4]
            if not (isinstance(mp, Ptr) and mp.kind == "map"):
                raise VMError("ema_update: r1 must be a map pointer")
            m = mp.mem
            key = stack_bytes(kp, m.key_size)
            _faults.fire("map_rmw", m.name)
            if m.kind == "hash":
                _faults.fire("hash_rmw", m.name)
            w = max(1, int(weight) if not isinstance(weight, Ptr) else 1)
            # the read-modify-write must hold the map lock or a racing
            # update_u64/update loses its write between our read and store
            with m.lock:
                v = m.lookup_ref(key)
                old = 0 if v is None else int.from_bytes(v[0:8], "little")
                new = (old * (w - 1) + int(sample)) // w
                if v is None:
                    buf = bytearray(m.value_size)
                    buf[0:8] = u64(new).to_bytes(8, "little")
                    m.update(key, bytes(buf))
                else:
                    v[0:8] = u64(new).to_bytes(8, "little")
                    m.touch()   # version-tracked for device-bridge caches
            regs[0] = u64(new)
        else:
            raise VMError(f"helper {h.name} not implemented")
        # caller-saved regs are clobbered (kernel semantics)
        for r in (1, 2, 3, 4, 5):
            regs[r] = 0
