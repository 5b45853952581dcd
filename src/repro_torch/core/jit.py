"""Host JIT: verified bytecode -> specialized Python closure.

The analogue of bpftime's LLVM JIT on our CPU-only container.  Because the
program is *verified*, the generated code contains **no runtime safety
checks** — this is the paper's T1 tension resolved the same way: all cost is
paid at load time.

The generator consumes the verifier's per-insn region analysis
(:func:`repro_torch.core.verifier.verify_with_info`) and exploits every
load-time guarantee the paper's design pays for:

* *Structured control flow.*  The CFG is forward-only (verified), so
  basic blocks are reconstructed into nested ``if``/``else`` regions via
  the post-dominator tree (the walk of :mod:`repro_torch.core.emit`,
  shared with the native and CUDA generators) — no dispatcher loop, no
  per-jump block-id scan.  CFGs whose forward jumps cross (rare; random
  fuzz programs) fall back to a single-pass guard chain, still
  loop-free; loops the walk does not model, to a block dispatcher.
* *Ctx scalarization.*  The verifier proves every ctx access hits a
  fixed field offset, so input fields are read via pre-compiled
  :class:`struct.Struct` accessors (or one bulk unpack when many fields
  are touched), output fields live in locals, and modified fields are
  written back once per exit with a ``pack_into`` per contiguous run.
* *Stack promotion.*  When no stack pointer escapes to a helper and all
  stack slots are constant-offset and non-overlapping, the 512-byte
  frame is never allocated: each slot becomes a scalar local.
* *Allocation hoisting.*  When a real stack/region table is needed
  (programs that call map helpers), the buffers come from a per-closure
  free-list instead of being allocated per call (thread-safe: entries
  are popped for exclusive use and returned at exit; verified programs
  never read bytes they did not write this invocation, so buffers need
  no zeroing).
* *Inline map fast paths.*  ``map_lookup_elem`` and ``ema_update``
  against plain array maps compile to direct slot indexing — no handle
  dict, no method dispatch, no key-bytes copy.  Every other map helper
  call site is bound to a closure specialized on its (statically known)
  map, so the handle-indirection dict disappears entirely.
* *Dead-register elimination.*  Registers the specialized code never
  reads (ctx/frame pointer copies, map handles made redundant by call
  specialization) have their pure assignments deleted.

The closures keep the reference's ``__bpf_codegen__`` label ``"v2"``.

Code generation model
---------------------
Values are plain u64 ints.  Pointers are encoded ints: ``region_id << 32 |
offset`` where ``region_id`` indexes a per-invocation region table
``mems`` (region 1 = stack, region 2 = ctx, 3+ = map values returned by
lookups).  NULL is 0.  The verifier guarantees pointers are only
dereferenced in-bounds, so loads/stores index ``mems`` directly;
ctx/stack accesses bypass ``mems`` entirely via the static region info.
"""

from __future__ import annotations

import re
import struct
from typing import Callable, Dict, List, Optional, Set, Tuple

from . import faults as _faults
from . import helpers as H
from .cfg import CFG
from .emit import NEG, SIGNED_CMP, UNSIGNED_CMP, StructAbort, \
    StructuredEmitter
from .isa import (FP_REG, Insn, STACK_SIZE, alu_base, alu_width, is_alu,
                  is_imm_form, is_load, is_store, jump_base, mem_size, s64)
from .maps import BpfMap
from .program import Program

M64 = (1 << 64) - 1
M32 = 0xFFFFFFFF

_STRUCT_FMT = {1: "<B", 2: "<H", 4: "<I", 8: "<Q"}

# helper ids whose arguments are stack buffers — calling one makes the
# stack observable outside the generated code (disables stack promotion)
_STACK_ESCAPE_HIDS = frozenset(
    hid for hid, h in H.HELPERS.items()
    if any(a in (H.ARG_STACK_KEY, H.ARG_STACK_VALUE) for a in h.args))

# helper ids that append a map-value region to ``mems`` without taking a
# stack buffer (ringbuf_reserve): they force the buffered (mems) path in
# v2 even though no stack pointer escapes
_MEMS_ESCAPE_HIDS = frozenset(
    hid for hid, h in H.HELPERS.items()
    if h.ret == H.RET_MAP_VALUE_OR_NULL and hid not in _STACK_ESCAPE_HIDS)


def _sval(expr: str) -> str:
    return f"_s64({expr})"


# ---- call-site specialized helper closures --------------------------------
# The verifier records which map each helper call uses (call_map), so every
# call site binds a closure over the concrete map object: no handle decode,
# no registry dict, no per-call method lookup.

def _mk_lookup(m: BpfMap):
    ks = m.key_size
    fire = _faults.fire
    if m.kind == "hash":
        get = m._table.get  # dict identity is stable for a map's lifetime

        def f(mems, kp):
            fire("helper", "map_lookup_elem")
            o = kp & M32
            v = get(bytes(mems[kp >> 32][o:o + ks]))
            if v is None:
                return 0
            mems.append(v)
            return (len(mems) - 1) << 32
        return f
    lookup = m.lookup_ref   # live view: the program writes through it

    def f(mems, kp):
        fire("helper", "map_lookup_elem")
        o = kp & M32
        v = lookup(bytes(mems[kp >> 32][o:o + ks]))
        if v is None:
            return 0
        mems.append(v)
        return (len(mems) - 1) << 32
    return f


def _mk_update(m: BpfMap):
    ks, vs = m.key_size, m.value_size
    update = m.update
    fire = _faults.fire
    is_hash = m.kind == "hash"
    mname = m.name

    def f(mems, kp, vp):
        fire("helper", "map_update_elem")
        if is_hash:
            fire("hash_rmw", mname)     # table insert-or-update (VM parity)
        ko = kp & M32
        vo = vp & M32
        return update(bytes(mems[kp >> 32][ko:ko + ks]),
                      bytes(mems[vp >> 32][vo:vo + vs])) & M64
    return f


def _mk_delete(m: BpfMap):
    ks = m.key_size
    delete = m.delete
    fire = _faults.fire

    def f(mems, kp):
        fire("helper", "map_delete_elem")
        o = kp & M32
        return delete(bytes(mems[kp >> 32][o:o + ks])) & M64
    return f


def _mk_ema(m: BpfMap):
    ks, vs = m.key_size, m.value_size
    lookup = m.lookup_ref
    update = m.update
    touch = m.touch
    lock = m.lock
    fire = _faults.fire
    mname = m.name
    is_hash = m.kind == "hash"

    def f(mems, kp, sample, weight):
        fire("helper", "ema_update")
        fire("map_rmw", mname)
        if is_hash:
            fire("hash_rmw", mname)
        w = weight if weight > 1 else 1
        o = kp & M32
        key = bytes(mems[kp >> 32][o:o + ks])
        with lock:          # lock-held RMW (maps.py mutation contract)
            v = lookup(key)
            old = 0 if v is None else int.from_bytes(v[0:8], "little")
            new = ((old * (w - 1) + sample) // w) & M64
            if v is None:
                buf = bytearray(vs)
                buf[0:8] = new.to_bytes(8, "little")
                update(key, bytes(buf))
            else:
                v[0:8] = new.to_bytes(8, "little")
                touch()     # version-tracked for device-bridge caches
        return new
    return f


def _mk_ringbuf_reserve(m: BpfMap):
    reserve = m.reserve_ref
    fire = _faults.fire

    def f(mems):
        fire("helper", "ringbuf_reserve")
        v = reserve()
        if v is None:
            return 0
        mems.append(v)
        return (len(mems) - 1) << 32
    return f


def _mk_ringbuf_submit(m: BpfMap):
    submit = m.submit
    fire = _faults.fire

    def f():
        fire("helper", "ringbuf_submit")
        return submit() & M64
    return f


def _mk_ringbuf_discard(m: BpfMap):
    discard = m.discard
    fire = _faults.fire

    def f():
        fire("helper", "ringbuf_discard")
        return discard() & M64
    return f


_SPECIALIZERS = {
    "map_lookup_elem": (_mk_lookup, "(mems, r2)"),
    "map_update_elem": (_mk_update, "(mems, r2, r3)"),
    "map_delete_elem": (_mk_delete, "(mems, r2)"),
    "ema_update": (_mk_ema, "(mems, r2, r3, r4)"),
    "ringbuf_reserve": (_mk_ringbuf_reserve, "(mems)"),
    "ringbuf_submit": (_mk_ringbuf_submit, "()"),
    "ringbuf_discard": (_mk_ringbuf_discard, "()"),
}


class _GenV2(StructuredEmitter):
    """Specializing generator driven by the verifier's region analysis."""

    def __init__(self, prog: Program, vinfo, resolved_maps: Dict[str, BpfMap],
                 insns: Optional[List[Insn]] = None, is_sub: bool = False):
        self.prog = prog
        # the function being generated: main by default, or a subprogram's
        # body when compiling a call_fn callee
        self.insns = list(prog.insns) if insns is None else list(insns)
        self.lines: List[str] = []
        self.indent = 1
        self.vinfo = vinfo      # main's Verifier, or a callee's FnInfo —
        self.is_sub = is_sub    # both carry cfg/mem_info/call_map
        self.resolved = resolved_maps
        # the verifier already built the shared CFG; reuse it so both
        # tiers agree on block/loop structure by construction
        self.blocks = getattr(vinfo, "cfg", None) or CFG(self.insns)
        self.env_extra: Dict[str, object] = {}
        self.ctx_writes: Set[int] = set()
        self.ctx_reads: Set[int] = set()
        self.inline_maps: Dict[str, int] = {}  # map name -> env slot index
        self._analyze()

    # ---- analysis --------------------------------------------------------
    def _access_off(self, pc: int, insn: Insn) -> Optional[int]:
        info = self.vinfo.mem_info.get(pc)
        if info is None or info[2] is None:
            return None
        return info[2] + insn.off

    def _analyze(self) -> None:
        insns = self.insns
        self.stack_escape = False
        has_stack_access = False
        stack_ranges: Set[Tuple[int, int]] = set()
        stack_promotable = True
        for pc, insn in enumerate(insns):
            if insn.op == "call":
                if insn.imm in (_STACK_ESCAPE_HIDS | _MEMS_ESCAPE_HIDS) \
                        and pc in self.vinfo.call_map:
                    # mems-escaping helpers (ringbuf_reserve) have no stack
                    # args but append regions to mems; routing them through
                    # stack_escape keeps the "needs_mems implies
                    # needs_stack" pooling invariant below
                    self.stack_escape = True
                continue
            if not (is_load(insn.op) or is_store(insn.op)):
                continue
            info = self.vinfo.mem_info.get(pc)
            if info is None:
                continue  # verifier-proven unreachable
            kind = info[0]
            size = mem_size(insn.op)
            if kind == "ctx":
                k = self._access_off(pc, insn) // 8
                if is_store(insn.op):
                    self.ctx_writes.add(k)
                else:
                    self.ctx_reads.add(k)
            elif kind == "stack":
                has_stack_access = True
                off = self._access_off(pc, insn)
                if off is None:
                    # variable-offset slot (verifier-bounded): unpromotable
                    stack_promotable = False
                else:
                    stack_ranges.add((off, size))
        # disjoint-or-equal slot ranges are a precondition for promotion
        if stack_promotable:
            spans = sorted(stack_ranges)
            for (o1, s1), (o2, s2) in zip(spans, spans[1:]):
                if o2 < o1 + s1:
                    stack_promotable = False
                    break
        self.promote_stack = stack_promotable and not self.stack_escape
        self.needs_stack = (has_stack_access and not self.promote_stack) \
            or self.stack_escape
        # mems holds map-value regions appended by lookup helpers; only
        # stack-escaping (map) helpers can create them, and those also
        # force needs_stack, so needs_mems implies needs_stack
        self.needs_mems = self.stack_escape
        # fields kept in locals: every written field (written back at exit)
        self.ctx_locals = set(self.ctx_writes)
        # with few touched fields, per-field unpack_from beats a bulk unpack
        self.ctx_few = len(self.ctx_reads | self.ctx_writes) <= 2
        # contiguous runs of written fields -> one pack_into each
        self.wb_runs: List[List[int]] = []
        for k in sorted(self.ctx_writes):
            if self.wb_runs and self.wb_runs[-1][-1] == k - 1:
                self.wb_runs[-1].append(k)
            else:
                self.wb_runs.append([k])
        for i, run in enumerate(self.wb_runs):
            self.env_extra[f"_wb{i}"] = \
                struct.Struct(f"<{len(run)}Q").pack_into

    # ---- struct accessor bindings ---------------------------------------
    def _use_u(self, n: int) -> str:
        name = f"_u{n}"
        if name not in self.env_extra:
            self.env_extra[name] = struct.Struct(_STRUCT_FMT[n]).unpack_from
        return name

    def _use_p(self, n: int) -> str:
        name = f"_p{n}"
        if name not in self.env_extra:
            self.env_extra[name] = struct.Struct(_STRUCT_FMT[n]).pack_into
        return name

    # ---- expression helpers ---------------------------------------------
    def _cond(self, insn: Insn) -> Tuple[str, str]:
        """Render (condition, negated condition) for a conditional jump."""
        base = jump_base(insn.op)
        a = f"r{insn.dst}"
        if base in SIGNED_CMP:
            if is_imm_form(insn.op):
                b = str(s64(insn.imm & M64))
            else:
                b = _sval(f"r{insn.src}")
            a = _sval(a)
            op = SIGNED_CMP[base]
            return f"{a} {op} {b}", f"{a} {NEG[op]} {b}"
        if base in UNSIGNED_CMP:
            b = str(insn.imm & M64) if is_imm_form(insn.op) else f"r{insn.src}"
            op = UNSIGNED_CMP[base]
            return f"{a} {op} {b}", f"{a} {NEG[op]} {b}"
        b = str(insn.imm & M64) if is_imm_form(insn.op) else f"r{insn.src}"
        return f"({a} & {b}) != 0", f"({a} & {b}) == 0"

    def _map_token(self, name: str) -> str:
        idx = [d.name for d in self.prog.maps].index(name)
        return f"{(0x7F00 + idx) << 48}"  # sentinel map handle, never deref'd

    def _emit_alu(self, insn: Insn) -> None:
        base = alu_base(insn.op)
        width = alu_width(insn.op)
        mask = M64 if width == 64 else M32
        d = f"r{insn.dst}"
        s = str(insn.imm & mask) if is_imm_form(insn.op) else f"r{insn.src}"
        if width == 32 and not is_imm_form(insn.op):
            s = f"({s} & {M32})"
        a = d if width == 64 else f"({d} & {M32})"
        w = self.w
        if base == "mov":
            w(f"{d} = {s}" if width == 64 else f"{d} = {s} & {M32}")
        elif base == "neg":
            w(f"{d} = (-{a}) & {mask}")
        elif base in ("add", "sub", "mul"):
            sym = {"add": "+", "sub": "-", "mul": "*"}[base]
            w(f"{d} = ({a} {sym} {s}) & {mask}")
        elif base == "div":
            w(f"{d} = ({a} // {s}) & {mask}")
        elif base == "mod":
            w(f"{d} = ({a} % {s}) & {mask}")
        elif base in ("and", "or", "xor"):
            sym = {"and": "&", "or": "|", "xor": "^"}[base]
            w(f"{d} = ({a} {sym} {s}) & {mask}")
        elif base == "lsh":
            w(f"{d} = ({a} << ({s} & {width - 1})) & {mask}")
        elif base == "rsh":
            w(f"{d} = ({a} >> ({s} & {width - 1})) & {mask}")
        elif base == "arsh":
            sa = _sval(a) if width == 64 else f"_s32({a})"
            w(f"{d} = ({sa} >> ({s} & {width - 1})) & {mask}")
        else:
            raise AssertionError(base)

    # ---- per-insn emission ----------------------------------------------
    def emit_body_insn(self, pc: int, insn: Insn) -> None:
        op = insn.op
        w = self.w
        if op == "lddw":
            w(f"r{insn.dst} = {insn.imm & M64}")
            return
        if op == "ldmap":
            w(f"r{insn.dst} = {self._map_token(insn.map_name)}")
            return
        if op == "call":
            self._emit_call(pc, insn)
            return
        if op == "call_fn":
            # no r1-r5 zeroing needed: the verifier marks caller-saved
            # registers unknown after the call, so verified code never
            # reads them (same reasoning as helper calls above)
            sp = self.prog.subprogs[insn.imm]
            self.w(f'_fire("call_fn", {sp.name!r})')
            self.w(f"r0 = _sub{insn.imm}(r1, r2, r3, r4, r5)")
            return
        if is_alu(op):
            self._emit_alu(insn)
            return
        if is_load(op):
            self._emit_load(pc, insn)
            return
        if is_store(op):
            self._emit_store(pc, insn)
            return
        raise AssertionError(f"unhandled body op {op}")

    def _emit_load(self, pc: int, insn: Insn) -> None:
        info = self.vinfo.mem_info.get(pc)
        n = mem_size(insn.op)
        w = self.w
        if info is None:
            w(f"r{insn.dst} = _dead()")
            return
        kind = info[0]
        if kind == "ctx":
            off = self._access_off(pc, insn)
            k = off // 8
            if k in self.ctx_locals:
                expr = f"c{k}" if n == 8 else f"c{k} & {(1 << (8 * n)) - 1}"
            elif self.ctx_few:
                # reading n bytes at the field offset == masking, for free
                expr = f"{self._use_u(n)}(ctx, {off})[0]"
            else:
                expr = f"_c[{k}]" if n == 8 \
                    else f"_c[{k}] & {(1 << (8 * n)) - 1}"
            w(f"r{insn.dst} = {expr}")
            return
        if kind == "stack":
            off = self._access_off(pc, insn)
            if self.promote_stack:
                w(f"r{insn.dst} = s{off}_{n}")
                return
            u = self._use_u(n)
            if off is not None:
                w(f"r{insn.dst} = {u}(stack, {off})[0]")
            else:
                w(f"_o = (r{insn.src} + {insn.off}) & {M32}")
                w(f"r{insn.dst} = {u}(stack, _o)[0]")
            return
        # map value region: dynamic base, keep the encoded-pointer path
        u = self._use_u(n)
        if insn.off == 0:
            w(f"r{insn.dst} = {u}(mems[r{insn.src} >> 32], "
              f"r{insn.src} & {M32})[0]")
        else:
            w(f"_p = r{insn.src} + {insn.off}")
            w(f"r{insn.dst} = {u}(mems[_p >> 32], _p & {M32})[0]")

    def _emit_store(self, pc: int, insn: Insn) -> None:
        info = self.vinfo.mem_info.get(pc)
        n = mem_size(insn.op)
        mask = (1 << (8 * n)) - 1
        is_reg = insn.op.startswith("stx")
        val = f"r{insn.src}" if is_reg else str(insn.imm & mask)
        # registers hold u64 invariants, so 8-byte stores need no masking
        vmask = val if (n == 8 or not is_reg) else f"{val} & {mask}"
        w = self.w
        if info is None:
            w("_dead()")
            return
        kind = info[0]
        if kind == "ctx":
            k = self._access_off(pc, insn) // 8
            if n == 8:
                w(f"c{k} = {val}")
            else:
                w(f"c{k} = (c{k} & {~mask & M64}) | ({val} & {mask})")
            return
        if kind == "stack":
            off = self._access_off(pc, insn)
            if self.promote_stack:
                w(f"s{off}_{n} = {vmask}")
                return
            p = self._use_p(n)
            if off is not None:
                w(f"{p}(stack, {off}, {vmask})")
            else:
                w(f"_o = (r{insn.dst} + {insn.off}) & {M32}")
                w(f"{p}(stack, _o, {vmask})")
            return
        p = self._use_p(n)
        if insn.off == 0:
            w(f"{p}(mems[r{insn.dst} >> 32], r{insn.dst} & {M32}, {vmask})")
        else:
            w(f"_p = r{insn.dst} + {insn.off}")
            w(f"{p}(mems[_p >> 32], _p & {M32}, {vmask})")
        # the verifier proved which map this store writes through; bump
        # its content version so device-bridge caches re-upload
        w(f"{self._inline_touch(info[1])}()")

    def _inline_slot(self, map_name: str) -> str:
        idx = self.inline_maps.setdefault(map_name, len(self.inline_maps))
        self.env_extra[f"_slots{idx}"] = self.resolved[map_name]._slots
        return f"_slots{idx}"

    def _inline_lock(self, map_name: str) -> str:
        idx = self.inline_maps.setdefault(map_name, len(self.inline_maps))
        self.env_extra[f"_mlk{idx}"] = self.resolved[map_name].lock
        return f"_mlk{idx}"

    def _inline_touch(self, map_name: str) -> str:
        idx = self.inline_maps.setdefault(map_name, len(self.inline_maps))
        self.env_extra[f"_mtc{idx}"] = self.resolved[map_name].touch
        return f"_mtc{idx}"

    def _emit_call(self, pc: int, insn: Insn) -> None:
        h = H.HELPERS[insn.imm]
        w = self.w
        if pc not in self.vinfo.call_map:
            w("r0 = _dead()")
            return
        if h.name == "ktime_get_ns":
            w(f"r0 = _ktime() & {M64}")
            return
        if h.name == "get_prandom_u32":
            w("r0 = _prandom()")
            return
        if h.name == "trace_printk":
            w("_printk(r1)")
            w("r0 = 0")
            return
        mname = self.vinfo.call_map[pc]
        m = self.resolved.get(mname) if mname else None
        if m is None:  # pragma: no cover — runtime always resolves maps
            w(f"r0 = _h_{h.name}(mems, r1, r2, r3, r4, r5)")
            return
        if m.kind == "array":
            u4 = self._use_u(4)
            if h.name == "map_lookup_elem":
                slots = self._inline_slot(mname)
                w('_fire("helper", "map_lookup_elem")')
                w(f"_k = {u4}(stack, r2 & {M32})[0]")
                w(f"if _k < {m.max_entries}:")
                w(f"    mems.append({slots}[_k])")
                w("    r0 = (len(mems) - 1) << 32")
                w("else:")
                w("    r0 = 0")
                return
            # the inline ema reads/writes a full 8-byte slot in place;
            # undersized values take the closure path, which mirrors the
            # VM's slice-assign (slot-growing) semantics exactly.  The
            # RMW holds the per-map lock (maps.py mutation contract): a
            # racing host update_u64 must not be lost between the read
            # and the writeback.
            if h.name == "ema_update" and m.value_size >= 8:
                slots = self._inline_slot(mname)
                lk = self._inline_lock(mname)
                tc = self._inline_touch(mname)
                u8, p8 = self._use_u(8), self._use_p(8)
                w('_fire("helper", "ema_update")')
                w(f'_fire("map_rmw", "{mname}")')
                w(f"_k = {u4}(stack, r2 & {M32})[0]")
                w("_w = r4 if r4 > 1 else 1")
                w(f"if _k < {m.max_entries}:")
                w(f"    with {lk}:")
                w(f"        _v = {slots}[_k]")
                w(f"        _old = {u8}(_v, 0)[0]")
                w(f"        r0 = ((_old * (_w - 1) + r3) // _w) & {M64}")
                w(f"        {p8}(_v, 0, r0)")
                # version-tracked for device-bridge caches (maps.py)
                w(f"        {tc}()")
                w("else:")
                w(f"    r0 = (r3 // _w) & {M64}")
                return
        maker, argtuple = _SPECIALIZERS[h.name]
        name = f"_hc{pc}"
        self.env_extra[name] = maker(m)
        w(f"r0 = {name}{argtuple}")

    # ---- epilogue ---------------------------------------------------------
    def emit_exit(self) -> None:
        w = self.w
        if self.needs_mems:  # implies needs_stack (see _analyze)
            w("_pool.append((stack, mems))")
        elif self.needs_stack:
            w("_pool.append(stack)")
        for i, run in enumerate(self.wb_runs):
            args = ", ".join(f"c{k}" for k in run)
            w(f"_wb{i}(ctx, {run[0] * 8}, {args})")
        w("return r0")

    # dispatcher fallback (loopy CFGs) -------------------------------------
    def emit_dispatcher(self) -> None:
        """`while True` block dispatcher, driven by the specialized
        per-insn emitters — the fallback when a CFG *with back edges*
        resists structured reconstruction (a guard chain is a single
        forward pass and cannot re-enter earlier blocks)."""
        self.w("bb = 0")
        self.w("while True:")
        self.indent += 1
        for bi in range(self.blocks.n):
            self.w(f"if bb == {bi}:")
            self.indent += 1
            term = self._block_term(bi)
            kind = term[0]
            if kind == "exit":
                self.emit_exit()
            else:
                if kind in ("ja", "fall"):
                    self.w(f"bb = {term[1]}")
                else:
                    _, cond, _, t, f = term
                    self.w(f"bb = {t} if {cond} else {f}")
                self.w("continue")
            self.indent -= 1
        self.indent -= 1

    # guard-chain fallback -------------------------------------------------
    def emit_guard_chain(self) -> None:
        """Single forward pass over `if bb == i` guards — loop-free because
        every jump in a back-edge-free CFG goes forward."""
        for bi in range(self.blocks.n):
            if bi > 0:
                self.w(f"if bb == {bi}:")
                self.indent += 1
            term = self._block_term(bi)
            kind = term[0]
            if kind == "exit":
                self.emit_exit()
            elif kind == "ja":
                self.w(f"bb = {term[1]}")
            elif kind == "fall":
                self.w(f"bb = {term[1]}")
            else:
                _, cond, _, t, f = term
                self.w(f"bb = {t} if {cond} else {f}")
            if bi > 0:
                self.indent -= 1


# ---- post-pass: whole-function dead-register elimination -------------------

_ASSIGN_RE = re.compile(r"^\s*(r\d+|s\d+_\d+) = (.+)$")
_TOKEN_RE = re.compile(r"\b(?:r\d+|s\d+_\d+)\b")
_CALL_RE = re.compile(r"([A-Za-z_][A-Za-z0-9_.]*)\s*\(")
# the ONLY callables an assignment RHS may invoke and still be deletable;
# anything not on this whitelist (helper closures, pool ops, printk, any
# future binding) is conservatively treated as impure and kept
_PURE_CALLS = frozenset(
    ["int.from_bytes", "_s64", "_s32", "len"]
    + [f"_u{n}" for n in _STRUCT_FMT])


def _is_pure_rhs(rhs: str) -> bool:
    return all(name in _PURE_CALLS for name in _CALL_RE.findall(rhs))


def _dce(lines: List[str]) -> List[str]:
    """Delete pure assignments to registers/slots that are never read.

    Sound because a candidate RHS may only call whitelisted side-effect-
    free functions (fail-closed: unknown callables make the line
    undeletable) and the target is a function-local never observed
    elsewhere.  Runs to a fixpoint so chains (frame-pointer copies
    feeding dead address math, map-handle loads made redundant by
    call-site specialization) collapse.
    """
    lines = list(lines)
    while True:
        reads: Set[str] = set()
        for ln in lines:
            m = _ASSIGN_RE.match(ln)
            scan = m.group(2) if (m and _is_pure_rhs(m.group(2))) else ln
            reads.update(_TOKEN_RE.findall(scan))
        out = []
        dropped = False
        for ln in lines:
            m = _ASSIGN_RE.match(ln)
            if m and m.group(1) != "r0" and m.group(1) not in reads \
                    and _is_pure_rhs(m.group(2)):
                dropped = True
                continue
            out.append(ln)
        lines = out
        if not dropped:
            return lines


def _fix_empty_blocks(lines: List[str]) -> List[str]:
    """Re-insert ``pass`` where DCE emptied an if/else suite."""
    out: List[str] = []
    for i, ln in enumerate(lines):
        out.append(ln)
        if ln.rstrip().endswith(":"):
            ind = len(ln) - len(ln.lstrip())
            nxt = lines[i + 1] if i + 1 < len(lines) else None
            if nxt is None or (len(nxt) - len(nxt.lstrip())) <= ind:
                out.append(" " * (ind + 4) + "pass")
    return out


def _helper_env(prog: Program, resolved_maps: Dict[str, BpfMap],
                printk: Callable[[int], None]) -> Dict[str, object]:
    """Runtime support bindings of the generated closures."""
    map_by_handle = {(0x7F00 + i) << 48: resolved_maps[d.name]
                     for i, d in enumerate(prog.maps)
                     if d.name in resolved_maps}

    def _s64(x: int) -> int:
        return x - (1 << 64) if x >= (1 << 63) else x

    def _s32(x: int) -> int:
        return x - (1 << 32) if x >= (1 << 31) else x

    def _buf(mems, p: int, size: int) -> bytes:
        m = mems[p >> 32]
        o = p & M32
        return bytes(m[o:o + size])

    fire = _faults.fire

    def _h_map_lookup_elem(mems, r1, r2, r3, r4, r5) -> int:
        fire("helper", "map_lookup_elem")
        m = map_by_handle[r1]
        v = m.lookup_ref(_buf(mems, r2, m.key_size))
        if v is None:
            return 0
        mems.append(v)
        return (len(mems) - 1) << 32

    def _h_map_update_elem(mems, r1, r2, r3, r4, r5) -> int:
        fire("helper", "map_update_elem")
        m = map_by_handle[r1]
        if m.kind == "hash":
            fire("hash_rmw", m.name)
        key = _buf(mems, r2, m.key_size)
        val = _buf(mems, r3, m.value_size)
        return m.update(key, val) & M64

    def _h_map_delete_elem(mems, r1, r2, r3, r4, r5) -> int:
        fire("helper", "map_delete_elem")
        m = map_by_handle[r1]
        return m.delete(_buf(mems, r2, m.key_size)) & M64

    def _h_ktime_get_ns(mems, r1, r2, r3, r4, r5) -> int:
        fire("helper", "ktime_get_ns")
        return H.ktime_get_ns() & M64

    def _h_get_prandom_u32(mems, r1, r2, r3, r4, r5) -> int:
        fire("helper", "get_prandom_u32")
        return H.get_prandom_u32()

    def _h_trace_printk(mems, r1, r2, r3, r4, r5) -> int:
        fire("helper", "trace_printk")
        printk(r1)
        return 0

    def _h_ema_update(mems, r1, r2, r3, r4, r5) -> int:
        fire("helper", "ema_update")
        m = map_by_handle[r1]
        fire("map_rmw", m.name)
        if m.kind == "hash":
            fire("hash_rmw", m.name)
        key = _buf(mems, r2, m.key_size)
        w = max(1, r4)
        with m.lock:        # lock-held RMW (maps.py mutation contract)
            v = m.lookup_ref(key)
            old = 0 if v is None else int.from_bytes(v[0:8], "little")
            new = ((old * (w - 1) + r3) // w) & M64
            if v is None:
                buf = bytearray(m.value_size)
                buf[0:8] = new.to_bytes(8, "little")
                m.update(key, bytes(buf))
            else:
                v[0:8] = new.to_bytes(8, "little")
                m.touch()   # version-tracked for device-bridge caches
        return new

    def _h_ringbuf_reserve(mems, r1, r2, r3, r4, r5) -> int:
        fire("helper", "ringbuf_reserve")
        m = map_by_handle[r1]
        v = m.reserve_ref()
        if v is None:
            return 0
        mems.append(v)
        return (len(mems) - 1) << 32

    def _h_ringbuf_submit(mems, r1, r2, r3, r4, r5) -> int:
        fire("helper", "ringbuf_submit")
        return map_by_handle[r1].submit() & M64

    def _h_ringbuf_discard(mems, r1, r2, r3, r4, r5) -> int:
        fire("helper", "ringbuf_discard")
        return map_by_handle[r1].discard() & M64

    def _dead():
        raise AssertionError(
            "verifier-proven unreachable code executed")  # pragma: no cover

    def _ktime() -> int:
        fire("helper", "ktime_get_ns")
        return H.ktime_get_ns()

    def _prandom() -> int:
        fire("helper", "get_prandom_u32")
        return H.get_prandom_u32()

    return {
        "_s64": _s64, "_s32": _s32, "_dead": _dead,
        "_ktime": _ktime, "_prandom": _prandom,
        "_printk": printk, "_fire": fire,
        "_h_map_lookup_elem": _h_map_lookup_elem,
        "_h_map_update_elem": _h_map_update_elem,
        "_h_map_delete_elem": _h_map_delete_elem,
        "_h_ktime_get_ns": _h_ktime_get_ns,
        "_h_get_prandom_u32": _h_get_prandom_u32,
        "_h_trace_printk": _h_trace_printk,
        "_h_ema_update": _h_ema_update,
        "_h_ringbuf_reserve": _h_ringbuf_reserve,
        "_h_ringbuf_submit": _h_ringbuf_submit,
        "_h_ringbuf_discard": _h_ringbuf_discard,
    }


def _build_prologue(g: _GenV2, body: List[str]) -> List[str]:
    """Entry lines computed *after* DCE so only live state is initialized."""
    text = "\n".join(body)
    pro: List[str] = []
    ind = "    "
    regs = sorted({int(r) for r in re.findall(r"\br(\d+)\b", text)})
    # subprograms receive r1..r5 as parameters; everything else zero-inits
    skip = (1, 2, 3, 4, 5, FP_REG) if g.is_sub else (1, FP_REG)
    plain = [r for r in regs if r not in skip]
    if plain:
        pro.append(ind + " = ".join(f"r{r}" for r in plain) + " = 0")
    if not g.is_sub and 1 in regs:
        pro.append(ind + f"r1 = {2 << 32}")     # encoded ctx pointer
    if FP_REG in regs:
        pro.append(ind + f"r10 = {(1 << 32) | STACK_SIZE}")
    if not g.ctx_few and (g.ctx_locals or "_c[" in text):
        pro.append(ind + "_c = _ctxu(ctx)")
    for k in sorted(g.ctx_locals):
        if g.ctx_few:
            pro.append(ind + f"c{k} = {g._use_u(8)}(ctx, {k * 8})[0]")
        else:
            pro.append(ind + f"c{k} = _c[{k}]")
    slots = sorted({(int(o), int(n))
                    for o, n in re.findall(r"\bs(\d+)_(\d+)\b", text)})
    if slots:
        pro.append(ind + " = ".join(f"s{o}_{n}" for o, n in slots) + " = 0")
    if g.needs_mems:  # implies needs_stack (see _analyze)
        pro += [ind + "try:",
                ind + "    stack, mems = _pool.pop()",
                ind + "    del mems[3:]",
                ind + "except IndexError:",
                ind + f"    stack = bytearray({STACK_SIZE})",
                ind + "    mems = [None, stack, None]"]
    elif g.needs_stack:
        pro += [ind + "try:",
                ind + "    stack = _pool.pop()",
                ind + "except IndexError:",
                ind + f"    stack = bytearray({STACK_SIZE})"]
    return pro


def _compile_fn_v2(prog: Program, insns: List[Insn], fninfo,
                   resolved_maps: Dict[str, BpfMap],
                   printk: Callable[[int], None], fname: str, is_sub: bool
                   ) -> Tuple[Callable, Dict[str, object]]:
    """Compile one function (main or callee) to a specialized closure.

    Each function gets its own exec environment: specialized bindings
    (``_hc{pc}``, ``_pool``, struct accessors) never collide across
    functions, and pooled buffers stay homogeneous per closure.  Returns
    ``(fn, env)`` so the caller can inject ``_sub{i}`` bindings after
    every function exists (call_fn targets form a DAG in any index
    order).
    """
    g = _GenV2(prog, fninfo, resolved_maps, insns=insns, is_sub=is_sub)
    structured = True
    try:
        g.emit_structured()
    except StructAbort:
        g.lines.clear()
        g.indent = 1
        structured = False
        if g.blocks.has_loops:
            g.emit_dispatcher()
        else:
            g.w("bb = 0")
            g.emit_guard_chain()

    body = _fix_empty_blocks(_dce(g.lines))
    header = (f"def {fname}(r1, r2, r3, r4, r5):" if is_sub
              else f"def {fname}(ctx):")
    lines = [header] + _build_prologue(g, body) + body
    src = "\n".join(lines)

    env = _helper_env(prog, resolved_maps, printk)
    nfields = prog.ctx_type.size // 8
    env["_ctxu"] = struct.Struct(f"<{nfields}Q").unpack
    env["_pool"] = []
    env.update(g.env_extra)
    code = compile(src, f"<bpf-jit:{prog.name}:{fname}>", "exec")
    exec(code, env)  # noqa: S102 — generated from verified bytecode
    fn = env[fname]
    fn.__bpf_source__ = src  # for debugging / tests
    fn.__bpf_codegen__ = "v2"
    fn.__bpf_structured__ = structured
    fn.__bpf_mode__ = ("scalar" if not (g.needs_stack or g.needs_mems)
                       else "buffered")
    return fn, env


def _compile_v2(prog: Program, resolved_maps: Dict[str, BpfMap],
                printk: Callable[[int], None], vinfo
                ) -> Callable[[bytearray], int]:
    fns = list(getattr(vinfo, "fns", None) or [vinfo])
    envs: List[Dict[str, object]] = []
    subs: Dict[str, object] = {}
    for i, sp in enumerate(prog.subprogs):
        sub_fn, sub_env = _compile_fn_v2(
            prog, list(sp.insns), fns[1 + i], resolved_maps, printk,
            f"_sub{i}", is_sub=True)
        subs[f"_sub{i}"] = sub_fn
        envs.append(sub_env)
    fn, env = _compile_fn_v2(prog, list(prog.insns), fns[0], resolved_maps,
                             printk, "_run", is_sub=False)
    envs.append(env)
    for e in envs:
        e.update(subs)
    if subs:
        fn.__bpf_subs__ = subs  # for debugging / tests
    return fn


def compile_program(prog: Program, resolved_maps: Dict[str, BpfMap],
                    *, printk: Callable[[int], None] = lambda v: None,
                    info=None) -> Callable[[bytearray], int]:
    """Compile verified bytecode to a Python closure ``fn(ctx_buf) -> int``.

    ``info`` is the :class:`repro_torch.core.verifier.Verifier` produced by
    ``verify_with_info``; when omitted the program is (re-)verified here to
    recover the region analysis the generator specializes on.
    """
    if info is None:
        from .verifier import verify_with_info
        info = verify_with_info(prog)
    return _compile_v2(prog, resolved_maps, printk, info)
