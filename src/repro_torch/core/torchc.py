"""torchc — the plain PyTorch version of the policy kernel.

The counterpart of ``repro.core.jaxc`` (the body that
``pallasc.compile_pallas(mode="jit")`` runs, and that the Pallas kernel
``pallasc._build_pallas_fn`` wraps): one verified policy decision over a
ctx vector and dense map tiles, with the same observable result — the
return value, the ctx words and every map word.  The hand-written CUDA
kernel (:mod:`repro_torch.core.cudac`) is held against this module on
the card, and this module is held against the JAX Pallas kernel
(interpret mode) on the CPU.

Calling convention (``compile_torch``)::

    fn(ctx: int64[n_fields], maps: {name: int64[device_shape]})
        -> (ret: int64[], ctx_out: int64[n_fields], maps_out: {...})

on the tensors' own device; inputs are never mutated.  Every tensor
holds u64 bit patterns in ``int64``: torch's ``uint64`` has no add,
floordiv, remainder, shifts, ``<`` or ``index_put``, so the unsigned
machine is built on ``int64`` — compares flip the sign bit, right shifts
are logical (arithmetic shift, then a mask), and division splits into
an unsigned form (:func:`_udivmod`).

The lowering keeps the reference's semantics, not just the VM's:

* ``div``/``mod`` clamp the divisor to ``max(b, 1)``; shift amounts are
  masked to ``width - 1``; ALU32 results are zero-extended; ``arsh`` is
  arithmetic; compares are unsigned except ``js*``;
* a loop whose header is visited more than ``bound + 1`` times in one
  entry stops the function there (the reference's ``fori_loop`` runs
  exactly ``bound + 1`` header visits, so a path past the proven bound
  never reaches an exit: the function returns 0);
* each bpf-to-bpf call gets a fresh zeroed 512-byte frame, ctx and maps
  stay shared;
* pointers are the reference's tagged words (stack ``1<<32 | off``,
  ctx ``2<<32 | off``, map value ``(16+mi)<<56 | row<<24 | off``), so
  pointer values are bit-identical too;
* helpers act on the device layouts of :func:`repro_torch.core.maps.
  device_shape`: array rows, linear hash probing with E2BIG when full,
  LRU recency and clock, ringbuf control words, and ``ema_update`` in
  wrapping u64 arithmetic.

Two lowerings share that arithmetic and those layouts:

* :func:`run` / :func:`compile_torch` (``_Machine``) drive control flow
  from the host, one ``.item()`` per taken branch: the straightforward
  form, the plain version the CUDA kernel is held against;
* :func:`compile_predicated` (``_Lowerer``) is ``jaxc``'s if-conversion
  (``repro/core/jaxc.py``): every block runs under a boolean predicate
  tensor and every write is a ``torch.where`` on it, each natural loop
  runs exactly ``bound + 1`` predicated iterations, calls are inlined
  under the caller's predicate, loads and stores are gathers and
  scatters over the tagged pointer words, and the helpers are masked
  scans.  It reads nothing back to the host and makes no shape that
  depends on data, so a ``torch.cuda.graph`` can capture it; the
  in-graph selector's ``tier="torchc"`` runs it on the card.

The CUDA kernel is the fast path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import helpers as H
from .isa import (FP_REG, STACK_SIZE, alu_base, alu_width, is_alu,
                  is_imm_form, is_jump_cond, is_load, is_store, jump_base,
                  mem_size)
from .maps import BpfMap, MapError
from .program import Program
from .verifier import verify_with_info

M64 = (1 << 64) - 1
I64_MAX = (1 << 63) - 1
SIGN = -(1 << 63)


class TorchcError(Exception):
    pass


_STACK_TAG = 1 << 32
_CTX_TAG = 2 << 32


def _map_tag(mi: int) -> int:
    return (16 + mi) << 56


_INGRAPH_KINDS = ("array", "perdev_array", "ringbuf", "hash", "lru_hash")
_INGRAPH_HIDS = (1, 2, 64, 65, 66, 67)


def check_supported(prog: Program) -> None:
    """Raise TorchcError if ``prog`` cannot run as a policy kernel.

    The rejections and their messages are the reference's
    (``repro.core.jaxc.check_supported``): wall-clock, random and printk
    helpers are host-tier-only, in-kernel deletion would need
    tombstones, and map values are moved as whole u64 words."""
    for d in prog.maps:
        if d.kind not in _INGRAPH_KINDS:
            raise TorchcError(
                f"map '{d.name}' is {d.kind}; in-graph tier supports "
                f"{'/'.join(_INGRAPH_KINDS)} maps only")
        if d.value_size % 8:
            raise TorchcError(f"map '{d.name}': value_size must be 8-aligned")
        if d.kind == "hash" and d.key_size not in (4, 8):
            raise TorchcError(
                f"hash map '{d.name}': in-graph probing needs a 4- or "
                f"8-byte key (got {d.key_size})")
    bodies = [("main", prog.insns)]
    bodies += [(sp.name, sp.insns) for sp in prog.subprogs]
    for fname, insns in bodies:
        for pc, insn in enumerate(insns):
            if insn.op == "call" and insn.imm not in _INGRAPH_HIDS:
                hname = H.HELPERS[insn.imm].name
                if hname == "map_delete_elem":
                    raise TorchcError(
                        f"map_delete_elem (insn {pc} in {fname}) is not "
                        "available in-graph: deleting from a linear-"
                        "probing table would need tombstones; delete "
                        "from the host side instead (the bridge repacks "
                        "the table canonically on the next upload)")
                raise TorchcError(
                    f"helper {hname} (insn {pc} in {fname}) is not "
                    "available in-graph")


def fn_infos(vinfo) -> list:
    """Per-function analysis artifacts: ``vinfo.fns`` when the verifier
    ran multi-function, else the top-level object as the sole entry."""
    fns = getattr(vinfo, "fns", None)
    return list(fns) if fns else [vinfo]


# map_update_elem, ema_update and the ringbuf helpers
WRITING_HELPERS = (2, 64, 65, 66, 67)


def written_map_names(prog: Program, vinfo) -> frozenset:
    """Maps the program can mutate, from the verifier's region facts.

    A map is written iff some store's proven region is a value cell of
    it, or a mutating helper (``map_update_elem`` / ``ema_update`` / any
    ringbuf helper) statically binds to it, or a ``map_lookup_elem``
    binds to an LRU map (a hit refreshes recency).  Subprogram bodies
    count.  The bridge syncs back ONLY these maps."""
    kinds = {d.name: d.kind for d in prog.maps}
    out = set()
    for fi in fn_infos(vinfo):
        for pc, insn in enumerate(fi.insns):
            if is_store(insn.op):
                info = fi.mem_info.get(pc)
                if info is not None and info[0] not in ("ctx", "stack"):
                    out.add(info[1])
            elif insn.op == "call" and insn.imm in WRITING_HELPERS:
                mname = fi.call_map.get(pc)
                if mname is not None:
                    out.add(mname)
            elif insn.op == "call" and insn.imm == 1:
                mname = fi.call_map.get(pc)
                if mname is not None and kinds.get(mname) == "lru_hash":
                    out.add(mname)
    return frozenset(out)


# ---------------------------------------------------------------------------
# host <-> device layout conversion (over BpfMap.to_device/from_device)
# ---------------------------------------------------------------------------

def map_to_array(m: BpfMap, device=None) -> torch.Tensor:
    """Host map -> int64[device_shape] image (u64 bit patterns)."""
    try:
        out = m.to_device()
    except MapError as e:
        raise TorchcError(str(e)) from None
    t = torch.from_numpy(np.ascontiguousarray(out, dtype="<u8").view("<i8"))
    return t.to(device) if device is not None else t


def array_to_map(arr: torch.Tensor, m: BpfMap) -> None:
    """Write a device map image back into the host map."""
    m.from_device(arr.detach().cpu().numpy().view("<u8"))


def ctx_to_vec(ctx_buf, device=None) -> torch.Tensor:
    """ctx bytes -> int64[n_fields]."""
    t = torch.from_numpy(np.frombuffer(bytes(ctx_buf), dtype="<i8").copy())
    return t.to(device) if device is not None else t


def vec_to_bytes(vec: torch.Tensor) -> bytes:
    return vec.detach().cpu().numpy().astype("<i8").tobytes()


def words_to_pairs(t: torch.Tensor) -> torch.Tensor:
    """``int64[...]`` u64 words -> ``int32[..., 2]`` ``[lo, hi]`` pairs,
    the same bytes (a view of a contiguous ``t``)."""
    return t.contiguous().unsqueeze(-1).view(torch.int32)


def pairs_to_words(t: torch.Tensor) -> torch.Tensor:
    """``int32[..., 2]`` pairs -> ``int64[...]`` u64 words (a view)."""
    return t.contiguous().view(torch.int64).squeeze(-1)


# ---------------------------------------------------------------------------
# unsigned u64 arithmetic on int64 tensors
# ---------------------------------------------------------------------------

def _s64(v: int) -> int:
    """u64 (any Python int) -> the int64 with the same bit pattern."""
    v &= M64
    return v - (1 << 64) if v > I64_MAX else v


def _ult(a, b):
    return (a ^ SIGN) < (b ^ SIGN)


def _ule(a, b):
    return (a ^ SIGN) <= (b ^ SIGN)


def _lshr(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift by ``s`` in [0, 63]: arithmetic shift, then
    clear the bits the sign filled."""
    keep = torch.full_like(a, I64_MAX) >> (s - 1).clamp(min=0)
    return torch.where(s == 0, a, (a >> s) & keep)


def _udivmod(a: torch.Tensor, b: torch.Tensor):
    """Unsigned (q, r) of u64 bit patterns, ``b != 0``.

    ``b >= 2**63``: the quotient is 0 or 1.  Otherwise, halve ``a``
    logically, divide, double, and correct by one — every division
    torch sees has a non-negative dividend and a positive divisor."""
    bneg = b < 0
    bp = torch.where(bneg, torch.ones_like(b), b)
    half = (a >> 1) & I64_MAX
    q1 = (half // bp) << 1
    q1 = q1 + _ule(bp, a - q1 * bp).to(a.dtype)
    q = torch.where(a >= 0, a.clamp(min=0) // bp, q1)
    q = torch.where(bneg, _ule(b, a).to(a.dtype), q)
    return q, a - q * b


def _alu(base: str, width: int, a, b):
    mask32 = 0xFFFFFFFF
    if width == 32:
        a = a & mask32
        b = b & mask32

    def fin(x):
        return (x & mask32) if width == 32 else x

    if base == "mov":
        return fin(b)
    if base == "add":
        return fin(a + b)
    if base == "sub":
        return fin(a - b)
    if base == "mul":
        return fin(a * b)
    if base in ("div", "mod"):
        q, r = _udivmod(a, torch.where(b == 0, torch.ones_like(b), b))
        return fin(q if base == "div" else r)
    if base == "and":
        return a & b
    if base == "or":
        return fin(a | b)
    if base == "xor":
        return fin(a ^ b)
    sh = b & (width - 1)
    if base == "lsh":
        return fin(a << sh)
    if base == "rsh":
        return fin(_lshr(a, sh))
    if base == "arsh":
        sa = a if width == 64 else ((a & mask32) ^ 0x80000000) - 0x80000000
        return fin(sa >> sh)
    if base == "neg":
        return fin(-a)
    raise TorchcError(f"ALU base {base}")


def _cmp(base: str, a, b) -> bool:
    return bool(_cmp_t(base, a, b).item())


def _cmp_t(base: str, a, b) -> torch.Tensor:
    """The branch condition as a bool tensor (unsigned but for ``js*``)."""
    if base == "jeq":
        c = a == b
    elif base == "jne":
        c = a != b
    elif base == "jgt":
        c = _ult(b, a)
    elif base == "jge":
        c = _ule(b, a)
    elif base == "jlt":
        c = _ult(a, b)
    elif base == "jle":
        c = _ule(a, b)
    elif base == "jset":
        c = (a & b) != 0
    else:
        c = {"jsgt": lambda: a > b, "jsge": lambda: a >= b,
             "jslt": lambda: a < b, "jsle": lambda: a <= b}[base]()
    return c


# ---------------------------------------------------------------------------
# the machine
# ---------------------------------------------------------------------------

class _Frame:
    """Registers and stack of one function activation."""

    def __init__(self, m: "_Machine"):
        self.regs: List[torch.Tensor] = [m.c(0)] * 11
        self.regs[FP_REG] = m.c(_STACK_TAG | STACK_SIZE)
        self.stack = torch.zeros(STACK_SIZE // 8, dtype=torch.int64,
                                 device=m.dev)


class _Machine:
    """One policy invocation.  ``run`` walks the verified CFG block by
    block; the branch conditions are the only host reads."""

    def __init__(self, prog: Program, vinfo, ctx: torch.Tensor,
                 maps: Dict[str, torch.Tensor]):
        self.prog = prog
        self.fns = fn_infos(vinfo)
        self.dev = ctx.device
        self.ctx = ctx.to(torch.int64).clone()
        self.maps = {k: v.to(torch.int64).clone() for k, v in maps.items()}
        self.decls = list(prog.maps)
        self.map_index = {d.name: i for i, d in enumerate(self.decls)}

    def c(self, v: int) -> torch.Tensor:
        return torch.tensor(_s64(v), dtype=torch.int64, device=self.dev)

    def run(self):
        ret = self._run_fn(0, None)
        return ret, self.ctx, self.maps

    # ---- control flow ------------------------------------------------------
    def _run_fn(self, fi: int, args: Optional[List[torch.Tensor]]):
        info = self.fns[fi]
        cfg = info.cfg
        insns = info.insns
        fr = _Frame(self)
        if args is None:
            fr.regs[1] = self.c(_CTX_TAG)
        else:
            for r in (1, 2, 3, 4, 5):
                fr.regs[r] = args[r - 1]
        visits: Dict[int, int] = {}
        b, prev = 0, None
        while True:
            L = cfg.loops.get(b)
            if L is not None:
                if prev is None or prev not in L.body:
                    visits[b] = 0          # a fresh entry into this loop
                visits[b] += 1
                if visits[b] > info.loop_bounds[b] + 1:
                    return self.c(0)       # past the proven bound: no exit
            start, end = cfg.ranges[b]
            nxt = cfg.succs[b][0]
            for pc in range(start, end):
                insn = insns[pc]
                op = insn.op
                if op == "exit":
                    return fr.regs[0]
                if op == "ja":
                    break
                if is_jump_cond(op):
                    a = fr.regs[insn.dst]
                    v = self.c(insn.imm) if is_imm_form(op) \
                        else fr.regs[insn.src]
                    taken, fall = cfg.succs[b]
                    nxt = taken if _cmp(jump_base(op), a, v) else fall
                    break
                self._straight(info, fr, pc, insn)
            if nxt == cfg.EXIT:
                return self.c(0)
            b, prev = nxt, b

    def _straight(self, info, fr: _Frame, pc: int, insn) -> None:
        op = insn.op
        regs = fr.regs
        if op == "lddw":
            regs[insn.dst] = self.c(insn.imm)
        elif op == "ldmap":
            regs[insn.dst] = self.c(_map_tag(self.map_index[insn.map_name]))
        elif op == "call":
            regs[0] = self._call(info, fr, pc, insn)
            for r in (1, 2, 3, 4, 5):
                regs[r] = self.c(0)
        elif op == "call_fn":
            regs[0] = self._run_fn(1 + insn.imm, regs[1:6])
            for r in (1, 2, 3, 4, 5):
                regs[r] = self.c(0)
        elif is_alu(op):
            a = regs[insn.dst]
            b = self.c(insn.imm) if is_imm_form(op) else regs[insn.src]
            regs[insn.dst] = _alu(alu_base(op), alu_width(op), a, b)
        elif is_load(op):
            self._load(info, fr, pc, insn)
        elif is_store(op):
            self._store(info, fr, pc, insn)
        else:
            raise TorchcError(f"unhandled op {op}")

    # ---- memory ------------------------------------------------------------
    @staticmethod
    def _stack_load(fr: _Frame, ptr, size: int):
        word = fr.stack[(ptr & 0xFFFFFFFF) >> 3]
        if size == 8:
            return word
        return _lshr(word, (ptr & 7) * 8) & ((1 << (8 * size)) - 1)

    @staticmethod
    def _stack_store(fr: _Frame, ptr, size: int, val) -> None:
        off = ptr & 0xFFFFFFFF
        slot = off >> 3
        if size == 8:
            fr.stack[slot] = val
            return
        word = fr.stack[slot]
        sh = (off & 7) * 8
        mask = (1 << (8 * size)) - 1
        fr.stack[slot] = (word & ~(mask << sh)) | ((val & mask) << sh)

    @staticmethod
    def _mapval(ptr):
        return (ptr >> 24) & 0xFFFFFFFF, (ptr & 0xFFFFFF) >> 3

    def _load(self, info, fr: _Frame, pc: int, insn) -> None:
        size = mem_size(insn.op)
        region, mname, base = info.mem_info[pc]
        ptr = fr.regs[insn.src] + _s64(insn.off)
        if region == "ctx":
            val = self.ctx[(base + insn.off) // 8]
        elif region == "stack":
            fr.regs[insn.dst] = self._stack_load(fr, ptr, size)
            return
        else:
            row, slot = self._mapval(ptr)
            val = self.maps[mname][row, slot]
        if size < 8:
            val = val & ((1 << (8 * size)) - 1)
        fr.regs[insn.dst] = val

    def _store(self, info, fr: _Frame, pc: int, insn) -> None:
        size = mem_size(insn.op)
        region, mname, base = info.mem_info[pc]
        val = fr.regs[insn.src] if insn.op.startswith("stx") \
            else self.c(insn.imm)
        ptr = fr.regs[insn.dst] + _s64(insn.off)
        if region == "ctx":
            self.ctx[(base + insn.off) // 8] = val
        elif region == "stack":
            self._stack_store(fr, ptr, size, val)
        else:
            # the reference moves whole u64 words into map cells
            row, slot = self._mapval(ptr)
            self.maps[mname][row, slot] = val

    # ---- helpers -----------------------------------------------------------
    def _enc(self, mi: int, row) -> torch.Tensor:
        return _map_tag(mi) | ((row & 0xFFFFFFFF) << 24)

    def _stack_row(self, fr: _Frame, ptr, slots: int) -> torch.Tensor:
        return torch.stack([self._stack_load(fr, ptr + 8 * s, 8)
                            for s in range(slots)])

    def _call(self, info, fr: _Frame, pc: int, insn) -> torch.Tensor:
        hid = insn.imm
        mname = info.call_map.get(pc)
        if mname is None:
            raise TorchcError(f"helper at insn {pc} has no static map binding")
        mi = self.map_index[mname]
        d = self.decls[mi]
        if d.kind == "ringbuf":
            return self._call_ringbuf(hid, mi, d)
        if d.kind == "lru_hash":
            return self._call_lru(fr, hid, mi, d)
        if d.kind == "hash":
            return self._call_hash(fr, hid, mi, d)
        regs = fr.regs
        arr = self.maps[d.name]
        key = self._stack_load(fr, regs[2], d.key_size)
        valid = bool(_ult(key, self.c(d.max_entries)).item())
        ki = key if valid else self.c(d.max_entries - 1)
        if hid == 1:        # map_lookup_elem
            return self._enc(mi, key) if valid else self.c(0)
        if hid == 2:        # map_update_elem
            if not valid:
                return self.c(M64)
            arr[ki] = self._stack_row(fr, regs[3], d.value_size // 8)
            return self.c(0)
        if hid == 64:       # ema_update (key out of range: no write)
            w = torch.where(regs[4] == 0, torch.ones_like(regs[4]), regs[4])
            new, _ = _udivmod(arr[ki, 0] * (w - 1) + regs[3], w)
            if valid:
                arr[ki, 0] = new
            return new
        raise TorchcError(f"helper {hid} not supported in-graph")

    def _call_ringbuf(self, hid: int, mi: int, d) -> torch.Tensor:
        """reserve/submit/discard on the control words appended to the
        record rows: head / tail / drops / pending."""
        arr = self.maps[d.name]
        slots = d.value_size // 8

        def ctl(w):
            return d.max_entries + w // slots, w % slots

        hp, pp = ctl(0), ctl(3)
        head, pend = arr[hp].clone(), arr[pp].clone()
        if hid == 66:       # ringbuf_submit
            arr[hp] = head + pend
            arr[pp] = 0
            return self.c(0)
        if hid == 67:       # ringbuf_discard
            arr[pp] = 0
            return self.c(0)
        if hid != 65:
            raise TorchcError(f"helper {hid} on ringbuf map '{d.name}'")
        # reserve: commit a still-pending record, then NULL (+1 drop) on
        # full, else mark the next row pending
        tp, dp = ctl(1), ctl(2)
        head1 = head + pend
        full = bool(_ule(self.c(d.max_entries), head1 - arr[tp]).item())
        arr[hp] = head1
        arr[pp] = 0 if full else 1
        if full:
            arr[dp] = arr[dp] + 1
            return self.c(0)
        _, row = _udivmod(head1, self.c(d.max_entries))
        return self._enc(mi, row)

    def _call_lru(self, fr: _Frame, hid: int, mi: int, d) -> torch.Tensor:
        """lookup/update/ema on ``[values..., key, recency]`` rows plus the
        clock cell.  Hits are the first matching row; the victim is the
        first row of least recency (free rows have recency 0)."""
        arr = self.maps[d.name]
        slots = d.value_size // 8
        cap = d.max_entries
        regs = fr.regs
        key = self._stack_load(fr, regs[2], d.key_size)
        recs = arr[:cap, slots + 1]
        match = (recs != 0) & (arr[:cap, slots] == key)
        found = bool(match.any().item())
        clock1 = arr[cap, 0] + 1
        if hid == 1:
            if not found:
                return self.c(0)
            idx = match.to(torch.int64).argmax()
            arr[cap, 0] = clock1
            arr[idx, slots + 1] = clock1
            return self._enc(mi, idx)
        tgt = match.to(torch.int64).argmax() if found \
            else (recs ^ SIGN).argmin()
        if hid == 2:
            vals = self._stack_row(fr, regs[3], slots)
            ret = self.c(0)
        elif hid == 64:
            w = torch.where(regs[4] == 0, torch.ones_like(regs[4]), regs[4])
            old = arr[tgt, 0] if found else self.c(0)
            new, _ = _udivmod(old * (w - 1) + regs[3], w)
            vals = arr[tgt, :slots].clone() if found \
                else torch.zeros(slots, dtype=torch.int64, device=self.dev)
            vals[0] = new
            ret = new
        else:
            raise TorchcError(f"helper {hid} on lru_hash map '{d.name}'")
        arr[tgt, :slots] = vals
        arr[tgt, slots] = key
        arr[tgt, slots + 1] = clock1
        arr[cap, 0] = clock1
        return ret

    def _hash_probe(self, arr, d, key):
        """Open-addressing probe: the first row, in linear-probe order
        from ``hash_slot(key)``, that matches the key or is empty.
        Returns ``(first, hit, can_claim)``; with no such row (full table,
        key absent) ``first`` is row 0 and neither flag is set."""
        slots = d.value_size // 8
        cap = d.max_entries
        used = arr[:cap, slots + 1] != 0
        _, h = _udivmod((key & 0xFFFFFFFF) ^ _lshr(key, self.c(32)),
                        self.c(cap))
        idx = torch.arange(cap, dtype=torch.int64, device=self.dev)
        # linear-probe distance from the home slot, as the host map packs
        # (the reference computes it in wrapping u64, which disagrees
        # with the host packing when cap is not a power of two)
        dist = (idx - h + cap) % cap
        is_match = used & (arr[:cap, slots] == key)
        stop = is_match | ~used
        if not bool(stop.any().item()):
            return self.c(0), False, False
        first = torch.where(stop, dist, torch.full_like(dist, cap)).argmin()
        hit = bool(is_match[first].item())
        return first, hit, not hit

    def _call_hash(self, fr: _Frame, hid: int, mi: int, d) -> torch.Tensor:
        """lookup/update/ema on ``[values..., key, used]`` rows plus the
        occupancy cell; a full table rejects inserts with -1 (E2BIG)."""
        arr = self.maps[d.name]
        slots = d.value_size // 8
        cap = d.max_entries
        regs = fr.regs
        key = self._stack_load(fr, regs[2], d.key_size)
        first, hit, can_claim = self._hash_probe(arr, d, key)
        if hid == 1:
            return self._enc(mi, first) if hit else self.c(0)
        ok = hit or can_claim
        if hid == 2:
            vals = self._stack_row(fr, regs[3], slots)
            ret = self.c(0 if ok else M64)
        elif hid == 64:
            w = torch.where(regs[4] == 0, torch.ones_like(regs[4]), regs[4])
            old = arr[first, 0] if hit else self.c(0)
            new, _ = _udivmod(old * (w - 1) + regs[3], w)
            vals = arr[first, :slots].clone() if hit \
                else torch.zeros(slots, dtype=torch.int64, device=self.dev)
            vals[0] = new
            ret = new
        else:
            raise TorchcError(f"helper {hid} on hash map '{d.name}'")
        if ok:
            arr[first, :slots] = vals
            arr[first, slots] = key
            arr[first, slots + 1] = 1
        if can_claim:
            arr[cap, 0] = arr[cap, 0] + 1
        return ret


def run(prog: Program, vinfo, ctx: torch.Tensor,
        maps: Dict[str, torch.Tensor]
        ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One decision of ``prog`` (already checked and verified)."""
    return _Machine(prog, vinfo, ctx, maps).run()


def run32(prog: Program, vinfo, ctx2: torch.Tensor,
          maps2: Dict[str, torch.Tensor]
          ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One decision over pair-form operands (the plain version of the
    pair-form kernel): ``ctx2`` ``int32[n_fields, 2]``, each map
    ``int32[*device_shape, 2]``, every u64 as ``[lo, hi]``.  The pairs
    are viewed as u64 words and run through :func:`run`; returns
    ``(ret int32[2], ctx2_out, maps2_out)``, inputs untouched."""
    ret, ctx, maps = run(prog, vinfo, pairs_to_words(ctx2),
                         {n: pairs_to_words(t) for n, t in maps2.items()})
    return (words_to_pairs(ret.reshape(1)).reshape(2), words_to_pairs(ctx),
            {n: words_to_pairs(t) for n, t in maps.items()})


def compile_torch(prog: Program, vinfo=None):
    """Return ``(fn, map_names)`` — the plain PyTorch policy function.

    ``vinfo`` reuses a prior :func:`verify_with_info` result, so the
    runtime's load path pays for one verifier pass."""
    check_supported(prog)
    if vinfo is None:
        vinfo = verify_with_info(prog)

    def fn(ctx_vec: torch.Tensor, map_arrays: Dict[str, torch.Tensor]):
        return run(prog, vinfo, ctx_vec, map_arrays)

    return fn, [d.name for d in prog.maps]


# ---------------------------------------------------------------------------
# the predicated lowering (jaxc's if-conversion): no host read
# ---------------------------------------------------------------------------

M32 = 0xFFFFFFFF


def _pred_or(ps: list) -> torch.Tensor:
    p = ps[0]
    for q in ps[1:]:
        p = p | q
    return p


class _Lowerer:
    """One policy invocation as predicated tensor ops: the port of
    ``repro.core.jaxc._Lowerer``.

    The machine state lives in attributes (``regs``, ``stack``, ``ctx``,
    ``maps``, ``done``, ``ret``) and every write selects on the block's
    predicate, so the walk over the CFG is the same for every input.  A
    loop is a Python loop of ``bound + 1`` iterations (the reference's
    ``fori_loop``).  Indices that come from register values are clamped
    into their tensor: under a false predicate a register may hold
    anything, and the selected-away read must stay in bounds (the
    reference's gathers clamp too); under a true predicate the verifier
    proved them in bounds."""

    def __init__(self, prog: Program, vinfo, ctx: torch.Tensor,
                 maps: Dict[str, torch.Tensor]):
        self.fns = fn_infos(vinfo)
        self.fninfo = self.fns[0]
        self.cfg = self.fninfo.cfg
        self.insns = list(prog.insns)
        self.decls = list(prog.maps)
        self.map_index = {d.name: i for i, d in enumerate(self.decls)}
        self.dev = ctx.device
        self._consts: Dict[int, torch.Tensor] = {}
        self._ranges: Dict[int, torch.Tensor] = {}
        self.ctx = ctx.to(torch.int64)
        self.maps = {k: v.to(torch.int64) for k, v in maps.items()}
        self.true = torch.ones((), dtype=torch.bool, device=self.dev)
        self.false = torch.zeros((), dtype=torch.bool, device=self.dev)
        self.regs: List[torch.Tensor] = [self.c(0)] * 11
        self.regs[1] = self.c(_CTX_TAG)
        self.regs[FP_REG] = self.c(_STACK_TAG | STACK_SIZE)
        self.stack = self._fresh_stack()
        self.done = self.false
        self.ret = self.c(0)

    # ---- constants and index helpers ---------------------------------------
    def c(self, v: int) -> torch.Tensor:
        """A u64 constant: a fill on the device (no host copy), made once
        per value (the lowering never writes a tensor in place)."""
        v = _s64(v)
        t = self._consts.get(v)
        if t is None:
            t = torch.full((), v, dtype=torch.int64, device=self.dev)
            self._consts[v] = t
        return t

    def _arange(self, n: int) -> torch.Tensor:
        t = self._ranges.get(n)
        if t is None:
            t = torch.arange(n, dtype=torch.int64, device=self.dev)
            self._ranges[n] = t
        return t

    def _fresh_stack(self) -> torch.Tensor:
        return torch.zeros(STACK_SIZE // 8, dtype=torch.int64,
                           device=self.dev)

    @staticmethod
    def _get(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``flat[idx]`` (1-D, ``idx`` a 0-d int64 tensor) as a 0-d
        tensor, ``idx`` clamped into the tensor."""
        i = idx.clamp(0, flat.numel() - 1).reshape(1)
        return flat.index_select(0, i).reshape(())

    def _put(self, flat: torch.Tensor, idx: torch.Tensor, val, P
             ) -> torch.Tensor:
        """A new ``flat`` with ``flat[idx] = val`` where ``P`` holds (no
        write at all for an index outside the tensor)."""
        return torch.where((self._arange(flat.numel()) == idx) & P,
                           val, flat)

    def _row(self, arr: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
        i = row.clamp(0, arr.shape[0] - 1).reshape(1)
        return arr.index_select(0, i).reshape(arr.shape[1])

    def _put_row(self, arr: torch.Tensor, row: torch.Tensor,
                 vals: torch.Tensor, P) -> torch.Tensor:
        hit = ((self._arange(arr.shape[0]) == row) & P).reshape(-1, 1)
        return torch.where(hit, vals.reshape(1, -1), arr)

    def _cell(self, arr, row, col: int) -> torch.Tensor:
        return self._get(arr.reshape(-1), row * arr.shape[1] + col)

    def _put_cell(self, arr, row, col: int, val, P) -> torch.Tensor:
        flat = self._put(arr.reshape(-1), row * arr.shape[1] + col, val, P)
        return flat.reshape(arr.shape)

    # ---- entry -------------------------------------------------------------
    def run(self):
        top = {h for h, L in self.cfg.loops.items() if L.parent is None}
        out = self._exec_region(list(range(self.cfg.n)), {0: [self.true]},
                                expand=top)
        if out:
            raise TorchcError(f"unrouted edges at top level: {sorted(out)}")
        return self.ret, self.ctx, self.maps

    # ---- regions and blocks (jaxc._exec_region / _exec_block) ---------------
    def _exec_region(self, block_list: List[int], incoming: Dict[int, list],
                     expand) -> Dict[int, list]:
        region = set(block_list)
        inc: Dict[int, list] = {b: list(ps) for b, ps in incoming.items()}
        out: Dict[int, list] = {}
        consumed = set()

        def route(src: int, tgt: int, p) -> None:
            if tgt == self.cfg.EXIT:
                return          # exit insns route through done / ret
            if tgt in region and tgt > src:
                inc.setdefault(tgt, []).append(p)
            else:               # leaves the region, or a back edge
                out.setdefault(tgt, []).append(p)

        for b in block_list:
            if b in consumed:
                continue
            ps = inc.get(b)
            if b in expand:
                L = self.cfg.loops[b]
                consumed |= L.body
                if ps is not None:
                    self._lower_loop(L, _pred_or(ps),
                                     lambda tgt, p, b=b: route(b, tgt, p))
                continue
            if ps is not None:  # else statically unreachable
                self._exec_block(b, _pred_or(ps),
                                 lambda tgt, p, b=b: route(b, tgt, p))
        return out

    def _exec_block(self, b: int, P, route) -> None:
        start, end = self.cfg.ranges[b]
        for pc in range(start, end):
            insn = self.insns[pc]
            op = insn.op
            if op == "exit":
                take = P & ~self.done
                self.ret = torch.where(take, self.regs[0], self.ret)
                self.done = self.done | P
                return
            if op == "ja":
                route(self.cfg.succs[b][0], P)
                return
            if is_jump_cond(op):
                a = self.regs[insn.dst]
                v = self.c(insn.imm) if is_imm_form(op) \
                    else self.regs[insn.src]
                cond = _cmp_t(jump_base(op), a, v)
                taken, fall = self.cfg.succs[b]
                route(taken, P & cond)
                route(fall, P & ~cond)
                return
            self._exec_straight(pc, insn, P)
        route(self.cfg.succs[b][0], P)     # fall-through block

    # ---- straight-line instructions ----------------------------------------
    def _wreg(self, P, idx: int, val) -> None:
        self.regs[idx] = torch.where(P, val, self.regs[idx])

    def _exec_straight(self, pc: int, insn, P) -> None:
        op = insn.op
        if op == "lddw":
            self._wreg(P, insn.dst, self.c(insn.imm))
        elif op == "ldmap":
            self._wreg(P, insn.dst,
                       self.c(_map_tag(self.map_index[insn.map_name])))
        elif op == "call":
            self._wreg(P, 0, self._call(pc, insn, P))
            for r in (1, 2, 3, 4, 5):
                self._wreg(P, r, self.c(0))
        elif op == "call_fn":
            self._inline_call(insn.imm, P)
        elif is_alu(op):
            b = self.c(insn.imm) if is_imm_form(op) else self.regs[insn.src]
            self._wreg(P, insn.dst, _alu(alu_base(op), alu_width(op),
                                         self.regs[insn.dst], b))
        elif is_load(op):
            self._exec_load(pc, insn, P)
        elif is_store(op):
            self._exec_store(pc, insn, P)
        else:
            raise TorchcError(f"unhandled op {op}")

    # ---- memory ------------------------------------------------------------
    def _stack_load(self, ptr: torch.Tensor, size: int) -> torch.Tensor:
        word = self._get(self.stack, (ptr & M32) >> 3)
        if size == 8:
            return word
        return _lshr(word, (ptr & 7) * 8) & ((1 << (8 * size)) - 1)

    def _stack_store(self, P, ptr: torch.Tensor, size: int, val) -> None:
        off = ptr & M32
        slot = off >> 3
        if size == 8:
            new = val
        else:
            word = self._get(self.stack, slot)
            sh = (off & 7) * 8
            mask = self.c((1 << (8 * size)) - 1)
            new = (word & ~(mask << sh)) | ((val & mask) << sh)
        self.stack = self._put(self.stack, slot, new, P)

    @staticmethod
    def _mapval(ptr: torch.Tensor):
        """(row, slot) of a tagged map-value pointer."""
        return (ptr >> 24) & M32, (ptr & 0xFFFFFF) >> 3

    def _exec_load(self, pc: int, insn, P) -> None:
        size = mem_size(insn.op)
        region, mname, base = self.fninfo.mem_info[pc]
        ptr = self.regs[insn.src] + _s64(insn.off)
        if region == "ctx":
            val = self.ctx[(base + insn.off) // 8]
        elif region == "stack":
            self._wreg(P, insn.dst, self._stack_load(ptr, size))
            return
        else:
            row, slot = self._mapval(ptr)
            arr = self.maps[mname]
            val = self._get(arr.reshape(-1), row * arr.shape[1] + slot)
        if size < 8:
            val = val & ((1 << (8 * size)) - 1)
        self._wreg(P, insn.dst, val)

    def _exec_store(self, pc: int, insn, P) -> None:
        size = mem_size(insn.op)
        region, mname, base = self.fninfo.mem_info[pc]
        val = self.regs[insn.src] if insn.op.startswith("stx") \
            else self.c(insn.imm)
        ptr = self.regs[insn.dst] + _s64(insn.off)
        if region == "ctx":
            slot = (base + insn.off) // 8
            self.ctx = self._put(self.ctx, self.c(slot), val, P)
        elif region == "stack":
            self._stack_store(P, ptr, size, val)
        else:
            # the reference moves whole u64 words into map cells
            row, slot = self._mapval(ptr)
            arr = self.maps[mname]
            self.maps[mname] = self._put(
                arr.reshape(-1), row * arr.shape[1] + slot, val, P
            ).reshape(arr.shape)

    # ---- helpers: masked scans ---------------------------------------------
    def _enc(self, mi: int, row: torch.Tensor) -> torch.Tensor:
        return ((row & M32) << 24) | _s64(_map_tag(mi))

    def _stack_row(self, ptr: torch.Tensor, slots: int) -> torch.Tensor:
        return torch.stack([self._stack_load(ptr + 8 * s, 8)
                            for s in range(slots)])

    def _ema(self, old: torch.Tensor) -> torch.Tensor:
        """``(old * (w - 1) + sample) // max(w, 1)`` in wrapping u64."""
        w = self.regs[4]
        w = torch.where(w == 0, self.c(1), w)
        return _udivmod(old * (w - 1) + self.regs[3], w)[0]

    def _call(self, pc: int, insn, P) -> torch.Tensor:
        hid = insn.imm
        mname = self.fninfo.call_map.get(pc)
        if mname is None:
            raise TorchcError(f"helper at insn {pc} has no static map binding")
        mi = self.map_index[mname]
        d = self.decls[mi]
        if d.kind == "ringbuf":
            return self._call_ringbuf(hid, mi, d, P)
        if d.kind == "lru_hash":
            return self._call_lru(hid, mi, d, P)
        if d.kind == "hash":
            return self._call_hash(hid, mi, d, P)
        arr = self.maps[d.name]
        key = self._stack_load(self.regs[2], d.key_size)
        valid = _ult(key, self.c(d.max_entries))
        ki = torch.where(valid, key, self.c(d.max_entries - 1))
        if hid == 1:        # map_lookup_elem
            return torch.where(valid, self._enc(mi, key), self.c(0))
        take = P & valid
        if hid == 2:        # map_update_elem
            row = self._stack_row(self.regs[3], d.value_size // 8)
            self.maps[d.name] = self._put_row(arr, ki, row, take)
            return torch.where(valid, self.c(0), self.c(M64))
        if hid == 64:       # ema_update (key out of range: no write)
            new = self._ema(self._cell(arr, ki, 0))
            self.maps[d.name] = self._put_cell(arr, ki, 0, new, take)
            return new
        raise TorchcError(f"helper {hid} not supported in-graph")

    def _call_ringbuf(self, hid: int, mi: int, d, P) -> torch.Tensor:
        """reserve/submit/discard on the control words appended to the
        record rows: head / tail / drops / pending."""
        arr = self.maps[d.name]
        slots = d.value_size // 8

        def cell(w: int):
            return self.c(d.max_entries + w // slots), w % slots

        (hr, hc), (pr, pcol) = cell(0), cell(3)
        head = self._cell(arr, hr, hc)
        pend = self._cell(arr, pr, pcol)
        if hid == 66:       # ringbuf_submit
            arr = self._put_cell(arr, hr, hc, head + pend, P)
            self.maps[d.name] = self._put_cell(arr, pr, pcol, self.c(0), P)
            return self.c(0)
        if hid == 67:       # ringbuf_discard
            self.maps[d.name] = self._put_cell(arr, pr, pcol, self.c(0), P)
            return self.c(0)
        if hid != 65:
            raise TorchcError(f"helper {hid} on ringbuf map '{d.name}'")
        # reserve: commit a still-pending record, then NULL (+1 drop) on
        # full, else mark the next row pending
        (tr, tc), (dr, dc) = cell(1), cell(2)
        head1 = head + pend
        full = _ule(self.c(d.max_entries), head1 - self._cell(arr, tr, tc))
        arr = self._put_cell(arr, hr, hc, head1, P)
        arr = self._put_cell(arr, pr, pcol,
                             torch.where(full, self.c(0), self.c(1)), P)
        arr = self._put_cell(arr, dr, dc, self._cell(arr, dr, dc) + 1,
                             P & full)
        self.maps[d.name] = arr
        row = _udivmod(head1, self.c(d.max_entries))[1]
        return torch.where(full, self.c(0), self._enc(mi, row))

    def _claim_row(self, arr, tgt, key, found, hid: int, d, slots: int,
                   tail: torch.Tensor, take):
        """The row a hash / LRU update or ema writes (the hit, else the
        claimed row): ``[values..., key, tail]``, written where ``take``
        holds.  Returns ``(arr, ret)``."""
        oldrow = self._row(arr, tgt)
        if hid == 2:        # map_update_elem
            vals = self._stack_row(self.regs[3], slots)
        elif hid == 64:     # ema_update: RMW slot 0, a miss seeds from 0
            keep = torch.where(found, oldrow[:slots],
                               torch.zeros_like(oldrow[:slots]))
            new = self._ema(keep[0])
            vals = torch.cat([new.reshape(1), keep[1:]])
        else:
            raise TorchcError(f"helper {hid} on {d.kind} map '{d.name}'")
        row = torch.cat([vals, key.reshape(1), tail.reshape(1)])
        ret = vals[0] if hid == 64 else None
        return self._put_row(arr, tgt, row, take), ret

    def _call_lru(self, hid: int, mi: int, d, P) -> torch.Tensor:
        """lookup/update/ema on ``[values..., key, recency]`` rows plus the
        clock cell.  Hits are the first matching row; the victim is the
        first row of least recency (free rows have recency 0)."""
        arr = self.maps[d.name]
        slots = d.value_size // 8
        cap = d.max_entries
        key = self._stack_load(self.regs[2], d.key_size)
        recs = arr[:cap, slots + 1]
        match = (recs != 0) & (arr[:cap, slots] == key)
        found = match.any()
        idx = match.to(torch.int64).argmax()
        clock1 = arr[cap, 0] + 1
        capt = self.c(cap)
        if hid == 1:        # a hit refreshes recency
            take = P & found
            arr = self._put_cell(arr, capt, 0, clock1, take)
            self.maps[d.name] = self._put_cell(arr, idx, slots + 1, clock1,
                                               take)
            return torch.where(found, self._enc(mi, idx), self.c(0))
        tgt = torch.where(found, idx, (recs ^ SIGN).argmin())
        arr, ret = self._claim_row(arr, tgt, key, found, hid, d, slots,
                                   clock1, P)
        self.maps[d.name] = self._put_cell(arr, capt, 0, clock1, P)
        return self.c(0) if ret is None else ret

    def _hash_probe(self, arr, d, key):
        """The first row, in linear-probe order from ``hash_slot(key)``,
        that matches the key or is empty: ``(first, hit, can_claim)``;
        with no such row (full table, key absent) ``first`` is row 0 and
        neither flag holds.  The probe distance is linear, as the host
        map packs and ``_Machine`` probes (ROADMAP C2: the reference
        computes it in wrapping u64)."""
        slots = d.value_size // 8
        cap = d.max_entries
        used = arr[:cap, slots + 1] != 0
        h = ((key & M32) ^ ((key >> 32) & M32)) % cap
        dist = (self._arange(cap) - h + cap) % cap
        is_match = used & (arr[:cap, slots] == key)
        stop = is_match | ~used
        first = torch.where(stop, dist, self.c(cap)).argmin()
        has_stop = stop.any()
        hit = has_stop & self._get(is_match, first)
        return first, hit, has_stop & ~hit

    def _call_hash(self, hid: int, mi: int, d, P) -> torch.Tensor:
        """lookup/update/ema on ``[values..., key, used]`` rows plus the
        occupancy cell; a full table rejects inserts with -1 (E2BIG)."""
        arr = self.maps[d.name]
        slots = d.value_size // 8
        cap = d.max_entries
        key = self._stack_load(self.regs[2], d.key_size)
        first, hit, can_claim = self._hash_probe(arr, d, key)
        if hid == 1:
            return torch.where(hit, self._enc(mi, first), self.c(0))
        ok = hit | can_claim
        arr, ret = self._claim_row(arr, first, key, hit, hid, d, slots,
                                   self.c(1), P & ok)
        capt = self.c(cap)
        self.maps[d.name] = self._put_cell(
            arr, capt, 0, self._cell(arr, capt, 0) + 1, P & can_claim)
        if ret is None:
            return torch.where(ok, self.c(0), self.c(M64))
        return ret

    # ---- bpf-to-bpf calls ----------------------------------------------------
    def _inline_call(self, idx: int, P) -> None:
        """``call_fn``: the callee's body inlined under the caller's
        predicate, with a fresh frame (zeroed stack, r1-r5 copied in);
        ctx and maps stay shared, done / ret are the callee's own."""
        callee = self.fns[1 + idx]
        saved = (self.fninfo, self.cfg, self.insns, self.stack, self.regs,
                 self.done, self.ret)
        self.fninfo, self.cfg = callee, callee.cfg
        self.insns = list(callee.insns)
        self.stack = self._fresh_stack()
        regs = [self.c(0)] * 11
        regs[1:6] = saved[4][1:6]
        regs[FP_REG] = self.c(_STACK_TAG | STACK_SIZE)
        self.regs = regs
        self.done, self.ret = self.false, self.c(0)
        top = {h for h, L in self.cfg.loops.items() if L.parent is None}
        out = self._exec_region(list(range(self.cfg.n)), {0: [P]},
                                expand=top)
        if out:
            raise TorchcError(f"unrouted edges in subprogram "
                              f"'{callee.name}': {sorted(out)}")
        ret = self.ret
        (self.fninfo, self.cfg, self.insns, self.stack, self.regs,
         self.done, self.ret) = saved
        self._wreg(P, 0, ret)
        for r in (1, 2, 3, 4, 5):
            self._wreg(P, r, self.c(0))

    # ---- loops (jaxc._lower_loop's fori_loop) --------------------------------
    def _lower_loop(self, L, entry_pred, route) -> None:
        """Exactly ``bound + 1`` predicated passes over header and body.
        Taking an exit latches that target's predicate and drops out of
        ``active``, so later passes change nothing; a path still active
        after the last pass is past the proven bound and never reaches
        an exit (the function returns 0, as ``_Machine`` does)."""
        h = L.header
        body = sorted(L.body)
        targets = list(L.exit_targets)
        inner = {M.header for M in self.cfg.inner_loops(L)}
        active = entry_pred
        exits = [self.false] * len(targets)
        for _ in range(self.fninfo.loop_bounds[h] + 1):
            out = self._exec_region(body, {h: [active]}, expand=inner)
            active = _pred_or(out.pop(h, [self.false]))
            exits = [e | _pred_or(out.pop(t, [self.false]))
                     for t, e in zip(targets, exits)]
            if out:
                raise TorchcError(
                    f"loop at block {h}: unrouted edges {sorted(out)}")
        for t, e in zip(targets, exits):
            route(t, e)


def compile_predicated(prog: Program, vinfo=None):
    """Return ``(fn, map_names)`` — the predicated, sync-free lowering.

    ``fn(ctx int64[n_fields], {name: int64[device_shape]}) -> (ret,
    ctx_out, maps_out)``, the calling convention of :func:`compile_torch`,
    on the tensors' device; inputs are never written (a map the program
    cannot write comes back as the same tensor).  No op reads a value
    back to the host, so the call can be captured in a CUDA graph."""
    check_supported(prog)
    if vinfo is None:
        vinfo = verify_with_info(prog)

    def fn(ctx_vec: torch.Tensor, map_arrays: Dict[str, torch.Tensor]):
        return _Lowerer(prog, vinfo, ctx_vec, map_arrays).run()

    return fn, [d.name for d in prog.maps]
