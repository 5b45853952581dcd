"""PREVAIL-style load-time static verifier.

Abstract interpretation over a register-type × unsigned-interval domain with
branch refinement.  Guarantees (before any policy executes):

  * memory safety — every load/store proven in-bounds for its region
    (ctx struct, 512-byte stack, map value of declared size)
  * null safety — ``map_lookup_elem`` results are ``map_value_or_null`` and
    must be branch-tested against NULL before dereference
  * bounded execution — a back edge is accepted only when it closes a
    *natural* loop (shared CFG layer, :mod:`repro_torch.core.cfg`) whose trip
    count the verifier can bound: a monotone counter (stack slot or
    register) stepped by a positive constant on every iteration and
    tested against a constant — or verifier-interval-bounded — limit
    with an ordered comparison, subject to a per-loop fuel cap
    (kernel-5.3 / PREVAIL-style bounded loops).  Any other back edge is
    rejected as a potentially unbounded loop; abstract interpretation
    runs to a widened fixpoint so loop bodies are verified under the
    join of all iterations.
  * ctx field permissions — input fields are read-only; writing one is
    rejected (the paper's "input-field write" bug class)
  * division safety — a divisor whose abstract interval contains 0 rejects
  * helper discipline — whitelisted per section, argument types checked
    (map pointer, initialized stack buffer of exactly key/value size)
  * stack hygiene — reads require initialized bytes; r10 is read-only;
    accesses beyond the 512-byte frame reject ("stack overflow")
  * no pointer leaks — r0 at exit must be a scalar

The error messages are deliberately actionable, matching the paper's
examples, e.g.::

    R0 is a pointer to map_value_or_null; must check != NULL before
    dereference at insn 7
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Tuple

from . import helpers as H
from .cfg import CFG, IrreducibleError, Loop
from .context import CtxType
from .isa import (FP_REG, Insn, STACK_SIZE, alu_base, alu_width, is_alu,
                  is_imm_form, is_jump_cond, is_load, is_store, jump_base,
                  mem_size, s64, u64)
from .program import MapDecl, Program

U64_MAX = (1 << 64) - 1

# bounded-loop limits (kernel-style): per-loop trip-count cap, and a cap on
# abstract re-analysis so the widened fixpoint is itself bounded
LOOP_FUEL_CAP = 1 << 16
_WIDEN_AFTER = 2          # joins at one pc before widening kicks in
_ANALYSIS_STEPS_PER_INSN = 256

# bpf-to-bpf call limits (kernel: MAX_CALL_FRAMES / check_max_stack_depth)
CALL_DEPTH_LIMIT = 8


class VerifierError(Exception):
    """Load-time rejection.  ``.insn`` is the offending instruction index."""

    def __init__(self, msg: str, insn: Optional[int] = None):
        self.insn = insn
        super().__init__(msg if insn is None else f"{msg} at insn {insn}")


# ---------------------------------------------------------------------------
# Abstract values
# ---------------------------------------------------------------------------

UNINIT = "uninit"
SCALAR = "scalar"
CTX = "ctx"
STACK = "stack"
MAPVAL = "mapval"
MAPVAL_OR_NULL = "mapval_or_null"
MAPPTR = "map"

_null_ids = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class AVal:
    kind: str = UNINIT
    lo: int = 0              # unsigned interval (scalar) / offset interval (ptr)
    hi: int = U64_MAX
    map_name: Optional[str] = None
    null_id: int = 0         # groups copies of one lookup result

    # -- constructors ------------------------------------------------------
    @staticmethod
    def scalar(lo: int = 0, hi: int = U64_MAX) -> "AVal":
        return AVal(SCALAR, lo, hi)

    @staticmethod
    def const(v: int) -> "AVal":
        v = u64(v)
        return AVal(SCALAR, v, v)

    @property
    def is_const(self) -> bool:
        return self.kind == SCALAR and self.lo == self.hi

    @property
    def is_ptr(self) -> bool:
        return self.kind in (CTX, STACK, MAPVAL, MAPVAL_OR_NULL, MAPPTR)

    def name(self) -> str:
        if self.kind == MAPVAL_OR_NULL:
            return "pointer to map_value_or_null"
        return {UNINIT: "uninitialized value", SCALAR: "scalar",
                CTX: "pointer to ctx", STACK: "pointer to stack",
                MAPVAL: "pointer to map value",
                MAPPTR: "pointer to map"}[self.kind]


def join_vals(a: AVal, b: AVal) -> AVal:
    if a == b:
        return a
    if a.kind != b.kind or a.map_name != b.map_name:
        return AVal(UNINIT)
    if a.kind in (SCALAR, CTX, STACK, MAPVAL):
        return AVal(a.kind, min(a.lo, b.lo), max(a.hi, b.hi), a.map_name)
    if a.kind == MAPVAL_OR_NULL:
        if a.null_id == 0 or b.null_id == 0:
            # a tainted (cross-iteration) pointer stays unrefinable
            return AVal(MAPVAL_OR_NULL, 0, 0, a.map_name, 0)
        # different lookups joined: keep or-null with fresh id
        return AVal(MAPVAL_OR_NULL, 0, 0, a.map_name, next(_null_ids))
    return AVal(UNINIT)


def widen_vals(old: AVal, new: AVal) -> AVal:
    """Jump growing interval bounds to the domain extremes so joins at
    loop headers reach a fixpoint (classic widen; branch refinement
    inside the loop then narrows where it matters)."""
    if old.kind != new.kind or old.map_name != new.map_name:
        return new  # join already degraded the kind
    if new.kind in (SCALAR, CTX, STACK, MAPVAL):
        lo = new.lo if new.lo >= old.lo else 0
        hi = new.hi if new.hi <= old.hi else U64_MAX
        return AVal(new.kind, lo, hi, new.map_name, new.null_id)
    return new


@dataclasses.dataclass(frozen=True)
class AState:
    regs: Tuple[AVal, ...]
    stack_init: int          # bitmask of initialized stack bytes (512 bits)

    def with_reg(self, i: int, v: AVal) -> "AState":
        regs = list(self.regs)
        regs[i] = v
        return AState(tuple(regs), self.stack_init)


def join_states(a: AState, b: AState) -> AState:
    return AState(tuple(join_vals(x, y) for x, y in zip(a.regs, b.regs)),
                  a.stack_init & b.stack_init)


def widen_states(old: AState, new: AState) -> AState:
    return AState(tuple(widen_vals(x, y) for x, y in zip(old.regs, new.regs)),
                  new.stack_init)


def states_equiv(a: AState, b: AState) -> bool:
    """Equality modulo a consistent renaming of lookup-result null ids.

    Helper calls mint a fresh ``null_id`` on every abstract visit, so loop
    re-analysis never reaches literal equality; what must stabilize is the
    *grouping* of or-null copies, which a bijection check captures."""
    if a.stack_init != b.stack_init:
        return False
    fwd: Dict[int, int] = {}
    bwd: Dict[int, int] = {}
    for x, y in zip(a.regs, b.regs):
        if x.kind != y.kind:
            return False
        if x.kind == MAPVAL_OR_NULL:
            if x.map_name != y.map_name:
                return False
            if fwd.setdefault(x.null_id, y.null_id) != y.null_id:
                return False
            if bwd.setdefault(y.null_id, x.null_id) != x.null_id:
                return False
        elif x != y:
            return False
    return True


def taint_or_null(st: AState) -> AState:
    """Propagate along a back edge: lookup results from a previous
    iteration can no longer be refined by this iteration's null checks
    (a fresh check must follow a fresh lookup), so their ids collapse to
    the unrefinable group 0."""
    if not any(v.kind == MAPVAL_OR_NULL and v.null_id for v in st.regs):
        return st
    regs = tuple(
        AVal(MAPVAL_OR_NULL, v.lo, v.hi, v.map_name, 0)
        if v.kind == MAPVAL_OR_NULL and v.null_id else v
        for v in st.regs)
    return AState(regs, st.stack_init)


# ---------------------------------------------------------------------------
# Interval arithmetic (unsigned, conservative)
# ---------------------------------------------------------------------------

def _ival_alu(base: str, width: int, a: AVal, b: AVal, pc: int) -> AVal:
    TOP = AVal.scalar()
    mask = U64_MAX if width == 64 else 0xFFFFFFFF
    if base == "mov":
        if width == 32:
            if b.is_ptr:
                raise VerifierError("32-bit mov of a pointer truncates it", pc)
            return AVal(SCALAR, b.lo, b.hi) if b.hi <= mask else AVal(SCALAR, 0, mask)
        return b
    if a.kind != SCALAR or b.kind != SCALAR:
        return TOP
    alo, ahi, blo, bhi = a.lo, a.hi, b.lo, b.hi
    if base == "add":
        lo, hi = alo + blo, ahi + bhi
        return AVal(SCALAR, lo, hi) if hi <= mask else TOP
    if base == "sub":
        if alo >= bhi:
            return AVal(SCALAR, alo - bhi, ahi - blo)
        return TOP
    if base == "mul":
        hi = ahi * bhi
        return AVal(SCALAR, alo * blo, hi) if hi <= mask else TOP
    if base in ("div", "mod"):
        if blo == 0:
            raise VerifierError(
                f"div/mod by zero: divisor interval [{blo},{bhi}] contains 0", pc)
        if base == "div":
            return AVal(SCALAR, alo // bhi, ahi // blo)
        return AVal(SCALAR, 0, min(ahi, bhi - 1))
    if base == "and":
        return AVal(SCALAR, 0, min(ahi, bhi))
    if base == "or":
        if ahi | bhi <= mask:
            return AVal(SCALAR, max(alo, blo), min(mask, _or_upper(ahi, bhi)))
        return TOP
    if base == "xor":
        return AVal(SCALAR, 0, min(mask, _or_upper(ahi, bhi)))
    if base == "lsh":
        if b.is_const:
            sh = b.lo & (width - 1)  # hardware masks the shift amount
            if ahi << sh <= mask:
                return AVal(SCALAR, alo << sh, ahi << sh)
        return TOP
    if base == "rsh":
        if b.is_const:
            sh = b.lo & (width - 1)
            return AVal(SCALAR, alo >> sh, ahi >> sh)
        return AVal(SCALAR, 0, ahi)
    if base == "arsh":
        return TOP
    if base == "neg":
        return TOP
    return TOP


def _or_upper(a: int, b: int) -> int:
    m = a | b
    # round up to all-ones of same bit length
    return (1 << m.bit_length()) - 1 if m else 0


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FnInfo:
    """Per-function verifier artifacts.

    Deliberately the same attribute surface the execution tiers already
    read off the top-level :class:`Verifier` (whose attributes alias
    ``fns[0]`` after verification) — a callee compiles/lowers by
    swapping which info object drives codegen."""
    index: int                     # 0 = main, 1 + i = subprogs[i]
    name: str
    insns: Tuple[Insn, ...]
    n_args: int
    cfg: Optional[CFG] = None
    mem_info: Dict[int, Tuple[str, Optional[str], Optional[int]]] = \
        dataclasses.field(default_factory=dict)
    call_map: Dict[int, Optional[str]] = dataclasses.field(
        default_factory=dict)
    # (pc, argi) -> frame offset of a helper's stack-pointer argument,
    # None where the offset is not one constant (recorded like mem_info)
    stack_args: Dict[Tuple[int, int], Optional[int]] = dataclasses.field(
        default_factory=dict)
    loop_bounds: Dict[int, int] = dataclasses.field(default_factory=dict)
    max_steps: int = 0
    stack_usage: int = 0           # deepest frame byte this fn touches
    # joined unsigned interval of r0 across every exit
    ret_lo: int = 0
    ret_hi: int = U64_MAX
    callees: Tuple[int, ...] = ()  # fn indices this fn call_fn's


class Verifier:
    def __init__(self, program: Program):
        self.prog = program
        self.ctx: CtxType = program.ctx_type
        self.map_decls: Dict[str, MapDecl] = {d.name: d for d in program.maps}
        # insns of the function currently under analysis (main's after
        # verify() returns — every per-function helper below reads this,
        # never prog.insns directly)
        self.insns: List[Insn] = list(program.insns)
        # pc -> (region kind, map_name, const offset or None) for every
        # memory insn, and pc -> map_name for every helper call; consumed
        # by the JIT and jaxc, which need static region types.
        self.mem_info: Dict[int, Tuple[str, Optional[str],
                                       Optional[int]]] = {}
        self.call_map: Dict[int, Optional[str]] = {}
        self.stack_args: Dict[Tuple[int, int], Optional[int]] = {}
        # filled by verify(): shared CFG, proven per-loop trip bounds
        # (header block -> iterations), and a whole-program dynamic step
        # bound the interpreter uses as its fuel budget
        self.cfg: Optional[CFG] = None
        self.loop_bounds: Dict[int, int] = {}
        self.max_steps: int = 0
        # per-function artifacts: fns[0] = main, fns[1 + i] = subprogs[i]
        self.fns: List[FnInfo] = []
        self._min_stack = STACK_SIZE

    # -- public -------------------------------------------------------------
    def verify(self) -> None:
        if not self.prog.insns:
            raise VerifierError("empty program")
        self.fns = [FnInfo(0, "main", tuple(self.prog.insns), 0)] + [
            FnInfo(1 + i, sp.name, tuple(sp.insns), sp.n_args)
            for i, sp in enumerate(self.prog.subprogs)]
        order = self._check_call_graph()
        for fi in order:              # callees strictly before callers
            fn = self.fns[fi]
            try:
                self._verify_fn(fn)
            except VerifierError as e:
                if fi == 0:
                    raise
                raise VerifierError(
                    f"in subprogram '{fn.name}': {e}") from None
        self._check_stack_depth()
        # top-level artifact surface = main's (backward compatible)
        main = self.fns[0]
        self.insns = list(main.insns)
        self.cfg = main.cfg
        self.mem_info = main.mem_info
        self.call_map = main.call_map
        self.stack_args = main.stack_args
        self.loop_bounds = main.loop_bounds
        self.max_steps = main.max_steps

    # -- call graph (bpf-to-bpf) ---------------------------------------------
    def _check_call_graph(self) -> List[int]:
        """Validate the call_fn graph (a DAG, depth <= 8 frames) and
        return the fn indices callees-first."""
        for fn in self.fns:
            fn.callees = tuple(sorted({
                1 + insn.imm for insn in fn.insns if insn.op == "call_fn"}))
        # DFS: cycle rejection + postorder (callees first) + frame depth
        WHITE, GREY, BLACK = 0, 1, 2
        color = [WHITE] * len(self.fns)
        post: List[int] = []
        depth: Dict[int, int] = {}

        def visit(fi: int, chain: List[int]) -> int:
            if color[fi] == GREY:
                cyc = chain[chain.index(fi):] + [fi]
                names = " -> ".join(self.fns[c].name for c in cyc)
                raise VerifierError(
                    f"recursive bpf-to-bpf call cycle: {names}; calls "
                    "must form a DAG — restructure the recursion into a "
                    "bounded loop")
            if color[fi] == BLACK:
                return depth[fi]
            color[fi] = GREY
            chain.append(fi)
            d = 1 + max([visit(c, chain) for c in self.fns[fi].callees]
                        or [0])
            chain.pop()
            color[fi] = BLACK
            depth[fi] = d
            post.append(fi)
            return d

        for fi in range(len(self.fns)):
            if color[fi] == WHITE:
                d = visit(fi, [])
                if fi == 0 and d > CALL_DEPTH_LIMIT:
                    raise VerifierError(
                        f"bpf-to-bpf call chain is {d} frames deep; the "
                        f"limit is {CALL_DEPTH_LIMIT} (kernel "
                        "MAX_CALL_FRAMES) — flatten the helper chain")
        return post

    def _check_stack_depth(self) -> None:
        """Combined stack of the deepest call chain must fit one kernel
        stack budget (check_max_stack_depth style): each frame is fresh,
        but the total across frames is capped at STACK_SIZE."""
        memo: Dict[int, int] = {}

        def total(fi: int) -> int:
            if fi not in memo:
                fn = self.fns[fi]
                memo[fi] = fn.stack_usage + max(
                    [total(c) for c in fn.callees] or [0])
            return memo[fi]

        t = total(0)
        if t > STACK_SIZE:
            chain = []
            fi = 0
            while True:
                chain.append(fi)
                cs = self.fns[fi].callees
                if not cs:
                    break
                fi = max(cs, key=total)
            names = " -> ".join(
                f"{self.fns[c].name}({self.fns[c].stack_usage}B)"
                for c in chain)
            raise VerifierError(
                f"combined stack depth {t} bytes of call chain {names} "
                f"exceeds the {STACK_SIZE}-byte budget; shrink per-"
                "function stack use or flatten the call chain")

    # -- per-function analysis ------------------------------------------------
    def _verify_fn(self, fn: FnInfo) -> None:
        insns = list(fn.insns)
        if not insns:
            raise VerifierError("empty function body")
        # retarget the per-function helpers at this function's artifacts
        self.insns = insns
        self.mem_info = fn.mem_info
        self.call_map = fn.call_map
        self.stack_args = fn.stack_args
        self.loop_bounds = fn.loop_bounds
        self._min_stack = STACK_SIZE
        self._check_structure(insns)
        try:
            self.cfg = fn.cfg = CFG(insns)
        except IrreducibleError as e:
            raise VerifierError(
                "back-edge detected: irreducible control flow (the edge "
                "does not close a natural loop, so no trip bound can be "
                "proven); restructure into a single-entry loop", e.pc)

        init_regs = [AVal(UNINIT)] * 11
        if fn.index == 0:
            init_regs[1] = AVal(CTX, 0, 0)
        else:
            # scalar arguments r1..r{n_args}; the rest of r1..r5 stay
            # UNINIT so a callee reading an unpassed argument rejects
            for argi in range(1, fn.n_args + 1):
                init_regs[argi] = AVal.scalar()
        init_regs[FP_REG] = AVal(STACK, STACK_SIZE, STACK_SIZE)
        states: Dict[int, AState] = {0: AState(tuple(init_regs), 0)}

        # worklist fixpoint, lowest pc first: on a loop-free CFG this is
        # the classic single forward pass; back edges re-enqueue their
        # header until joins (with widening) stabilize
        budget = _ANALYSIS_STEPS_PER_INSN * len(insns)
        joins: Dict[int, int] = {}
        exit_pcs = set()
        ret_lo, ret_hi = None, None
        heap = [0]
        queued = {0}
        while heap:
            pc = heapq.heappop(heap)
            queued.discard(pc)
            budget -= 1
            if budget < 0:
                raise VerifierError(
                    "verifier analysis budget exhausted (abstract loop "
                    "state did not stabilize)")
            st = states[pc]
            for tgt, nst in self._step(pc, insns[pc], st):
                if tgt == -1:
                    exit_pcs.add(pc)
                    r0 = st.regs[0]
                    ret_lo = r0.lo if ret_lo is None else min(ret_lo, r0.lo)
                    ret_hi = r0.hi if ret_hi is None else max(ret_hi, r0.hi)
                    continue
                if tgt >= len(insns):
                    raise VerifierError(
                        "jump falls off the end of the program", pc)
                if tgt <= pc:
                    nst = taint_or_null(nst)
                old = states.get(tgt)
                if old is None:
                    states[tgt] = nst
                else:
                    joined = join_states(old, nst)
                    # widening applies to loop re-analysis only: count
                    # joins arriving along back edges — an ordinary
                    # multi-way forward merge must keep its precise join
                    # (widening there would e.g. pull a many-armed
                    # divisor's lower bound down to 0)
                    if tgt <= pc:
                        joins[tgt] = joins.get(tgt, 0) + 1
                        if joins[tgt] > _WIDEN_AFTER:
                            joined = widen_states(old, joined)
                    if states_equiv(joined, old):
                        continue
                    states[tgt] = joined
                if tgt not in queued:
                    queued.add(tgt)
                    heapq.heappush(heap, tgt)
        self._states = states
        # loop proofs before the exit check: an infinite loop with no
        # reachable exit is reported as the unbounded loop it is
        self._prove_loop_bounds(states)
        if not exit_pcs:
            raise VerifierError("no reachable exit instruction")
        fn.ret_lo = 0 if ret_lo is None else ret_lo
        fn.ret_hi = U64_MAX if ret_hi is None else ret_hi
        fn.stack_usage = STACK_SIZE - self._min_stack
        fn.max_steps = self.max_steps = self._step_bound()

    # -- CFG structure -------------------------------------------------------
    def _check_structure(self, insns: List[Insn]) -> None:
        for pc, insn in enumerate(insns):
            if insn.op == "ja" or is_jump_cond(insn.op):
                tgt = pc + 1 + insn.off
                if tgt > len(insns) or tgt < 0:
                    raise VerifierError("jump out of program bounds", pc)
        last = insns[-1]
        if last.op not in ("exit", "ja") and not is_jump_cond(last.op):
            raise VerifierError("program may fall through past the last insn",
                                len(insns) - 1)
        if is_jump_cond(last.op):
            raise VerifierError("program may fall through past the last insn",
                                len(insns) - 1)

    # -- bounded-loop proof ---------------------------------------------------
    # A loop is accepted when some exit test, executed on every iteration,
    # compares a monotone counter against a bounded limit:
    #   * counter cell: an 8-byte stack slot at a constant offset, or a
    #     register — written inside the loop only by `add64i cell, +step`
    #     (slot form: load/add/store against the same slot), with at least
    #     one increment on every path to every latch (dominance check)
    #   * limit: a constant immediate, or a register whose abstract
    #     interval at the exit test has a finite upper bound (e.g. a
    #     clamped ctx field) — the "ctx-field-interval limit" form
    #   * comparison: unsigned jlt/jle (continue) or jge/jgt (exit);
    #     unsigned monotonicity then caps iterations at ceil(limit/step)
    # Everything here reads the *fixpoint* region info (mem_info), so slot
    # identity and constancy are verifier facts, not syntax guesses.

    def _reject_loop(self, L: Loop, reason: str) -> None:
        pc = L.back_edge_pcs[0]
        header_pc = self.cfg.leaders[L.header]
        raise VerifierError(
            f"back-edge at insn {pc} targets insn {header_pc}: cannot "
            f"prove a bounded trip count ({reason}); supported form: a "
            "loop counter stepped by a positive constant every iteration "
            "and tested with an unsigned jlt/jle/jge/jgt against a "
            "constant or verifier-bounded limit — unroll the loop or "
            "restructure it (unbounded loops are rejected)")

    def _prove_loop_bounds(self, states: Dict[int, AState]) -> None:
        for h in sorted(self.cfg.loops):
            L = self.cfg.loops[h]
            bound, why = self._prove_one_loop(L, states)
            if bound is None:
                self._reject_loop(L, why)
            if bound > LOOP_FUEL_CAP:
                self._reject_loop(
                    L, f"proven trip bound {bound} exceeds the per-loop "
                       f"fuel cap {LOOP_FUEL_CAP}")
            self.loop_bounds[h] = bound

    def _const_stack_off(self, pc: int, insn: Insn) -> Optional[int]:
        """Absolute stack byte offset of a memory insn, if constant."""
        info = self.mem_info.get(pc)
        if info is None or info[0] != "stack" or info[2] is None:
            return None
        return info[2] + insn.off

    def _trace_reg(self, block: int, upto_pc: int, reg: int, *,
                   through_adds: bool = False):
        """Resolve what ``reg`` holds at ``upto_pc``: ('stack', off) for a
        fresh slot load, ('const', v), or ('reg', reg) if untouched in
        the block.  Follows mov chains; anything else -> None.

        ``through_adds`` (counter tracing only) skips `add64i reg, +c`
        writes: a do-while exit test on the post-increment value still
        tests the same monotone cell, and the +c only makes the tested
        value larger, so the ceil(limit/step) bound stays sound.  Never
        set for init/limit tracing, where the offset would be wrong."""
        insns = self.insns
        start = self.cfg.ranges[block][0]
        for pc in range(upto_pc - 1, start - 1, -1):
            insn = insns[pc]
            writes = self._writes_reg(insn, reg)
            if not writes:
                continue
            if through_adds and insn.op == "add64i" and insn.dst == reg \
                    and insn.imm > 0:
                continue
            if insn.op == "ldxdw" and insn.dst == reg:
                off = self._const_stack_off(pc, insn)
                if off is None:
                    return None
                # a later store in this block must not clobber the slot
                for p2 in range(pc + 1, upto_pc):
                    i2 = insns[p2]
                    if is_store(i2.op) and self._overlaps_slot(p2, i2, off):
                        return None
                return ("stack", off)
            if insn.op in ("mov64i", "lddw") and insn.dst == reg:
                return ("const", u64(insn.imm))
            if insn.op == "mov64" and insn.dst == reg and not \
                    is_imm_form(insn.op):
                return self._trace_reg(block, pc, insn.src)
            return None
        return ("reg", reg)

    @staticmethod
    def _writes_reg(insn: Insn, reg: int) -> bool:
        op = insn.op
        if op in ("call", "call_fn"):
            return reg in (0, 1, 2, 3, 4, 5)
        if op in ("lddw", "ldmap") or is_load(op) or is_alu(op):
            return insn.dst == reg
        return False

    def _overlaps_slot(self, pc: int, insn: Insn, cell_off: int) -> bool:
        """Could this store touch [cell_off, cell_off+8)?  Unknown-offset
        stack stores conservatively overlap."""
        info = self.mem_info.get(pc)
        if info is None or info[0] != "stack":
            return False
        if info[2] is None:
            return True
        off = info[2] + insn.off
        return off < cell_off + 8 and cell_off < off + mem_size(insn.op)

    def _cell_steps(self, L: Loop, cell) -> Tuple[Optional[List[Tuple[int, int]]], str]:
        """All in-loop writes to the counter cell.  Returns (list of
        (block, step) increments, reason) — None list means disproven."""
        insns = self.insns
        incs: List[Tuple[int, int]] = []
        for b in sorted(L.body):
            for pc in self.cfg.block_insns(b):
                insn = insns[pc]
                if cell[0] == "reg":
                    if not self._writes_reg(insn, cell[1]):
                        continue
                    if insn.op == "add64i" and insn.dst == cell[1] \
                            and 0 < insn.imm:
                        incs.append((b, insn.imm))
                        continue
                    return None, (f"loop counter r{cell[1]} is modified at "
                                  f"insn {pc} by {insn.op!r} (only "
                                  "`add64i` with a positive constant is "
                                  "a provable step)")
                else:
                    if not is_store(insn.op):
                        continue
                    if not self._overlaps_slot(pc, insn, cell[1]):
                        continue
                    step = self._slot_increment(b, pc, cell[1])
                    if step is None:
                        return None, (f"loop counter slot fp{cell[1] - STACK_SIZE:+d} "
                                      f"is written at insn {pc} by something "
                                      "other than `counter += positive "
                                      "constant`")
                    incs.append((b, step))
        if not incs:
            kind = (f"r{cell[1]}" if cell[0] == "reg"
                    else f"slot fp{cell[1] - STACK_SIZE:+d}")
            return None, (f"the tested value ({kind}) is never advanced "
                          "inside the loop")
        return incs, ""

    def _slot_increment(self, block: int, store_pc: int,
                        cell_off: int) -> Optional[int]:
        """Match `ldxdw rX, [cell]; add64i rX, +c; stxdw [cell], rX`."""
        insns = self.insns
        insn = insns[store_pc]
        if insn.op != "stxdw":
            return None
        if self._const_stack_off(store_pc, insn) != cell_off:
            return None
        rx = insn.src
        start = self.cfg.ranges[block][0]
        step = None
        for pc in range(store_pc - 1, start - 1, -1):
            i2 = insns[pc]
            if i2.op == "add64i" and i2.dst == rx and step is None \
                    and 0 < i2.imm:
                step = i2.imm
                continue
            if i2.op == "ldxdw" and i2.dst == rx:
                if step is None:
                    return None
                if self._const_stack_off(pc, i2) != cell_off:
                    return None
                return step
            if self._writes_reg(i2, rx):
                return None
            if is_store(i2.op) and self._overlaps_slot(pc, i2, cell_off):
                return None
        return None

    def _cell_init(self, L: Loop, cell) -> Optional[int]:
        """Constant value of the counter cell on loop entry, if provable:
        the header has a single non-latch predecessor that dominates it,
        and that block's last write to the cell is a constant."""
        cfg = self.cfg
        entries = [p for p in cfg.preds[L.header] if p not in L.body]
        if len(entries) != 1 or not cfg.dominates(entries[0], L.header):
            return None
        p = entries[0]
        insns = self.insns
        s, e = cfg.ranges[p]
        for pc in range(e - 1, s - 1, -1):
            insn = insns[pc]
            if cell[0] == "reg":
                if self._writes_reg(insn, cell[1]):
                    if insn.op in ("mov64i", "lddw"):
                        return u64(insn.imm)
                    return None
            elif is_store(insn.op) and self._overlaps_slot(pc, insn,
                                                           cell[1]):
                if insn.op == "stxdw" \
                        and self._const_stack_off(pc, insn) == cell[1]:
                    src = self._trace_reg(p, pc, insn.src)
                    if src is not None and src[0] == "const":
                        return src[1]
                return None
        return None

    def _prove_one_loop(self, L: Loop, states
                        ) -> Tuple[Optional[int], str]:
        insns = self.insns
        cfg = self.cfg
        # a latch the fixpoint never reached cannot re-enter the header
        # (e.g. a body that returns on every path): the back edge is dead
        # code, so the loop is vacuously bounded
        latches = [lt for lt in L.latches
                   if cfg.leaders[lt] in states]
        if not latches:
            return 0, ""
        reasons: List[str] = []
        for b in sorted(L.body):
            pc = cfg.terminator_pc(b)
            insn = insns[pc]
            if not is_jump_cond(insn.op):
                continue
            taken, fall = cfg.succs[b]
            t_out, f_out = taken not in L.body, fall not in L.body
            if not (t_out ^ f_out):
                continue  # not a loop exit test
            base = jump_base(insn.op)
            # normalize to "continue while counter < / <= limit"
            if t_out and base in ("jge", "jgt"):
                strict = base == "jge"       # continue while counter <  K
            elif f_out and base in ("jlt", "jle"):
                strict = base == "jlt"
            elif base in self._SIGNED_TO_UNSIGNED:
                reasons.append(
                    f"exit test at insn {pc} uses signed {base!r}: a "
                    "counter holding a large-unsigned (negative-signed) "
                    "value orders differently under signed comparison, so "
                    "no unsigned monotone trip bound follows; compare "
                    "with unsigned jlt/jle (continue) or jge/jgt (exit) "
                    "instead")
                continue
            else:
                reasons.append(
                    f"exit test at insn {pc} uses {base!r}; only unsigned "
                    "jlt/jle (continue) or jge/jgt (exit) are provable")
                continue
            if not all(cfg.dominates(b, lt) for lt in latches):
                reasons.append(
                    f"exit test at insn {pc} is not executed on every "
                    "iteration")
                continue
            cell = self._trace_reg(b, pc, insn.dst, through_adds=True)
            if cell is None or cell[0] == "const":
                reasons.append(
                    f"exit test at insn {pc}: the tested value is not a "
                    "recognizable counter (stack slot or register)")
                continue
            # limit: immediate, traced constant, or interval-bounded reg
            if is_imm_form(insn.op):
                limit = u64(insn.imm)
            else:
                src = self._trace_reg(b, pc, insn.src)
                if src is not None and src[0] == "const":
                    limit = src[1]
                else:
                    branch_st = states.get(pc)
                    if branch_st is None:
                        reasons.append(
                            f"exit test at insn {pc} is unreachable, so "
                            "its limit register has no verified interval")
                        continue
                    lv = branch_st.regs[insn.src]
                    if lv.kind == SCALAR and lv.hi <= LOOP_FUEL_CAP:
                        limit = lv.hi
                    else:
                        reasons.append(
                            f"exit test at insn {pc}: limit register "
                            f"r{insn.src} has no finite verified upper "
                            f"bound (interval hi="
                            f"{'∞' if lv.kind != SCALAR else lv.hi})")
                        continue
            incs, why = self._cell_steps(L, cell)
            if incs is None:
                reasons.append(why)
                continue
            if not any(all(cfg.dominates(ib, lt) for lt in latches)
                       for ib, _ in incs):
                reasons.append(
                    "no counter increment lies on every path through the "
                    "loop (a conditional `i += c` cannot prove progress)")
                continue
            step = min(s for _, s in incs)
            # u64 wraparound guard: the ceil(span/step) formula assumes
            # the counter climbs monotonically toward the limit.  If one
            # iteration's advance can carry a passing counter across
            # 2**64, it re-enters from 0 below the limit and the formula
            # undercounts the trips — the tiers then disagree on how
            # many iterations actually run.  The largest passing value
            # is limit-1 under a strict test (continue while < limit)
            # but limit itself under a non-strict (<=) one — the exact
            # limit + advance == 2**64 case is an infinite loop.
            advance = sum(s for _, s in incs)
            max_pass = limit - 1 if strict else limit
            if limit > 0 and max_pass + advance > U64_MAX:
                reasons.append(
                    f"exit test at insn {pc}: the counter may wrap "
                    f"around 2**64 before the exit test fires (limit "
                    f"{limit} with per-iteration advance up to {advance}"
                    "); a limit this close to 2**64 — typically a "
                    "negative-signed constant — cannot be bounded")
                continue
            # constant entry value tightens the bound (an unsigned counter
            # of unknown start still bounds at ceil(limit/step): every
            # passing test reads a value < limit, consecutive passes are
            # >= step apart, and the guard above rules out wrapping back
            # under the limit).  A large-unsigned (negative-signed) entry
            # value may wrap before the FIRST test, so it gets the
            # unknown-start bound, not the (negative) span.
            init = self._cell_init(L, cell) or 0
            if init + advance > U64_MAX:
                init = 0
            span = limit - init
            if strict:
                bound = max(0, (span + step - 1) // step)
            else:
                bound = span // step + 1 if span >= 0 else 0
            return bound, ""
        return None, ("; ".join(reasons) if reasons
                      else "no exit test compares a counter against a "
                           "bounded limit")

    def _step_bound(self) -> int:
        """Dynamic-step upper bound for the interpreter's fuel check.
        ``call_fn`` sites add the callee's own bound (callees are
        analyzed first), scaled by the enclosing loop multiplier."""
        cfg = self.cfg
        total = 0
        for b in range(cfg.n):
            mult = 1
            h = cfg.loop_of_block.get(b)
            while h is not None:
                mult *= self.loop_bounds.get(h, 1) + 1
                h = cfg.loops[h].parent
            s, e = cfg.ranges[b]
            total += (e - s) * mult
            for pc in range(s, e):
                if self.insns[pc].op == "call_fn":
                    total += self.fns[1 + self.insns[pc].imm].max_steps * mult
            if total > (1 << 31):
                return 1 << 31
        return total + 16

    # -- single abstract step ------------------------------------------------
    def _step(self, pc: int, insn: Insn, st: AState):
        op = insn.op
        out = []
        if op == "exit":
            r0 = st.regs[0]
            if r0.kind == UNINIT:
                raise VerifierError("R0 is uninitialized at exit", pc)
            if r0.is_ptr:
                raise VerifierError(
                    f"R0 is a {r0.name()}; returning a pointer leaks memory", pc)
            return [(-1, st)]
        if op == "ja":
            return [(pc + 1 + insn.off, st)]
        if op == "lddw":
            self._no_fp_write(insn.dst, pc)
            return [(pc + 1, st.with_reg(insn.dst, AVal.const(insn.imm)))]
        if op == "ldmap":
            self._no_fp_write(insn.dst, pc)
            if insn.map_name not in self.map_decls:
                raise VerifierError(
                    f"reference to undeclared map '{insn.map_name}'", pc)
            return [(pc + 1, st.with_reg(
                insn.dst, AVal(MAPPTR, 0, 0, insn.map_name)))]
        if op == "call":
            return [(pc + 1, self._check_call(pc, insn.imm, st))]
        if op == "call_fn":
            return [(pc + 1, self._check_call_fn(pc, insn.imm, st))]
        if is_alu(op):
            return [(pc + 1, self._alu(pc, insn, st))]
        if is_jump_cond(op):
            return self._branch(pc, insn, st)
        if is_load(op):
            return [(pc + 1, self._load(pc, insn, st))]
        if is_store(op):
            return [(pc + 1, self._store(pc, insn, st))]
        raise VerifierError(f"unknown opcode {op!r}", pc)

    def _no_fp_write(self, dst: int, pc: int) -> None:
        if dst == FP_REG:
            raise VerifierError("write to frame pointer R10 is forbidden", pc)

    # -- ALU ------------------------------------------------------------------
    def _alu(self, pc: int, insn: Insn, st: AState) -> AState:
        self._no_fp_write(insn.dst, pc)
        width = alu_width(insn.op)
        base = alu_base(insn.op)
        a = st.regs[insn.dst]
        b = AVal.const(insn.imm) if is_imm_form(insn.op) else st.regs[insn.src]
        if base != "mov" and a.kind == UNINIT:
            raise VerifierError(f"R{insn.dst} is uninitialized", pc)
        if base == "mov" and b.kind == UNINIT:
            raise VerifierError(f"R{insn.src} is uninitialized", pc)
        if not is_imm_form(insn.op) and base not in ("mov", "neg") \
                and b.kind == UNINIT:
            raise VerifierError(f"R{insn.src} is uninitialized", pc)

        # pointer arithmetic
        if base == "mov":
            return st.with_reg(insn.dst, _ival_alu("mov", width, a, b, pc))
        if a.is_ptr or b.is_ptr:
            return st.with_reg(insn.dst, self._ptr_alu(pc, base, width, a, b))
        return st.with_reg(insn.dst, _ival_alu(base, width, a, b, pc))

    def _ptr_alu(self, pc: int, base: str, width: int, a: AVal, b: AVal) -> AVal:
        if width != 64:
            raise VerifierError("32-bit arithmetic on a pointer", pc)
        if a.kind == MAPVAL_OR_NULL or b.kind == MAPVAL_OR_NULL:
            raise VerifierError(
                "arithmetic on map_value_or_null pointer; "
                "must check != NULL first", pc)
        if base == "add" and a.is_ptr and b.kind == SCALAR:
            return AVal(a.kind, a.lo + s64(b.lo), a.hi + s64(b.hi), a.map_name)
        if base == "add" and b.is_ptr and a.kind == SCALAR:
            return AVal(b.kind, b.lo + s64(a.lo), b.hi + s64(a.hi), b.map_name)
        if base == "sub" and a.is_ptr and b.kind == SCALAR:
            return AVal(a.kind, a.lo - s64(b.hi), a.hi - s64(b.lo), a.map_name)
        if base == "sub" and a.is_ptr and b.is_ptr and a.kind == b.kind \
                and a.map_name == b.map_name:
            return AVal.scalar()
        raise VerifierError(f"illegal pointer arithmetic: {base} on "
                            f"{a.name()} and {b.name()}", pc)

    # -- branches with refinement ----------------------------------------------
    def _branch(self, pc: int, insn: Insn, st: AState):
        base = jump_base(insn.op)
        a = st.regs[insn.dst]
        b = AVal.const(insn.imm) if is_imm_form(insn.op) else st.regs[insn.src]
        if a.kind == UNINIT:
            raise VerifierError(f"R{insn.dst} is uninitialized in branch", pc)
        if not is_imm_form(insn.op) and b.kind == UNINIT:
            raise VerifierError(f"R{insn.src} is uninitialized in branch", pc)

        taken_tgt = pc + 1 + insn.off
        fall_tgt = pc + 1

        # NULL-check refinement for map_value_or_null (id 0 = tainted by a
        # back edge: the check still branches, but refines nothing)
        if a.kind == MAPVAL_OR_NULL and a.null_id and base in ("jeq", "jne") \
                and b.is_const and b.lo == 0:
            null_st = self._refine_null(st, a.null_id, to_null=True)
            ok_st = self._refine_null(st, a.null_id, to_null=False)
            if base == "jeq":   # taken => null
                return [(taken_tgt, null_st), (fall_tgt, ok_st)]
            return [(taken_tgt, ok_st), (fall_tgt, null_st)]

        if a.is_ptr and base not in ("jeq", "jne"):
            raise VerifierError(
                f"ordered comparison on {a.name()} is not allowed", pc)
        if b.is_ptr and not a.is_ptr:
            raise VerifierError(
                f"comparison of scalar with {b.name()}", pc)

        # scalar interval refinement (imm comparisons only, unsigned)
        if a.kind == SCALAR and b.kind == SCALAR and b.is_const and not a.is_ptr:
            k = b.lo
            t, f = self._refine_scalar(a, base, k)
            states = []
            if t is not None:
                states.append((taken_tgt, st.with_reg(insn.dst, t)))
            if f is not None:
                states.append((fall_tgt, st.with_reg(insn.dst, f)))
            if not states:
                raise VerifierError("branch with empty feasible set", pc)
            return states
        return [(taken_tgt, st), (fall_tgt, st)]

    _SIGNED_TO_UNSIGNED = {"jsgt": "jgt", "jsge": "jge",
                           "jslt": "jlt", "jsle": "jle"}

    @classmethod
    def _refine_scalar(cls, a: AVal, base: str, k: int):
        """Return (taken_val, fall_val); None = infeasible edge (pruned)."""
        lo, hi = a.lo, a.hi

        if base in cls._SIGNED_TO_UNSIGNED:
            # Signed refinement is sound only when the interval sits
            # entirely within one signed half-plane: there signed order
            # agrees with unsigned order on the raw u64 encodings.  An
            # interval spanning the sign boundary is non-convex under
            # signed order, so it must not be refined (treating a
            # large-unsigned value as if the unsigned bound applied is
            # exactly the wrong-trip-bound bug class).
            half = 1 << 63
            if not (hi < half or lo >= half):
                return (a, a)
            a_neg, k_neg = lo >= half, k >= half
            if a_neg != k_neg:
                # different signed halves: the comparison is statically
                # decided (negative < non-negative), so one edge prunes
                a_lt_k = a_neg
                taken = a_lt_k if base in ("jslt", "jsle") \
                    else not a_lt_k
                return (a, None) if taken else (None, a)
            base = cls._SIGNED_TO_UNSIGNED[base]
            # same half: fall through to the unsigned refinement below

        def iv(l, h):
            return None if l > h else AVal(SCALAR, l, h)

        def without_k():
            """a with endpoint k trimmed (interval can't exclude interior)."""
            if lo == hi == k:
                return None
            if k == lo:
                return iv(lo + 1, hi)
            if k == hi:
                return iv(lo, hi - 1)
            return a

        if base == "jeq":
            return (iv(max(lo, k), min(hi, k)), without_k())
        if base == "jne":
            return (without_k(), iv(max(lo, k), min(hi, k)))
        if base == "jgt":
            return (iv(max(lo, k + 1), hi), iv(lo, min(hi, k)))
        if base == "jge":
            return (iv(max(lo, k), hi), iv(lo, min(hi, k - 1)))
        if base == "jlt":
            return (iv(lo, min(hi, k - 1)), iv(max(lo, k), hi))
        if base == "jle":
            return (iv(lo, min(hi, k)), iv(max(lo, k + 1), hi))
        # jset: no refinement
        return (a, a)

    @staticmethod
    def _refine_null(st: AState, null_id: int, *, to_null: bool) -> AState:
        regs = []
        for v in st.regs:
            if v.kind == MAPVAL_OR_NULL and v.null_id == null_id:
                regs.append(AVal.const(0) if to_null
                            else AVal(MAPVAL, 0, 0, v.map_name))
            else:
                regs.append(v)
        return AState(tuple(regs), st.stack_init)

    # -- memory -------------------------------------------------------------
    def _record_mem(self, pc: int, v: AVal) -> None:
        prev = self.mem_info.get(pc)
        cur = (v.kind, v.map_name, v.lo if v.lo == v.hi else None)
        if prev is None or prev == cur:
            self.mem_info[pc] = cur
        elif prev[0] == cur[0] and prev[1] == cur[1]:
            # loop re-analysis can revisit a pc with a widened offset: the
            # region is still unique, but the offset is only static if
            # every visit agrees (the JIT/jaxc key codegen off this)
            self.mem_info[pc] = (cur[0], cur[1],
                                 cur[2] if prev[2] == cur[2] else None)
        # differing region kinds cannot survive to acceptance: the joined
        # state degrades to uninit and _mem_region rejects it

    def _record_stack_arg(self, pc: int, argi: int, v: AVal) -> None:
        """The frame offset of a helper's stack-pointer argument, joined
        over every visit as :meth:`_record_mem` joins a load's."""
        cur = v.lo if v.lo == v.hi else None
        prev = self.stack_args.get((pc, argi), cur)
        self.stack_args[(pc, argi)] = cur if prev == cur else None

    def _mem_region(self, pc: int, reg_idx: int, v: AVal, off: int, size: int,
                    *, is_write: bool) -> None:
        if v.kind == UNINIT:
            raise VerifierError(f"R{reg_idx} is uninitialized", pc)
        if v.kind == SCALAR:
            if v.is_const and v.lo == 0:
                raise VerifierError(
                    f"R{reg_idx} is NULL; null-pointer dereference", pc)
            raise VerifierError(
                f"R{reg_idx} is a scalar; memory access needs a pointer", pc)
        if v.kind == MAPVAL_OR_NULL:
            raise VerifierError(
                f"R{reg_idx} is a pointer to map_value_or_null; "
                "must check != NULL before dereference", pc)
        if v.kind == MAPPTR:
            raise VerifierError(
                f"R{reg_idx} is a raw map pointer; direct access is forbidden "
                "(use map_lookup_elem)", pc)

        lo, hi = v.lo + off, v.hi + off
        if v.kind == CTX:
            if lo != hi:
                raise VerifierError("variable-offset ctx access", pc)
            try:
                field = self.ctx.field_at(lo, size)
            except KeyError:
                raise VerifierError(
                    f"out-of-bounds ctx access: offset {lo} size {size} "
                    f"(ctx '{self.ctx.name}' is {self.ctx.size} bytes)", pc)
            if is_write and not field.writable:
                raise VerifierError(
                    f"write to read-only input field '{field.name}' "
                    f"of {self.ctx.name}", pc)
        elif v.kind == STACK:
            if lo < 0 or hi + size > STACK_SIZE:
                raise VerifierError(
                    f"stack access out of bounds: [{lo - STACK_SIZE},"
                    f"{hi + size - STACK_SIZE}) exceeds the 512-byte frame "
                    "(stack overflow)", pc)
            if lo < self._min_stack:
                self._min_stack = lo    # per-function depth accounting
        elif v.kind == MAPVAL:
            vs = self.map_decls[v.map_name].value_size
            if lo < 0 or hi + size > vs:
                raise VerifierError(
                    f"out-of-bounds map value access: offset {lo}..{hi}+{size} "
                    f"exceeds value_size {vs} of map '{v.map_name}'", pc)
        else:
            raise VerifierError(f"R{reg_idx} ({v.name()}) is not accessible", pc)

    def _load(self, pc: int, insn: Insn, st: AState) -> AState:
        self._no_fp_write(insn.dst, pc)
        v = st.regs[insn.src]
        size = mem_size(insn.op)
        self._mem_region(pc, insn.src, v, insn.off, size, is_write=False)
        self._record_mem(pc, v)
        if v.kind == STACK:
            lo, hi = v.lo + insn.off, v.hi + insn.off
            for byte in range(lo, hi + size):
                if not (st.stack_init >> byte) & 1:
                    raise VerifierError(
                        f"read of uninitialized stack byte fp{byte - STACK_SIZE:+d}", pc)
        maxv = (1 << (8 * size)) - 1
        return st.with_reg(insn.dst, AVal(SCALAR, 0, maxv))

    def _store(self, pc: int, insn: Insn, st: AState) -> AState:
        v = st.regs[insn.dst]
        size = mem_size(insn.op)
        is_stx = insn.op.startswith("stx")
        if is_stx:
            sv = st.regs[insn.src]
            if sv.kind == UNINIT:
                raise VerifierError(f"R{insn.src} is uninitialized", pc)
            if sv.is_ptr and not (v.kind == STACK and size == 8):
                raise VerifierError(
                    f"pointer spill of {sv.name()} outside stack", pc)
            if sv.is_ptr:
                raise VerifierError(
                    "pointer spill to stack is not supported by this verifier "
                    "(keep pointers in registers)", pc)
        self._mem_region(pc, insn.dst, v, insn.off, size, is_write=True)
        self._record_mem(pc, v)
        if v.kind == STACK and v.lo == v.hi:
            lo = v.lo + insn.off
            mask = ((1 << size) - 1) << lo
            return AState(st.regs, st.stack_init | mask)
        return st

    # -- helper calls ----------------------------------------------------------
    def _check_call(self, pc: int, hid: int, st: AState) -> AState:
        h = H.HELPERS.get(hid)
        if h is None:
            raise VerifierError(f"unknown helper id {hid}", pc)
        if not H.helper_allowed(self.prog.section, hid):
            raise VerifierError(
                f"illegal helper '{h.name}' for section '{self.prog.section}'", pc)

        map_decl: Optional[MapDecl] = None
        for argi, argt in enumerate(h.args, start=1):
            v = st.regs[argi]
            if argt == H.ARG_MAP_PTR:
                if v.kind != MAPPTR:
                    raise VerifierError(
                        f"{h.name}: R{argi} must be a map pointer, got {v.name()}", pc)
                map_decl = self.map_decls[v.map_name]
                # helper x map-kind contract: the keyed surface never
                # runs on a ringbuf, the reserve/submit surface runs
                # only on one
                kinds = H.HELPER_MAP_KINDS.get(hid)
                if kinds is not None and map_decl.kind not in kinds:
                    raise VerifierError(
                        f"{h.name}: map '{map_decl.name}' has kind "
                        f"'{map_decl.kind}', not one of "
                        f"{sorted(kinds)}", pc)
            elif argt in (H.ARG_STACK_KEY, H.ARG_STACK_VALUE):
                need = (map_decl.key_size if argt == H.ARG_STACK_KEY
                        else map_decl.value_size) if map_decl else 8
                if v.kind == MAPVAL and argt == H.ARG_STACK_VALUE:
                    self._mem_region(pc, argi, v, 0, need, is_write=False)
                    continue
                if v.kind != STACK:
                    raise VerifierError(
                        f"{h.name}: R{argi} must point to the stack, got {v.name()}", pc)
                self._mem_region(pc, argi, v, 0, need, is_write=False)
                self._record_stack_arg(pc, argi, v)
                for byte in range(v.lo, v.hi + need):
                    if not (st.stack_init >> byte) & 1:
                        raise VerifierError(
                            f"{h.name}: R{argi} buffer byte fp{byte - STACK_SIZE:+d} "
                            "is uninitialized", pc)
            elif argt == H.ARG_SCALAR:
                if v.kind != SCALAR:
                    raise VerifierError(
                        f"{h.name}: R{argi} must be a scalar, got {v.name()}", pc)
            # ARG_ANYTHING: no check

        self.call_map[pc] = map_decl.name if map_decl else None
        regs = list(st.regs)
        if h.ret == H.RET_MAP_VALUE_OR_NULL:
            regs[0] = AVal(MAPVAL_OR_NULL, 0, 0, map_decl.name, next(_null_ids))
        else:
            regs[0] = AVal.scalar()
        for r in (1, 2, 3, 4, 5):
            regs[r] = AVal(UNINIT)
        return AState(tuple(regs), st.stack_init)

    # -- bpf-to-bpf calls ------------------------------------------------------
    def _check_call_fn(self, pc: int, idx: int, st: AState) -> AState:
        """Interval/region transfer across a call boundary: scalar args
        only (the callee gets a fresh frame, so caller pointers would
        dangle), r0 takes the callee's joined return interval, r1..r5
        are clobbered, r6..r9 and the caller stack survive untouched."""
        if not (0 <= idx < len(self.prog.subprogs)):
            raise VerifierError(f"call_fn fn{idx} out of range", pc)
        callee = self.fns[1 + idx]
        for argi in range(1, callee.n_args + 1):
            v = st.regs[argi]
            if v.kind == UNINIT:
                raise VerifierError(
                    f"call to '{callee.name}': argument R{argi} is "
                    "uninitialized", pc)
            if v.is_ptr:
                raise VerifierError(
                    f"call to '{callee.name}': R{argi} is a {v.name()}; "
                    "bpf-to-bpf calls take scalar arguments only (the "
                    "callee's frame is fresh — pass offsets, keys, or "
                    "loaded values as integers)", pc)
        regs = list(st.regs)
        regs[0] = AVal(SCALAR, callee.ret_lo, callee.ret_hi)
        for r in (1, 2, 3, 4, 5):
            regs[r] = AVal(UNINIT)
        return AState(tuple(regs), st.stack_init)


def verify(program: Program) -> None:
    """Raise :class:`VerifierError` if the program is unsafe."""
    Verifier(program).verify()


def verify_with_info(program: Program) -> Verifier:
    """Verify and return the Verifier with per-insn region info (for jaxc)."""
    v = Verifier(program)
    v.verify()
    return v
