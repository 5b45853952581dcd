"""Shared control-flow-graph analysis for repro policy bytecode.

One CFG layer serves all four execution tiers:

* the **verifier** classifies back edges (natural vs irreducible) and walks
  natural loops to prove trip bounds,
* the **host JIT** (v2 structured codegen) reconstructs nested ``if``/
  ``else``/``while`` regions from the post-dominator tree,
* **jaxc** lowers each natural loop to one ``lax.fori_loop`` over the
  loop's block set,
* the **interpreter** needs nothing from here at runtime, but the
  verifier-derived step bound that feeds its fuel check is computed from
  this loop nest.

Before this module existed each tier re-derived block structure privately
(the verifier scanned jumps, the JIT had its own ``_Blocks``/post-dominator
tree, jaxc leaned on pc ordering).  Loops made that untenable: back-edge
classification, loop membership and the forward (acyclic) view must agree
everywhere, or the tiers diverge on exactly the programs where divergence
is dangerous.

Graph model
-----------
Basic blocks are maximal straight-line instruction runs; block indices are
ordered by start pc.  ``succs`` holds *real* successors (``EXIT`` = -1 for
``exit``).  A **back edge** is an edge to a block that does not start at a
higher pc (a retreating edge in the linear layout).  A back edge whose
target dominates its source closes a **natural loop**; any other
retreating edge is **irreducible** control flow, which no tier supports
(the verifier rejects it).  Because every accepted non-back edge strictly
increases the start pc, block-index order is a topological order of the
forward CFG — tiers exploit this for single-pass processing.

Post-dominators are computed on the forward CFG (back edges removed); a
latch whose only successor is its back edge post-dominates to ``EXIT``,
mirroring how ``continue`` ends an iteration the way ``return`` ends a
call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .isa import Insn, is_jump_cond

EXIT = -1  # virtual exit node (block index)


def leaders(insns: List[Insn]) -> List[int]:
    """Start pcs of basic blocks (jump targets, fall-throughs, entry)."""
    out = {0}
    for pc, insn in enumerate(insns):
        if insn.op == "ja" or is_jump_cond(insn.op):
            out.add(pc + 1 + insn.off)
            out.add(pc + 1)
        if insn.op == "exit" and pc + 1 < len(insns):
            out.add(pc + 1)
    return sorted(x for x in out if 0 <= x < len(insns))


@dataclasses.dataclass(frozen=True)
class Loop:
    """One natural loop: all back edges sharing a header, merged."""
    header: int                                # block index
    body: frozenset                            # block indices (incl. header)
    latches: Tuple[int, ...]                   # blocks with an edge to header
    back_edge_pcs: Tuple[int, ...]             # pc of each back-edge jump
    exit_edges: Tuple[Tuple[int, int], ...]    # (src in body, tgt outside)
    parent: Optional[int] = None               # header of enclosing loop

    @property
    def exit_targets(self) -> Tuple[int, ...]:
        return tuple(sorted({t for _, t in self.exit_edges}))


class IrreducibleError(Exception):
    """A retreating edge whose target does not dominate its source."""

    def __init__(self, pc: int, src_block: int, tgt_block: int):
        self.pc = pc
        self.src_block = src_block
        self.tgt_block = tgt_block
        super().__init__(
            f"irreducible control flow: retreating edge at insn {pc} does "
            "not close a natural loop")


class CFG:
    """Basic blocks + dominators + post-dominators + natural loop nest."""

    EXIT = EXIT

    def __init__(self, insns: List[Insn]):
        self.insns = insns
        self.leaders = leaders(insns)
        self.block_of: Dict[int, int] = {pc: i for i, pc in
                                         enumerate(self.leaders)}
        self.n = len(self.leaders)
        self.ranges: List[Tuple[int, int]] = []
        self.succs: List[List[int]] = []
        for bi, start in enumerate(self.leaders):
            end = self.leaders[bi + 1] if bi + 1 < self.n else len(insns)
            self.ranges.append((start, end))
            last = insns[end - 1]
            if last.op == "exit":
                self.succs.append([EXIT])
            elif last.op == "ja":
                self.succs.append([self._tgt(end - 1, last)])
            elif is_jump_cond(last.op):
                self.succs.append([self._tgt(end - 1, last), bi + 1])
            else:
                self.succs.append([bi + 1 if bi + 1 < self.n else EXIT])
        self.preds: List[List[int]] = [[] for _ in range(self.n)]
        for b, ss in enumerate(self.succs):
            for s in ss:
                if s != EXIT:
                    self.preds[s].append(b)

        # retreating edges: target block starts no later than the source
        self.back_edges: List[Tuple[int, int]] = [
            (u, v) for u, ss in enumerate(self.succs)
            for v in ss if v != EXIT and v <= u]
        self.fwd_succs: List[List[int]] = [
            [s for s in ss if s == EXIT or s > u]
            for u, ss in enumerate(self.succs)]

        self._build_doms()
        self._build_loops()        # may raise IrreducibleError
        self._build_pdom()

    # ---- helpers ----------------------------------------------------------
    def _tgt(self, pc: int, insn: Insn) -> int:
        t = pc + 1 + insn.off
        # a (necessarily unreachable) jump may target one-past-the-end;
        # route it to the virtual exit so the trees stay well formed
        return self.block_of.get(t, EXIT)

    def block_insns(self, b: int) -> range:
        s, e = self.ranges[b]
        return range(s, e)

    def terminator_pc(self, b: int) -> int:
        return self.ranges[b][1] - 1

    # ---- dominators (full CFG, iterative bitset) -------------------------
    def _build_doms(self) -> None:
        full = (1 << self.n) - 1
        dom = [full] * self.n
        dom[0] = 1
        changed = True
        while changed:
            changed = False
            for b in range(1, self.n):
                ps = [dom[p] for p in self.preds[b]]
                if not ps:
                    continue  # unreachable: keep the full set (vacuous
                    # domination), so a dead latch still closes its
                    # natural loop instead of reading as irreducible
                new = ps[0]
                for m in ps[1:]:
                    new &= m
                new |= (1 << b)
                if new != dom[b]:
                    dom[b] = new
                    changed = True
        self._dom_bits = dom

    def dominates(self, a: int, b: int) -> bool:
        """True iff block ``a`` dominates block ``b``."""
        return bool((self._dom_bits[b] >> a) & 1)

    # ---- natural loops ----------------------------------------------------
    def _build_loops(self) -> None:
        by_header: Dict[int, Dict[str, list]] = {}
        for u, v in self.back_edges:
            pc = self.terminator_pc(u)
            if not self.dominates(v, u):
                raise IrreducibleError(pc, u, v)
            rec = by_header.setdefault(v, {"latches": [], "pcs": [],
                                           "body": {v}})
            rec["latches"].append(u)
            rec["pcs"].append(pc)
            # classic natural-loop walk: everything reaching the latch
            # without passing the header
            work = [u]
            body = rec["body"]
            while work:
                b = work.pop()
                if b in body:
                    continue
                body.add(b)
                work.extend(p for p in self.preds[b] if p not in body)

        self.loops: Dict[int, Loop] = {}
        for h, rec in by_header.items():
            body = frozenset(rec["body"])
            exit_edges = tuple(sorted(
                (b, s) for b in body for s in self.succs[b]
                if s != EXIT and s not in body))
            self.loops[h] = Loop(
                header=h, body=body, latches=tuple(sorted(rec["latches"])),
                back_edge_pcs=tuple(sorted(rec["pcs"])),
                exit_edges=exit_edges)

        # innermost-loop map + loop nesting (smallest containing body wins)
        by_size = sorted(self.loops.values(), key=lambda L: len(L.body))
        self.loop_of_block: Dict[int, int] = {}
        for L in reversed(by_size):            # larger first, smaller wins
            for b in L.body:
                self.loop_of_block[b] = L.header
        for L in by_size:
            parent = None
            for other in by_size:
                if other.header != L.header and L.body < other.body:
                    parent = other.header
                    break                      # smallest strict superset
            if parent is not None:
                self.loops[L.header] = dataclasses.replace(L, parent=parent)

    @property
    def has_loops(self) -> bool:
        return bool(self.loops)

    def inner_loops(self, L: Loop) -> List[Loop]:
        """Loops nested directly inside ``L``."""
        return [M for M in self.loops.values() if M.parent == L.header]

    def loop_depth(self, b: int) -> int:
        d = 0
        h = self.loop_of_block.get(b)
        while h is not None:
            d += 1
            h = self.loops[h].parent
        return d

    # ---- post-dominators on the forward CFG ------------------------------
    def _build_pdom(self) -> None:
        self.ipdom: Dict[int, int] = {EXIT: EXIT}
        self.pdom_depth: Dict[int, int] = {EXIT: 0}
        for b in range(self.n - 1, -1, -1):
            ss = [s if s == EXIT or s < self.n else EXIT
                  for s in self.fwd_succs[b]]
            if not ss:
                # back-edge-only latch: an iteration's `continue` ends the
                # path the way `return` does
                ss = [EXIT]
            d = ss[0]
            for s in ss[1:]:
                d = self.ncpd(d, s)
            self.ipdom[b] = d
            self.pdom_depth[b] = self.pdom_depth[d] + 1

    def ncpd(self, a: int, b: int) -> int:
        """Nearest common post-dominator (forward CFG) of two nodes."""
        while a != b:
            if self.pdom_depth[a] < self.pdom_depth[b]:
                b = self.ipdom[b]
            else:
                a = self.ipdom[a]
        return a


# ---- multi-function programs ----------------------------------------------
# ``call_fn`` is a plain non-terminator (control always returns to the
# next insn), so a bpf-to-bpf program is a *forest* of single-entry CFGs
# — one per function — and the inter-function structure (call graph,
# recursion/depth checks) lives in the verifier, not here.

def program_cfgs(prog) -> List[CFG]:
    """One CFG per function of a Program: index 0 is main, index
    ``1 + i`` is ``prog.subprogs[i]`` (i.e. ``call_fn`` operand + 1)."""
    out = [CFG(list(prog.insns))]
    out.extend(CFG(list(sp.insns)) for sp in getattr(prog, "subprogs", ()))
    return out


def call_sites(insns: List[Insn]) -> List[Tuple[int, int]]:
    """(pc, subprog index) of every ``call_fn`` in one function body."""
    return [(pc, insn.imm) for pc, insn in enumerate(insns)
            if insn.op == "call_fn"]
