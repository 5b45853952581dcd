"""One structured walk over the shared CFG, for every policy code generator.

The host JIT (:mod:`repro_torch.core.jit`, Python), the native tier
(:mod:`repro_torch.core.cc`, C) and the policy kernel
(:mod:`repro_torch.core.cudac`, CUDA C++) lower the same verified
program from the same analysis (:mod:`repro_torch.core.cfg`, the
verifier's facts).  The region walk over it lives here, once:
post-dominator nested ``if``/``else`` regions, natural loops as real
loops whose edges back to the innermost header or out to its single exit
become ``continue``/``break``.  A shape the walk does not model — a loop
with two exit targets, an edge to an outer loop's header or exit, a
duplication or nesting blowup — raises :class:`StructAbort`, and each
generator takes its own fallback.

A generator supplies its statements (``emit_body_insn``, ``_cond``,
``emit_exit``) and the syntax of its target through the hooks below;
everything a target writes differently stays in that target, so the
walk never changes a generated byte.  :class:`CEmitter` adds what the C
and CUDA generators share: their condition text and the label-per-block
``goto`` skeleton both fall back to.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .cfg import CFG
from .isa import Insn, is_imm_form, is_jump_cond, jump_base, s64

M64 = (1 << 64) - 1
S64_MIN = -(1 << 63)

UNSIGNED_CMP = {"jeq": "==", "jne": "!=", "jgt": ">", "jge": ">=",
                "jlt": "<", "jle": "<="}
SIGNED_CMP = {"jsgt": ">", "jsge": ">=", "jslt": "<", "jsle": "<="}
NEG = {"==": "!=", "!=": "==", ">": "<=", ">=": "<", "<": ">=", "<=": ">"}


class StructAbort(Exception):
    """Structured reconstruction exceeded its duplication/nesting budget
    or met a shape it does not model (multi-exit loop, cross-loop edge);
    the generator's fallback takes over."""


class StructuredEmitter:
    """The region walk.  Before :meth:`emit_structured` the generator
    sets ``insns`` (the function), ``blocks`` (its :class:`CFG`),
    ``lines`` and ``indent``.  The syntax hooks default to Python's."""

    # statement syntax of the target
    IF = "if {}:"
    ELSE = "else:"
    END: Optional[str] = None          # closes an if or a loop
    LOOP = "while True:"
    CONTINUE = "continue"
    BREAK = "break"

    insns: List[Insn]
    blocks: CFG
    lines: List[str]
    indent: int

    def w(self, line: str) -> None:
        self.lines.append("    " * self.indent + line)

    # ---- target hooks ----------------------------------------------------
    def emit_body_insn(self, pc: int, insn: Insn) -> None:
        raise NotImplementedError

    def _cond(self, insn: Insn) -> Tuple[str, str]:
        """(condition, negated condition) of a conditional jump."""
        raise NotImplementedError

    def emit_exit(self) -> None:
        raise NotImplementedError

    def _if_then(self, cond: str, stmt: str) -> None:
        """``if cond`` running the one statement ``stmt``."""
        self.w(self.IF.format(cond))
        self.indent += 1
        self.w(stmt)
        self.indent -= 1

    def _empty_suite(self) -> None:
        """What an arm or loop that emitted nothing holds."""
        self.w("pass")

    def _loop_head(self, h: int) -> None:
        """Open the loop whose header is block ``h``."""
        self.w(self.LOOP)

    # ---- the walk --------------------------------------------------------
    def _block_term(self, bi: int):
        """Emit a block's body; return its terminator descriptor."""
        start, end = self.blocks.ranges[bi]
        insns = self.insns
        last = insns[end - 1]
        body_end = end - 1 if (last.op in ("exit", "ja")
                               or is_jump_cond(last.op)) else end
        for pc in range(start, body_end):
            self.emit_body_insn(pc, insns[pc])
        if last.op == "exit":
            return ("exit",)
        if last.op == "ja":
            return ("ja", self.blocks.succs[bi][0])
        if is_jump_cond(last.op):
            cond, ncond = self._cond(last)
            t, f = self.blocks.succs[bi]
            return ("cond", cond, ncond, t, f)
        return ("fall", bi + 1)

    def emit_structured(self) -> None:
        self._budget = max(4 * self.blocks.n, 64)
        self._loops: List[Tuple[int, int]] = []    # (header, exit) stack
        self._chain(0, CFG.EXIT, 0)

    def _loop_ctl(self, b: int) -> Optional[str]:
        """``continue``/``break`` if b is the innermost loop's
        header/exit; abort on a cross-loop edge."""
        if not self._loops:
            return None
        h, ex = self._loops[-1]
        if b == h:
            return self.CONTINUE
        if b == ex:
            return self.BREAK
        for oh, oex in self._loops[:-1]:
            if b in (oh, oex):
                raise StructAbort  # multi-level break/continue
        return None

    def _suite(self, b: int, end: Optional[int], depth: int,
               entering: bool = False) -> None:
        self.indent += 1
        before = len(self.lines)
        self._chain(b, end, depth, entering)
        if len(self.lines) == before:
            self._empty_suite()
        self.indent -= 1

    def _enter_loop(self, b: int, depth: int) -> int:
        """Emit the loop and its interior; return the exit block."""
        targets = set(self.blocks.loops[b].exit_targets)
        if len(targets) != 1:
            raise StructAbort
        ex = targets.pop()
        self._loop_head(b)
        self._loops.append((b, ex))
        self._suite(b, None, depth + 1, entering=True)
        self._loops.pop()
        if self.END:
            self.w(self.END)
        return ex

    def _chain(self, b: int, end: Optional[int], depth: int,
               entering: bool = False) -> None:
        bl = self.blocks
        while b != end:
            if b == CFG.EXIT or depth > 40 or self.indent > 50:
                raise StructAbort
            self._budget -= 1
            if self._budget < 0:
                raise StructAbort
            if not entering:
                ctl = self._loop_ctl(b)
                if ctl is not None:
                    self.w(ctl)
                    return
                if b in bl.loops:
                    if any(h == b for h, _ in self._loops):
                        raise StructAbort  # re-entering an active loop
                    b = self._enter_loop(b, depth)
                    continue
            entering = False
            term = self._block_term(b)
            kind = term[0]
            if kind == "exit":
                self.emit_exit()
                return
            if kind in ("ja", "fall"):
                b = term[1]
                continue
            _, cond, ncond, t, f = term
            # conditional edges straight to the loop header/exit emit the
            # control statement inline — ncpd does not cross back edges
            t_ctl, f_ctl = self._loop_ctl(t), self._loop_ctl(f)
            if t_ctl or f_ctl:
                if t_ctl and f_ctl:
                    self._if_then(cond, t_ctl)
                    self.w(f_ctl)
                    return
                if t_ctl:
                    self._if_then(cond, t_ctl)
                    b = f
                else:
                    self._if_then(ncond, f_ctl)
                    b = t
                continue
            m = bl.ncpd(t, f)
            if t == m and f == m:
                b = m  # conditions are side-effect free: branch is a no-op
                continue
            if t == m:
                self.w(self.IF.format(ncond))
                self._suite(f, m, depth + 1)
            elif f == m:
                self.w(self.IF.format(cond))
                self._suite(t, m, depth + 1)
            else:
                self.w(self.IF.format(cond))
                self._suite(t, m, depth + 1)
                self.w(self.ELSE)
                self._suite(f, m, depth + 1)
            if self.END:
                self.w(self.END)
            if m == CFG.EXIT:
                return  # both arms returned
            b = m


def u64c(x: int) -> str:
    """An unsigned 64-bit constant as C."""
    return f"0x{x & M64:x}ULL"


def s64c(x: int) -> str:
    """A signed 64-bit constant as portable C."""
    v = s64(x & M64)
    if v == S64_MIN:
        return "(-9223372036854775807LL - 1)"
    return f"{v}LL" if v >= 0 else f"(-{-v}LL)"


class CEmitter(StructuredEmitter):
    """C statement syntax, C conditions, and the ``goto`` skeleton."""

    IF = "if ({}) {{"
    ELSE = "} else {"
    END = "}"
    LOOP = "while (1) {"
    CONTINUE = "continue;"
    BREAK = "break;"

    def _if_then(self, cond: str, stmt: str) -> None:
        self.w(f"if ({cond}) {{ {stmt} }}")

    def _empty_suite(self) -> None:
        pass

    def _cond(self, insn: Insn) -> Tuple[str, str]:
        base = jump_base(insn.op)
        a = f"r{insn.dst}"
        if base in SIGNED_CMP:
            b = s64c(insn.imm) if is_imm_form(insn.op) \
                else f"(long long)r{insn.src}"
            op = SIGNED_CMP[base]
            return (f"(long long){a} {op} {b}",
                    f"(long long){a} {NEG[op]} {b}")
        b = u64c(insn.imm) if is_imm_form(insn.op) else f"r{insn.src}"
        if base in UNSIGNED_CMP:
            op = UNSIGNED_CMP[base]
            return f"{a} {op} {b}", f"{a} {NEG[op]} {b}"
        return f"({a} & {b}) != 0", f"({a} & {b}) == 0"

    # ---- goto skeleton hooks ---------------------------------------------
    def _jump(self, src: int, tgt: int) -> str:
        """The statement that leaves block ``src`` for ``tgt``."""
        raise NotImplementedError

    def _if_jump(self, cond: str, jump: str) -> None:
        self._if_then(cond, jump)

    def _goto_block(self, bi: int) -> None:
        """Statements at the top of block ``bi``, after its label."""

    def emit_goto(self) -> None:
        """Label-per-block lowering.  C has real ``goto``, so the shapes
        the structured walk aborts on (multi-exit loops, cross-loop
        edges, duplication blowups) need no dispatcher here."""
        bl = self.blocks
        for bi in range(bl.n):
            self.lines.append(f"B{bi}: ;")
            self._goto_block(bi)
            term = self._block_term(bi)
            kind = term[0]
            if kind == "exit":
                self.emit_exit()
            elif kind in ("ja", "fall"):
                t = term[1] if kind == "ja" else bl.succs[bi][0]
                self.w(self._jump(bi, t))
            else:
                _, cond, _, t, f = term
                self._if_jump(cond, self._jump(bi, t))
                self.w(self._jump(bi, f))
