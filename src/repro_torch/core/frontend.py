"""bpfc — restricted-Python frontend compiled to repro bytecode.

The paper's policy authors write restricted C compiled to BPF ELF; our
authors write a restricted Python subset compiled to the same bytecode the
assembler produces.  The *verifier* remains the safety boundary — the
frontend is untrusted convenience, and the safety test suite includes
hand-assembled programs that bypass it entirely.

Supported subset (anything else -> CompileError):

* integer expressions: constants, locals, ctx fields, map-value slots
  ``st[i]``, ``+ - * // % & | ^ << >>``, comparisons, ``min``/``max``,
  ``not``/``and``/``or`` in conditions
* statements: assignment, augmented assignment, ``if``/``elif``/``else``,
  ``return <expr>``, ``for i in range(<const>)`` — trip counts up to 64
  are fully unrolled (``#pragma unroll`` style); larger constant bounds
  compile to real loop bytecode whose trip count the verifier *proves*
  (constant-stepped counter against a constant limit, per-loop fuel cap)
* map ops (only as statement / simple-assignment RHS):
  ``st = m.lookup(key)``; ``if st is None: ...``; ``st[i] = expr``;
  ``m.update(key, (v0, v1, ...))``; ``m.delete(key)``;
  ``ema_update(m, key, sample, weight)``
* ringbuf ops: ``e = rb.reserve()`` (NULL-checked like lookup);
  ``rb.submit()``; ``rb.discard()``
* helpers: ``ktime_get_ns()``, ``prandom_u32()``
* subroutines (bpf-to-bpf calls): ``def`` statements nested in the
  policy body, and module-level functions marked ``@subroutine``,
  compile into callee subprograms invoked via ``call_fn``.  Up to 5
  scalar parameters, one scalar return; callees get a fresh 512-byte
  frame and may use maps, but have no ctx (pass fields as arguments).
  Like map ops, calls appear only as statements or simple-assignment
  right-hand sides (``x = f(a, b)`` / ``return f(a)``)

Semantics note: all arithmetic/comparison is **unsigned 64-bit** (eBPF
default).  Names that resolve to integers in the function's globals are
inlined as constants.
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Dict, List, Optional, Tuple

from .helpers import HELPER_IDS
from .isa import Insn, STACK_SIZE
from .maps import MAP_KINDS
from .program import MapDecl, Program, SubProgram
from .verifier import LOOP_FUEL_CAP as _LOOP_FUEL_CAP

M64 = (1 << 64) - 1


class CompileError(Exception):
    pass


def map_decl(name: str, *, kind: str = "array", key_size: int = 4,
             value_size: int = 8, max_entries: int = 64,
             shared: bool = False, merge: tuple = ()) -> MapDecl:
    """Declare a map.  ``shared=True`` pins it into the registry's
    cross-plugin namespace at load time, so other programs (and host-side
    tooling) can reach the same state by name.

    ``merge`` names the per-value-slot shard-merge reduce used when the
    map is written on a multi-device mesh (core.shardmerge): ``"sum"``
    for counters (per-shard deltas add, wrapping u64), ``"max"`` for
    EMA/last-writer cells (the shard with the highest write cursor
    wins).  Shorter tuples pad with ``"sum"``."""
    if kind not in MAP_KINDS:
        raise CompileError(
            f"map {name!r}: unknown map kind {kind!r}; valid kinds: "
            f"{', '.join(sorted(MAP_KINDS))}")
    if kind not in ("hash", "lru_hash"):
        key_size = 4
    merge = tuple(merge)
    slots = max(1, value_size // 8)
    if len(merge) > slots:
        raise CompileError(
            f"map {name!r}: merge spec has {len(merge)} entries but the "
            f"value holds only {slots} u64 slot(s)")
    for mode in merge:
        if mode not in ("sum", "max"):
            raise CompileError(
                f"map {name!r}: unknown merge mode {mode!r}; "
                "use 'sum' (counter) or 'max' (max-version-wins)")
    return MapDecl(name, kind, key_size, value_size, max_entries, shared,
                   merge)


def subroutine(fn):
    """Mark a module-level function as a bpf-to-bpf callee.

    Any policy that calls it (directly or through another subroutine)
    compiles it into a :class:`SubProgram` invoked via ``call_fn`` —
    one shared verified body per program instead of duplicated inline
    bytecode.  Scalar params (max 5), scalar return, no ctx."""
    fn._bpf_subroutine = True
    return fn


_CMP_OPS = {
    ast.Eq: "jeq", ast.NotEq: "jne",
    ast.Gt: "jgt", ast.GtE: "jge", ast.Lt: "jlt", ast.LtE: "jle",
}
_BIN_OPS = {
    ast.Add: "add", ast.Sub: "sub", ast.Mult: "mul",
    ast.FloorDiv: "div", ast.Mod: "mod",
    ast.BitAnd: "and", ast.BitOr: "or", ast.BitXor: "xor",
    ast.LShift: "lsh", ast.RShift: "rsh",
}
_NEGATE = {"jeq": "jne", "jne": "jeq", "jgt": "jle", "jle": "jgt",
           "jge": "jlt", "jlt": "jge"}

_TEMP_REGS = [2, 3, 4, 5]
_PTR_REGS = [6, 7, 8, 9]
_MAX_UNROLL = 64


class _Label:
    __slots__ = ("id",)
    _next = [0]

    def __init__(self):
        self.id = _Label._next[0]
        _Label._next[0] += 1


class _Compiler(ast.NodeVisitor):
    def __init__(self, fn_ast: ast.FunctionDef, section: str,
                 maps: List[MapDecl], consts: Dict[str, int],
                 map_aliases: Dict[str, str] = None,
                 subprogs: Dict[str, Tuple[int, int]] = None,
                 params: Optional[List[str]] = None):
        from .context import CTX_TYPES
        self.section = section
        self.ctx_type = CTX_TYPES[section]
        self.maps = {d.name: d for d in maps}
        # python variable name -> declared map name (the decl's name and
        # the binding variable may differ)
        for var, mname in (map_aliases or {}).items():
            if mname in self.maps:
                self.maps.setdefault(var, self.maps[mname])
        self.consts = consts
        self.fn = fn_ast
        # subroutine name -> (subprog index, n_args)
        self.subprogs: Dict[str, Tuple[int, int]] = subprogs or {}

        self.insns: List[object] = []      # Insn | ("jmp", op, dst, src/imm, label)
        self.scalars: Dict[str, int] = {}  # local name -> stack offset (fp-rel)
        self._loop_slots: Dict[str, int] = {}  # counter slots kept for reuse
        self._active_loops: set = set()        # loop vars currently live
        self._call_parks: List[int] = []   # arg spill slots, reused per site
        self.ptrs: Dict[str, int] = {}     # local name -> callee-saved reg
        self.ptr_regs = list(_PTR_REGS)
        self.sp = 0                        # bytes of stack used (scratch grows down)
        self.ctx_reg: Optional[int] = None

        args = fn_ast.args.args
        if params is None:
            if len(args) != 1:
                raise CompileError("policy must take exactly one argument (ctx)")
            self.ctx_name: Optional[str] = args[0].arg
            self.params: Optional[List[str]] = None
        else:
            # subprogram mode: scalar params arrive in r1..rN, no ctx
            self.ctx_name = None
            self.params = list(params)

    # ---- low-level emission -------------------------------------------------
    def emit(self, op: str, dst: int = 0, src: int = 0, off: int = 0,
             imm: int = 0, map_name: Optional[str] = None) -> None:
        self.insns.append(Insn(op, dst=dst, src=src, off=off, imm=imm,
                               map_name=map_name))

    def emit_jmp(self, op: str, dst: int, other, label: _Label,
                 imm_form: bool) -> None:
        self.insns.append(("jmp", op + ("i" if imm_form else ""), dst, other, label))

    def emit_ja(self, label: _Label) -> None:
        self.insns.append(("jmp", "ja", 0, 0, label))

    def place(self, label: _Label) -> None:
        self.insns.append(("label", label))

    def alloc_stack(self, size: int = 8) -> int:
        self.sp += (size + 7) & ~7
        if self.sp > STACK_SIZE:
            raise CompileError("policy uses more than 512 bytes of stack")
        return STACK_SIZE - self.sp  # absolute offset from stack base

    # ---- ctx preservation -----------------------------------------------------
    def _ctx_setup(self) -> None:
        # keep ctx pointer in a callee-saved register (r1 is clobbered by calls)
        self.ctx_reg = self.ptr_regs.pop()
        self.emit("mov64", dst=self.ctx_reg, src=1)

    def _args_setup(self) -> None:
        # subprogram prologue: spill the scalar args r1..rN to stack
        # slots so the body's temp registers (r2-r5) stay free
        for i, name in enumerate(self.params, start=1):
            slot = self.alloc_stack(8)
            self.scalars[name] = slot
            self.emit("stxdw", dst=10, src=i, off=slot - STACK_SIZE)

    # ---- expression compilation ----------------------------------------------
    def eval_expr(self, node: ast.AST, dst: int, temps: List[int]) -> None:
        """Generate code leaving the u64 value of ``node`` in register ``dst``.

        ``temps`` is the pool of still-free scratch registers (excludes dst).
        """
        if isinstance(node, ast.Constant):
            if not isinstance(node.value, (int, bool)):
                raise CompileError(f"unsupported constant {node.value!r}")
            self._load_const(dst, int(node.value))
            return
        if isinstance(node, ast.Name):
            name = node.id
            if name in self.scalars:
                self.emit("ldxdw", dst=dst, src=10,
                          off=self.scalars[name] - STACK_SIZE)
                return
            if name in self.ptrs:
                raise CompileError(
                    f"map-value pointer '{name}' used as a number; "
                    "index it like st[0]")
            if name in self.consts:
                self._load_const(dst, self.consts[name])
                return
            raise CompileError(f"unknown name {name!r}")
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == self.ctx_name:
                f = self._ctx_field(node.attr)
                self.emit("ldxdw", dst=dst, src=self.ctx_reg, off=f.offset)
                return
            if self.ctx_name is None:
                raise CompileError(
                    "subroutines have no ctx; pass the fields you need "
                    "as scalar arguments from the caller")
            raise CompileError("only ctx.<field> attribute access is supported")
        if isinstance(node, ast.Subscript):
            base = node.value
            if isinstance(base, ast.Name) and base.id in self.ptrs:
                idx = self._const_value(node.slice)
                self.emit("ldxdw", dst=dst, src=self.ptrs[base.id], off=8 * idx)
                return
            raise CompileError("subscript only on map-value pointers")
        if isinstance(node, ast.BinOp):
            op = _BIN_OPS.get(type(node.op))
            if op is None:
                raise CompileError(f"unsupported operator {node.op}")
            self.eval_expr(node.left, dst, temps)
            rc = self._const_of(node.right)
            if rc is not None and -(1 << 31) <= rc < (1 << 31):
                self.emit(f"{op}64i", dst=dst, imm=rc)
                return
            if not temps:
                raise CompileError("expression too deep; split it into locals")
            t = temps[0]
            self.eval_expr(node.right, t, temps[1:])
            self.emit(f"{op}64", dst=dst, src=t)
            return
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                self.eval_expr(node.operand, dst, temps)
                self.emit("neg64", dst=dst)
                return
            if isinstance(node.op, ast.Invert):
                self.eval_expr(node.operand, dst, temps)
                self.emit("xor64i", dst=dst, imm=-1)
                return
            raise CompileError(f"unsupported unary op {node.op}")
        if isinstance(node, ast.Call):
            self._eval_call_expr(node, dst, temps)
            return
        if isinstance(node, ast.Compare):
            # materialize a boolean 0/1
            true_l, end_l = _Label(), _Label()
            self.compile_cond(node, true_l, negate=False)
            self._load_const(dst, 0)
            self.emit_ja(end_l)
            self.place(true_l)
            self._load_const(dst, 1)
            self.place(end_l)
            return
        if isinstance(node, ast.IfExp):
            true_l, end_l = _Label(), _Label()
            self.compile_cond(node.test, true_l, negate=False)
            self.eval_expr(node.orelse, dst, temps)
            self.emit_ja(end_l)
            self.place(true_l)
            self.eval_expr(node.body, dst, temps)
            self.place(end_l)
            return
        raise CompileError(f"unsupported expression: {ast.dump(node)[:80]}")

    def _eval_call_expr(self, node: ast.Call, dst: int, temps: List[int]) -> None:
        fname = node.func.id if isinstance(node.func, ast.Name) else None
        if fname in ("min", "max"):
            if len(node.args) != 2:
                raise CompileError(f"{fname} takes exactly 2 args")
            if not temps:
                raise CompileError("expression too deep; split it into locals")
            t = temps[0]
            self.eval_expr(node.args[0], dst, temps[1:])
            self.eval_expr(node.args[1], t, temps[1:])
            skip = _Label()
            op = "jle" if fname == "min" else "jge"
            self.emit_jmp(op, dst, t, skip, imm_form=False)
            self.emit("mov64", dst=dst, src=t)
            self.place(skip)
            return
        if fname == "ktime_get_ns":
            self.emit("call", imm=HELPER_IDS["ktime_get_ns"])
            if dst != 0:
                self.emit("mov64", dst=dst, src=0)
            return
        if fname == "prandom_u32":
            self.emit("call", imm=HELPER_IDS["get_prandom_u32"])
            if dst != 0:
                self.emit("mov64", dst=dst, src=0)
            return
        if fname in self.subprogs:
            raise CompileError(
                f"subroutine call {fname}() must be a statement or a "
                "simple-assignment right-hand side (`x = f(...)`); split "
                "the enclosing expression into locals")
        raise CompileError(
            f"call to {fname!r} not allowed here (map ops must be statements "
            "or simple-assignment right-hand sides)")

    # ---- bpf-to-bpf calls ------------------------------------------------------
    def _is_subcall(self, node: ast.AST) -> bool:
        return (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in self.subprogs)

    def _park_slot(self, i: int) -> int:
        # arg spill slots are reused across call sites: each call parks
        # its args, then immediately loads them into r1..rN
        while len(self._call_parks) <= i:
            self._call_parks.append(self.alloc_stack(8))
        return self._call_parks[i]

    def _emit_subcall(self, node: ast.Call) -> None:
        """Compile ``f(a, b)`` against a known subroutine: park each
        argument on the stack, load the parks into r1..rN, emit
        ``call_fn``.  The result lands in r0 (r1-r5 are clobbered), so
        callers must consume r0 immediately."""
        fname = node.func.id
        idx, n_args = self.subprogs[fname]
        if node.keywords or len(node.args) != n_args:
            raise CompileError(
                f"subroutine {fname}() takes {n_args} positional "
                f"argument(s); got {len(node.args)}"
                + (" plus keywords" if node.keywords else ""))
        for k, a in enumerate(node.args):
            off = self._park_slot(k)
            self.eval_expr(a, _TEMP_REGS[0], _TEMP_REGS[1:])
            self.emit("stxdw", dst=10, src=_TEMP_REGS[0],
                      off=off - STACK_SIZE)
        for k in range(n_args):
            self.emit("ldxdw", dst=1 + k, src=10,
                      off=self._park_slot(k) - STACK_SIZE)
        self.emit("call_fn", imm=idx)

    def _const_of(self, node: ast.AST) -> Optional[int]:
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, bool)):
            return int(node.value)
        if isinstance(node, ast.Name) and node.id in self.consts:
            return self.consts[node.id]
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
            v = self._const_of(node.operand)
            return None if v is None else -v
        if isinstance(node, ast.BinOp):
            l, r = self._const_of(node.left), self._const_of(node.right)
            if l is None or r is None:
                return None
            import operator
            fns = {ast.Add: operator.add, ast.Sub: operator.sub,
                   ast.Mult: operator.mul, ast.FloorDiv: operator.floordiv,
                   ast.Mod: operator.mod, ast.LShift: operator.lshift,
                   ast.RShift: operator.rshift, ast.BitAnd: operator.and_,
                   ast.BitOr: operator.or_, ast.BitXor: operator.xor}
            fn = fns.get(type(node.op))
            return None if fn is None else fn(l, r)
        return None

    def _const_value(self, node: ast.AST) -> int:
        v = self._const_of(node)
        if v is None:
            raise CompileError("expected a compile-time constant")
        return v

    def _load_const(self, dst: int, v: int) -> None:
        v &= M64
        if v < (1 << 31):
            self.emit("mov64i", dst=dst, imm=v)
        else:
            self.emit("lddw", dst=dst, imm=v)

    def _ctx_field(self, name: str):
        try:
            return self.ctx_type.fields[name]
        except KeyError:
            raise CompileError(
                f"ctx ({self.ctx_type.name}) has no field {name!r}") from None

    # ---- conditions ------------------------------------------------------------
    def compile_cond(self, node: ast.AST, target: _Label, *, negate: bool) -> None:
        """Jump to ``target`` iff cond (xor negate) is true; else fall through."""
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
            self.compile_cond(node.operand, target, negate=not negate)
            return
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And) != negate:
                # all must hold: fail-fast to fall-through
                done = _Label()
                for val in node.values[:-1]:
                    self.compile_cond(val, done, negate=not negate)
                self.compile_cond(node.values[-1], target, negate=negate)
                self.place(done)
            else:
                for val in node.values:
                    self.compile_cond(val, target, negate=negate)
            return
        if isinstance(node, ast.Compare):
            if len(node.ops) != 1:
                raise CompileError("chained comparisons are not supported")
            left, right = node.left, node.comparators[0]
            # `x is None` / `x is not None` on pointer locals
            if isinstance(node.ops[0], (ast.Is, ast.IsNot)):
                if not (isinstance(right, ast.Constant) and right.value is None):
                    raise CompileError("`is` only supported against None")
                if not (isinstance(left, ast.Name) and left.id in self.ptrs):
                    raise CompileError("`is None` only on map-lookup results")
                op = "jeq" if isinstance(node.ops[0], ast.Is) else "jne"
                if negate:
                    op = _NEGATE[op]
                self.emit_jmp(op, self.ptrs[left.id], 0, target, imm_form=True)
                return
            op = _CMP_OPS.get(type(node.ops[0]))
            if op is None:
                raise CompileError(f"unsupported comparison {node.ops[0]}")
            if negate:
                op = _NEGATE[op]
            self.eval_expr(left, _TEMP_REGS[0], _TEMP_REGS[2:])
            rc = self._const_of(right)
            if rc is not None and -(1 << 31) <= rc < (1 << 31):
                self.emit_jmp(op, _TEMP_REGS[0], rc, target, imm_form=True)
            else:
                self.eval_expr(right, _TEMP_REGS[1], _TEMP_REGS[2:])
                self.emit_jmp(op, _TEMP_REGS[0], _TEMP_REGS[1], target,
                              imm_form=False)
            return
        # truthiness of an expression
        self.eval_expr(node, _TEMP_REGS[0], _TEMP_REGS[1:])
        self.emit_jmp("jeq" if negate else "jne", _TEMP_REGS[0], 0, target,
                      imm_form=True)

    # ---- key/value scratch -------------------------------------------------------
    def _emit_key(self, key_node: ast.AST, decl: MapDecl) -> int:
        """Materialize the key on the stack; return its absolute offset."""
        off = self.alloc_stack(8)
        self.eval_expr(key_node, _TEMP_REGS[0], _TEMP_REGS[1:])
        op = {4: "stxw", 8: "stxdw"}[decl.key_size]
        self.emit(op, dst=10, src=_TEMP_REGS[0], off=off - STACK_SIZE)
        if decl.key_size == 4:
            pass  # low 4 bytes written; that's the whole key
        return off

    def _map_of(self, node: ast.AST) -> MapDecl:
        if isinstance(node, ast.Name) and node.id in self.maps:
            return self.maps[node.id]
        raise CompileError("expected a declared map name")

    # ---- statements ----------------------------------------------------------------
    def compile_body(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            self.compile_stmt(stmt)

    def compile_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, ast.Return):
            if stmt.value is None:
                self._load_const(0, 0)
            elif self._is_subcall(stmt.value):
                self._emit_subcall(stmt.value)   # result is already in r0
            else:
                self.eval_expr(stmt.value, 0, _TEMP_REGS)
            self.emit("exit")
            return
        if isinstance(stmt, ast.Pass):
            return
        if isinstance(stmt, ast.Expr):
            if isinstance(stmt.value, ast.Constant) and isinstance(
                    stmt.value.value, str):
                return  # docstring
            self._compile_call_stmt(stmt.value)
            return
        if isinstance(stmt, ast.Assign):
            if len(stmt.targets) != 1:
                raise CompileError("multiple assignment targets not supported")
            self._compile_assign(stmt.targets[0], stmt.value)
            return
        if isinstance(stmt, ast.AugAssign):
            op = _BIN_OPS.get(type(stmt.op))
            if op is None:
                raise CompileError(f"unsupported augmented op {stmt.op}")
            synth = ast.BinOp(left=self._target_as_expr(stmt.target),
                              op=stmt.op, right=stmt.value)
            ast.copy_location(synth, stmt)
            ast.fix_missing_locations(synth)
            self._compile_assign(stmt.target, synth)
            return
        if isinstance(stmt, ast.If):
            else_l, end_l = _Label(), _Label()
            self.compile_cond(stmt.test, else_l, negate=True)
            self.compile_body(stmt.body)
            if stmt.orelse:
                self.emit_ja(end_l)
                self.place(else_l)
                self.compile_body(stmt.orelse)
                self.place(end_l)
            else:
                self.place(else_l)
            return
        if isinstance(stmt, ast.For):
            self._compile_for(stmt)
            return
        raise CompileError(f"unsupported statement: {type(stmt).__name__}")

    def _target_as_expr(self, tgt: ast.AST) -> ast.AST:
        e = ast.parse(ast.unparse(tgt), mode="eval").body
        return e

    def _compile_for(self, stmt: ast.For) -> None:
        # for i in range(CONST): unrolled up to _MAX_UNROLL iterations;
        # larger trip counts compile to real bounded-loop bytecode
        # (counter slot + header test + latch increment) that the
        # verifier proves terminating
        it = stmt.iter
        if not (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range"):
            raise CompileError("only `for i in range(...)` loops supported")
        bounds = []
        for a in it.args:
            v = self._const_of(a)
            if v is None:
                raise CompileError(
                    "`for` bound must be a compile-time constant "
                    f"(got `{ast.unparse(a)}`): loops are either fully "
                    f"unrolled (trip count <= {_MAX_UNROLL}) or compiled "
                    "to bounded-loop bytecode whose trip count the "
                    "verifier proves — a constant-stepped counter tested "
                    "against a constant limit, capped at "
                    f"{_LOOP_FUEL_CAP} iterations.  Hoist the bound into "
                    "a module-level integer or pass it via "
                    "`policy(consts={...})`")
            bounds.append(v)
        if len(bounds) == 1:
            lo, hi, step = 0, bounds[0], 1
        elif len(bounds) == 2:
            lo, hi, step = bounds[0], bounds[1], 1
        else:
            lo, hi, step = bounds
        if step == 0:
            raise CompileError("range() step must not be zero")
        count = max(0, (hi - lo + (step - (1 if step > 0 else -1))) // step)
        if not isinstance(stmt.target, ast.Name):
            raise CompileError("loop target must be a simple name")
        iname = stmt.target.id
        if stmt.orelse:
            raise CompileError("for-else not supported")
        if iname in self._active_loops:
            raise CompileError(
                f"loop variable {iname!r} shadows an enclosing loop's "
                "variable; nested loops need distinct names")
        if iname in self.scalars or iname in self.ptrs:
            # the unrolled path would silently read the stale local inside
            # the body (scalars shadow consts) and the real-loop path
            # would clobber it as the counter — reject loudly instead
            raise CompileError(
                f"loop variable {iname!r} shadows an existing local; use "
                "a distinct name for the loop")
        self._active_loops.add(iname)
        try:
            if count <= _MAX_UNROLL:
                for k in range(lo, hi, step):
                    self.consts[iname] = k
                    # also make it readable as an expression constant
                    self.compile_body(stmt.body)
                self.consts.pop(iname, None)
                return
            self._compile_real_loop(stmt, iname, lo, hi, step)
        finally:
            self._active_loops.discard(iname)

    def _compile_real_loop(self, stmt: ast.For, iname: str,
                           lo: int, hi: int, step: int) -> None:
        """Emit header/latch loop bytecode in the exact shape the
        verifier's trip-bound prover recognizes: counter in an 8-byte
        stack slot, unsigned `jge counter, hi` exit in the header, one
        `load; add64i +step; store` increment in the latch."""
        if step < 0:
            raise CompileError(
                "descending `range()` loops above the unroll limit are "
                "not supported: the verifier proves bounds for ascending "
                "constant-step counters only — iterate ascending and "
                "index with `hi - 1 - i`")
        if lo < 0 or hi < 0:
            raise CompileError("negative `range()` bounds not supported "
                               "above the unroll limit")
        if not hi < (1 << 31):
            raise CompileError(
                f"loop limit {hi} does not fit a 32-bit immediate")
        # the verifier recovers the constant init (lo), so its proven
        # bound equals the real trip count
        trip = (hi - lo + step - 1) // step
        if trip > _LOOP_FUEL_CAP:
            raise CompileError(
                f"loop trip bound {trip} exceeds the verifier's per-loop "
                f"fuel cap {_LOOP_FUEL_CAP}; shrink the loop or split the "
                "scan across invocations")
        slot = self._loop_slots.get(iname)
        if slot is None:
            slot = self.alloc_stack(8)
            self._loop_slots[iname] = slot
        self.scalars[iname] = slot
        # a same-named module const is shadowed for good, exactly like
        # the unrolled path: post-loop reads of the loop variable fail
        # loudly in both (the slot's exit value is not Python's last
        # iterate, and the stale const would be silently wrong)
        self.consts.pop(iname, None)

        t = _TEMP_REGS[0]
        self._load_const(t, lo)
        self.emit("stxdw", dst=10, src=t, off=slot - STACK_SIZE)
        header, done = _Label(), _Label()
        self.place(header)
        self.emit("ldxdw", dst=t, src=10, off=slot - STACK_SIZE)
        self.emit_jmp("jge", t, hi, done, imm_form=True)
        self.compile_body(stmt.body)
        self.emit("ldxdw", dst=t, src=10, off=slot - STACK_SIZE)
        self.emit("add64i", dst=t, imm=step)
        self.emit("stxdw", dst=10, src=t, off=slot - STACK_SIZE)
        self.emit_ja(header)
        self.place(done)
        self.scalars.pop(iname, None)

    def _compile_assign(self, tgt: ast.AST, value: ast.AST) -> None:
        # pointer-producing RHS: rb.reserve()
        if isinstance(value, ast.Call) and isinstance(value.func, ast.Attribute) \
                and value.func.attr == "reserve":
            decl = self._map_of(value.func.value)
            if not isinstance(tgt, ast.Name):
                raise CompileError("reserve result must bind a simple name")
            if value.args:
                raise CompileError("reserve() takes no arguments")
            self.emit("ldmap", dst=1, map_name=decl.name)
            self.emit("call", imm=HELPER_IDS["ringbuf_reserve"])
            name = tgt.id
            if name not in self.ptrs:
                if not self.ptr_regs:
                    raise CompileError("too many live map-value pointers (max 3)")
                self.ptrs[name] = self.ptr_regs.pop()
            self.emit("mov64", dst=self.ptrs[name], src=0)
            return
        # pointer-producing RHS: m.lookup(key)
        if isinstance(value, ast.Call) and isinstance(value.func, ast.Attribute) \
                and value.func.attr == "lookup":
            decl = self._map_of(value.func.value)
            if not isinstance(tgt, ast.Name):
                raise CompileError("lookup result must bind a simple name")
            key_off = self._emit_key(value.args[0], decl)
            self.emit("ldmap", dst=1, map_name=decl.name)
            self.emit("mov64", dst=2, src=10)
            self.emit("add64i", dst=2, imm=key_off - STACK_SIZE)
            self.emit("call", imm=HELPER_IDS["map_lookup_elem"])
            name = tgt.id
            if name not in self.ptrs:
                if not self.ptr_regs:
                    raise CompileError("too many live map-value pointers (max 3)")
                self.ptrs[name] = self.ptr_regs.pop()
            self.emit("mov64", dst=self.ptrs[name], src=0)
            return
        # scalar-producing RHS: subroutine call f(a, b)
        if self._is_subcall(value):
            if not isinstance(tgt, ast.Name):
                raise CompileError(
                    "subroutine results must bind a simple name")
            name = tgt.id
            if name in self.ptrs:
                raise CompileError(
                    f"{name!r} already holds a map-value pointer")
            if name not in self.scalars:
                self.scalars[name] = self.alloc_stack(8)
            self._emit_subcall(value)
            self.emit("stxdw", dst=10, src=0,
                      off=self.scalars[name] - STACK_SIZE)
            return
        if isinstance(tgt, ast.Name):
            name = tgt.id
            if name in self.ptrs:
                raise CompileError(
                    f"{name!r} already holds a map-value pointer")
            if name not in self.scalars:
                self.scalars[name] = self.alloc_stack(8)
            self.eval_expr(value, _TEMP_REGS[0], _TEMP_REGS[1:])
            self.emit("stxdw", dst=10, src=_TEMP_REGS[0],
                      off=self.scalars[name] - STACK_SIZE)
            return
        if isinstance(tgt, ast.Attribute):
            if isinstance(tgt.value, ast.Name) and tgt.value.id == self.ctx_name:
                f = self._ctx_field(tgt.attr)
                self.eval_expr(value, _TEMP_REGS[0], _TEMP_REGS[1:])
                self.emit("stxdw", dst=self.ctx_reg, src=_TEMP_REGS[0],
                          off=f.offset)
                return
            if self.ctx_name is None:
                raise CompileError(
                    "subroutines have no ctx; return the value and let "
                    "the caller store it")
            raise CompileError("only ctx.<field> attribute stores supported")
        if isinstance(tgt, ast.Subscript):
            base = tgt.value
            if isinstance(base, ast.Name) and base.id in self.ptrs:
                idx = self._const_value(tgt.slice)
                self.eval_expr(value, _TEMP_REGS[0], _TEMP_REGS[1:])
                self.emit("stxdw", dst=self.ptrs[base.id],
                          src=_TEMP_REGS[0], off=8 * idx)
                return
            raise CompileError("subscript store only on map-value pointers")
        raise CompileError(f"unsupported assignment target {ast.dump(tgt)[:60]}")

    def _compile_call_stmt(self, node: ast.AST) -> None:
        if not isinstance(node, ast.Call):
            raise CompileError("expression statements must be calls")
        if self._is_subcall(node):
            self._emit_subcall(node)   # result in r0, discarded
            return
        if isinstance(node.func, ast.Attribute):
            decl = self._map_of(node.func.value)
            meth = node.func.attr
            if meth == "update":
                key_node, val_node = node.args
                key_off = self._emit_key(key_node, decl)
                val_off = self.alloc_stack(decl.value_size)
                elems = val_node.elts if isinstance(
                    val_node, (ast.Tuple, ast.List)) else [val_node]
                if len(elems) * 8 != decl.value_size:
                    raise CompileError(
                        f"map '{decl.name}' value is {decl.value_size}B; "
                        f"update supplies {len(elems) * 8}B")
                for i, e in enumerate(elems):
                    self.eval_expr(e, _TEMP_REGS[0], _TEMP_REGS[1:])
                    self.emit("stxdw", dst=10, src=_TEMP_REGS[0],
                              off=val_off - STACK_SIZE + 8 * i)
                self.emit("ldmap", dst=1, map_name=decl.name)
                self.emit("mov64", dst=2, src=10)
                self.emit("add64i", dst=2, imm=key_off - STACK_SIZE)
                self.emit("mov64", dst=3, src=10)
                self.emit("add64i", dst=3, imm=val_off - STACK_SIZE)
                self.emit("mov64i", dst=4, imm=0)
                self.emit("call", imm=HELPER_IDS["map_update_elem"])
                return
            if meth == "delete":
                key_off = self._emit_key(node.args[0], decl)
                self.emit("ldmap", dst=1, map_name=decl.name)
                self.emit("mov64", dst=2, src=10)
                self.emit("add64i", dst=2, imm=key_off - STACK_SIZE)
                self.emit("call", imm=HELPER_IDS["map_delete_elem"])
                return
            if meth in ("submit", "discard"):
                if node.args:
                    raise CompileError(f"{meth}() takes no arguments")
                self.emit("ldmap", dst=1, map_name=decl.name)
                self.emit("call", imm=HELPER_IDS[f"ringbuf_{meth}"])
                return
            if meth == "lookup":
                raise CompileError("bind lookup results: `st = m.lookup(k)`")
            if meth == "reserve":
                raise CompileError("bind reserve results: `e = rb.reserve()`")
            raise CompileError(f"unknown map method {meth!r}")
        if isinstance(node.func, ast.Name) and node.func.id == "ema_update":
            m_node, key_node, sample_node, w_node = node.args
            decl = self._map_of(m_node)
            key_off = self._emit_key(key_node, decl)
            park = self.alloc_stack(8)
            self.eval_expr(sample_node, _TEMP_REGS[1], _TEMP_REGS[2:])
            self.emit("stxdw", dst=10, src=_TEMP_REGS[1],
                      off=park - STACK_SIZE)  # park sample across eval
            self.eval_expr(w_node, _TEMP_REGS[2], _TEMP_REGS[3:])
            self.emit("mov64", dst=4, src=_TEMP_REGS[2])
            self.emit("ldxdw", dst=3, src=10, off=park - STACK_SIZE)
            self.emit("ldmap", dst=1, map_name=decl.name)
            self.emit("mov64", dst=2, src=10)
            self.emit("add64i", dst=2, imm=key_off - STACK_SIZE)
            self.emit("call", imm=HELPER_IDS["ema_update"])
            return
        if isinstance(node.func, ast.Name) and node.func.id == "trace_printk":
            self.eval_expr(node.args[0], _TEMP_REGS[0], _TEMP_REGS[1:])
            self.emit("mov64", dst=1, src=_TEMP_REGS[0])
            self.emit("call", imm=HELPER_IDS["trace_printk"])
            return
        raise CompileError(f"unsupported call statement {ast.dump(node)[:60]}")

    # ---- assembly + patching --------------------------------------------------------
    def finalize(self) -> List[Insn]:
        # implicit `return 0` if control can fall off the end
        self._load_const(0, 0)
        self.emit("exit")

        # resolve labels
        addr: Dict[int, int] = {}
        pc = 0
        for item in self.insns:
            if isinstance(item, tuple) and item[0] == "label":
                addr[item[1].id] = pc
            else:
                pc += 1
        out: List[Insn] = []
        pc = 0
        for item in self.insns:
            if isinstance(item, tuple) and item[0] == "label":
                continue
            if isinstance(item, tuple) and item[0] == "jmp":
                _, op, dst, other, label = item
                off = addr[label.id] - (pc + 1)
                if op == "ja":
                    out.append(Insn("ja", off=off))
                elif op.endswith("i"):
                    out.append(Insn(op, dst=dst, off=off, imm=other))
                else:
                    out.append(Insn(op, dst=dst, src=other, off=off))
            else:
                out.append(item)
            pc += 1
        return out


def _fn_ast_of(fn) -> Tuple[str, ast.FunctionDef]:
    src = textwrap.dedent(inspect.getsource(fn))
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == fn.__name__:
            return src, node
    raise CompileError(f"could not find function {fn.__name__}")


def _resolve_subroutine(name: str, env: Dict, owner):
    """The function ``name`` refers to at a call site inside ``owner``,
    if it is marked ``@subroutine``; else None."""
    val = env.get(name)
    if val is None and getattr(owner, "__closure__", None):
        for fv, cell in zip(owner.__code__.co_freevars, owner.__closure__):
            if fv == name:
                try:
                    val = cell.cell_contents
                except ValueError:
                    pass
                break
    if callable(val) and getattr(val, "_bpf_subroutine", False):
        return val
    return None


def _collect_subroutines(fn, fn_ast: ast.FunctionDef):
    """Subprogram specs ``(name, FunctionDef, defining fn or None)`` in
    discovery order: ``def``s nested in the policy body first (compiled
    in the policy's const/alias environment), then module-level
    ``@subroutine`` functions reached transitively through call sites
    (each compiled in its own module's environment)."""
    subs: List[Tuple[str, ast.FunctionDef, Optional[object]]] = []
    seen = set()
    for s in fn_ast.body:
        if isinstance(s, ast.FunctionDef):
            subs.append((s.name, s, None))
            seen.add(s.name)
    work = [(fn_ast, getattr(fn, "__globals__", {}), fn)]
    while work:
        t, env, owner = work.pop()
        for node in ast.walk(t):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)):
                continue
            nm = node.func.id
            if nm in seen:
                continue
            sub_fn = _resolve_subroutine(nm, env, owner)
            if sub_fn is None:
                continue
            _, fa = _fn_ast_of(sub_fn)
            seen.add(nm)
            subs.append((nm, fa, sub_fn))
            work.append((fa, getattr(sub_fn, "__globals__", {}), sub_fn))
    return subs


def _check_sub_signature(nm: str, fa: ast.FunctionDef) -> None:
    a = fa.args
    if a.vararg or a.kwarg or a.kwonlyargs or a.defaults or a.posonlyargs:
        raise CompileError(
            f"subroutine {nm!r}: only plain positional parameters are "
            "supported (no defaults, *args, **kwargs, keyword-only)")
    if len(a.args) > 5:
        raise CompileError(
            f"subroutine {nm!r} takes {len(a.args)} parameters; "
            "bpf-to-bpf calls pass at most 5 (r1..r5)")


def compile_policy(fn, *, section: str, maps: List[MapDecl] = (),
                   extra_consts: Optional[Dict[str, int]] = None) -> Program:
    """Compile a restricted-Python function into a Program (NOT yet verified)."""
    src, fn_ast = _fn_ast_of(fn)
    g = getattr(fn, "__globals__", {})

    consts: Dict[str, int] = {}
    for name, val in list(g.items()):
        if isinstance(val, (int, bool)) and not name.startswith("__"):
            consts[name] = int(val)
    # closure cells too
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                if isinstance(cell.cell_contents, int):
                    consts[name] = int(cell.cell_contents)
            except ValueError:
                pass
    if extra_consts:
        consts.update(extra_consts)

    # map variable-name aliases from the function's globals/closure
    aliases: Dict[str, str] = {}
    for name, val in list(g.items()):
        if isinstance(val, MapDecl):
            aliases[name] = val.name
    if fn.__closure__:
        for name, cell in zip(fn.__code__.co_freevars, fn.__closure__):
            try:
                if isinstance(cell.cell_contents, MapDecl):
                    aliases[name] = cell.cell_contents.name
            except ValueError:
                pass

    # bpf-to-bpf subprograms: nested defs + module-level @subroutine fns
    sub_specs = _collect_subroutines(fn, fn_ast)
    subprog_ids: Dict[str, Tuple[int, int]] = {}
    for i, (nm, fa, _) in enumerate(sub_specs):
        _check_sub_signature(nm, fa)
        subprog_ids[nm] = (i, len(fa.args.args))
    consts_snapshot = dict(consts)

    main_body = [s for s in fn_ast.body if not isinstance(s, ast.FunctionDef)]
    c = _Compiler(fn_ast, section, list(maps), consts, map_aliases=aliases,
                  subprogs=subprog_ids)
    c._ctx_setup()
    c.compile_body(main_body)
    insns = c.finalize()

    subprogs = []
    for nm, fa, sub_fn in sub_specs:
        if sub_fn is None:
            # nested def: shares the policy's consts and map aliases
            sub_consts, sub_aliases = dict(consts_snapshot), dict(aliases)
        else:
            # module-level @subroutine: its own module's environment
            sg = getattr(sub_fn, "__globals__", {})
            sub_consts = {n: int(v) for n, v in list(sg.items())
                          if isinstance(v, (int, bool))
                          and not n.startswith("__")}
            if extra_consts:
                sub_consts.update(extra_consts)
            sub_aliases = {n: v.name for n, v in list(sg.items())
                           if isinstance(v, MapDecl)}
        sc = _Compiler(fa, section, list(maps), sub_consts,
                       map_aliases=sub_aliases, subprogs=subprog_ids,
                       params=[a.arg for a in fa.args.args])
        sc._args_setup()
        sc.compile_body(fa.body)
        subprogs.append(SubProgram(nm, tuple(sc.finalize()),
                                   n_args=len(fa.args.args)))

    return Program(name=fn.__name__, section=section, insns=insns,
                   maps=tuple(maps), source=src, subprogs=tuple(subprogs))


def policy(*, section: str, maps: List[MapDecl] = (),
           consts: Optional[Dict[str, int]] = None):
    """Decorator: compile at definition time; attaches ``.program``."""
    def deco(fn):
        fn.program = compile_policy(fn, section=section, maps=maps,
                                    extra_consts=consts)
        return fn
    return deco
