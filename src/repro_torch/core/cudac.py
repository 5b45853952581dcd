"""cudac — a verified policy program as one hand-written CUDA kernel.

The Hopper counterpart of the TPU policy kernels
``repro/core/pallasc.py:175`` (``_build_pallas_fn``, B1: one
``pl.pallas_call`` running the ``jaxc`` lowering over the ctx vector and
every map tile) and ``repro/core/pallasc.py:229`` (``_build_pallas_fn32``,
B2: the same decision over ``(lo, hi)`` uint32 pairs through
``lower32._Lowerer32``).  Every device decision of the port runs
through it.

B2 on Hopper is a second entry of the same translation unit, not a
second arithmetic.  The reference splits every u64 operation into
32-bit carry chains, a 16-bit-limb multiply and a 64-step long division
because Mosaic lowers no 64-bit integers; Hopper's compiler lowers
``u64``.  The pair layout ``[..., 2]`` holding ``[lo, hi]`` has the
bytes of a little-endian u64 array, so ``<prefix>kernel32`` runs the u64
decision over its uint32 operands viewed as words (the wrapper checks
8-byte alignment) and writes the return value as ``[lo, hi]``.

The design
----------
What bounds a decision on the card is latency, not bytes or operations:
the launch, and every load whose address or use waits on the one before.
The TPU kernel holds ctx and every map as VMEM tiles for the whole
decision; the Hopper design keeps the decision's chain on the chip:

* **The frame in registers.**  Each function takes a frame route at
  emit time (:func:`frame_route`, printed in the source and in
  :attr:`KernelSource.routes`): ``"regs"`` where every stack access and
  every stack-pointer argument of a helper has one constant offset by
  the verifier's facts (``FnInfo.mem_info``, ``FnInfo.stack_args``) —
  each 8-byte slot it touches a zeroed ``u64`` local ``s_<off>``,
  narrow accesses shifts and masks on it, map keys and update values
  read from the slots at the call; ``"memory"`` otherwise, a zeroed
  512-byte local frame addressed through ``r10``.  Every shipped
  function takes ``"regs"`` (no local memory on the card).
* **Scans across a warp.**  A program with a map its helpers scan
  (``hash``, ``lru_hash``: :func:`scans`) runs warp-uniform: all 32
  lanes run the same scalar code, the hash probe and the LRU key and
  victim scans spread their rows over the lanes (a ballot finds the
  serial walk's first stopping row, a butterfly the lowest index of
  least recency), and lane 0 makes every store between two
  ``__syncwarp()``.  Any other program runs on one thread: the lane-0
  stores and their barriers would cost it time and buy nothing.
* **The state stays in device memory.**  The ctx and the maps are read
  in place, hot in the caches between decisions.  Copying them into
  shared memory at kernel start (the bulk-copy engine into an
  ``mbarrier``, the block's threads for the ragged ends) was built and
  measured on the H100 (PERF.md, PR 25): no rule paid for any shipped
  program, since the copy and its barriers cost more than the
  decision's dependent reads of a hot table, loops included, and the
  warp scans on device memory beat the same scans on a staged copy.
* **Loops** are left to nvcc's unroller, which folds a scan over a
  register frame into straight-line code, except a loop whose body
  stores through a ctx or map pointer or calls a map-writing helper or
  a callee: it gets ``#pragma unroll 1``.  Unrolled in full, a chain of
  65 read-modify-writes of one map cell kept nvcc busy for more than
  ten minutes; the same chain through a stack slot or a register built
  in seconds (``scripts/loop_build_probe.py``, PERF.md).
* **The hash home slot** is one 32-bit remainder (the folded key and
  the capacity are below 2^32).

Code generation
---------------
One CUDA C++ translation unit per verified program, from the same
artifacts the host native tier walks (the shared CFG, the verifier's
region facts and loop bounds):

* the helper runtime ``csrc/policy_kernel.cuh`` (inlined ``__device__``
  code for array, hash, LRU and ring-buffer maps and ``ema_update`` —
  the native tier calls back into Python for most of these, a kernel
  cannot);
* one ``__device__`` function per program function, main and every
  ``call_fn`` callee (a fresh zeroed frame each, on its route), emitted
  by the host tiers' walk (:mod:`repro_torch.core.emit`) as structured
  ``if``/``while`` regions where the post-dominator shape allows and as
  a label-per-block ``goto`` skeleton otherwise;
* the kernels (one thread, or one warp) and their ``extern "C"``
  launchers, which return ``cudaGetLastError()``, over u64 words and,
  for programs without an ``lru_hash`` map (the pair tier's rule), over
  ``[lo, hi]`` pairs; ``<prefix>attrs`` reports
  ``cudaFuncGetAttributes``.

Registers are ``u64`` locals; pointers are real device addresses — the
ctx tensor, rows of the map tensors, the local frame on route
``memory`` — so a map-value pointer stays inside the row
the verifier proved.  On route ``regs``, ``r10`` is the plain version's
tagged frame top and a stack pointer is read only through the
verifier's offsets.  Each loop header counts its visits and stops the
function past ``bound + 1`` (the reference's ``fori_loop`` trip count),
so the kernel terminates even on a verifier bug.  The load-time
rejections are the reference's, with the same messages
(:func:`repro_torch.core.torchc.check_supported`).

Build and launch
----------------
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into a ``.so`` loaded with ctypes, at first use, under
``build/repro_torch_kernels/`` in the checkout, keyed by the hash of the
source and flags: a warm ``link.replace()`` rebuilds nothing.
:func:`build_all` runs the ``nvcc`` builds in parallel;
:func:`build_bundle` puts many small programs into each library, each
under its own symbol prefix.

:class:`PolicyKernel` launches on PyTorch's current stream and updates
its ctx and map tensors **in place** (``int64`` u64 bit patterns on one
CUDA device).  Given CPU tensors it runs the plain PyTorch version
(:mod:`repro_torch.core.torchc`, ``run`` and ``run32``) instead; given
CUDA tensors it launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from ..device import DeviceError, nvcc_path
from . import helpers as H
from . import torchc
from .cfg import CFG
from .emit import CEmitter, StructAbort, u64c
from .isa import (STACK_SIZE, Insn, alu_base, alu_width, is_alu,
                  is_imm_form, is_load, is_store, mem_size)
from .maps import device_shape
from .program import Program
from .verifier import verify_with_info

M64 = (1 << 64) - 1
M32 = 0xFFFFFFFF

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
NVCC_TIMEOUT_S = 600    # one nvcc run; past it the build fails
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"

_ALU_SYM = {"add": "+", "sub": "-", "mul": "*", "and": "&", "or": "|",
            "xor": "^"}


class CudacError(Exception):
    """A policy cannot lower to the cuda tier, a kernel failed to build,
    or a launch failed."""


def _slot(word: int) -> str:
    """The register slot of frame word ``word``, named by its distance
    below the frame top: ``s_8`` holds ``fp-8 .. fp-1``."""
    return f"s_{STACK_SIZE - 8 * word}"


def _slot_ld(byte: int, n: int) -> str:
    """``bpf_ld_stack`` of ``n`` bytes at frame byte ``byte``, on the
    slots: the word that holds the byte, shifted and masked."""
    w, sh = _slot(byte >> 3), (byte & 7) * 8
    if n >= 8:
        return w
    return f"(({w} >> {sh}) & {u64c((1 << (8 * n)) - 1)})"


def _slot_st(byte: int, n: int, val: str) -> str:
    """``bpf_st_stack`` of ``n`` bytes at frame byte ``byte``, on the
    slots."""
    w, sh = _slot(byte >> 3), (byte & 7) * 8
    if n >= 8:
        return f"{w} = {val};"
    m = (1 << (8 * n)) - 1
    keep = ~(m << sh) & M64
    return (f"{w} = ({w} & {u64c(keep)}) | "
            f"(({val} & {u64c(m)}) << {sh});")


def frame_route(fi) -> str:
    """``"regs"`` where every stack access and every stack-pointer
    argument of a helper in the function has one constant frame offset
    by the verifier's facts (``mem_info``, ``stack_args``), else
    ``"memory"``.  A stack pointer never reaches a callee: the verifier
    takes scalar arguments only at ``call_fn``.  (The emitter also keeps
    a function in memory whose loops fall to the goto skeleton.)"""
    for pc, insn in enumerate(fi.insns):
        if is_load(insn.op) or is_store(insn.op):
            info = fi.mem_info.get(pc)
            if info is not None and info[0] == "stack" and info[2] is None:
                return "memory"
    args = getattr(fi, "stack_args", None)
    if args is None or any(v is None for v in args.values()):
        return "memory"
    return "regs"


def frame_words(fi, prog: Program) -> set:
    """The frame words a function on route ``regs`` touches: its stack
    loads and stores, its helpers' keys and update values."""
    words = set()
    for pc, insn in enumerate(fi.insns):
        if is_load(insn.op) or is_store(insn.op):
            info = fi.mem_info.get(pc)
            if info is not None and info[0] == "stack":
                words.add((info[2] + insn.off) >> 3)
    for (pc, argi), off in fi.stack_args.items():
        mname = fi.call_map.get(pc)
        if mname is None:
            continue
        d = prog.map_decl(mname)
        if argi == 2:
            words.add(off >> 3)
        else:
            _, cols = device_shape(d.kind, d.value_size, d.max_entries)
            n = cols if d.kind in ("array", "perdev_array") else cols - 2
            words.update(range(off >> 3, (off >> 3) + n))
    return words


# ---------------------------------------------------------------------------
# code generation
# ---------------------------------------------------------------------------

class _CudaGen(CEmitter):
    """Emits the program's device functions: the structured walk of
    :mod:`repro_torch.core.emit` with its ``goto`` fallback."""

    def __init__(self, prog: Program, vinfo, prefix: str,
                 route: Optional[str] = None):
        self.prog = prog
        self.prefix = prefix
        self.fns = torchc.fn_infos(vinfo)
        self.map_index = {d.name: i for i, d in enumerate(prog.maps)}
        self.structured = True
        self.routes = tuple(route or frame_route(fi) for fi in self.fns)

    # ---- straight-line instructions ---------------------------------------
    def emit_body_insn(self, pc: int, insn: Insn) -> None:
        op = insn.op
        if op == "lddw":
            self.w(f"r{insn.dst} = {u64c(insn.imm)};")
        elif op == "ldmap":
            tag = (16 + self.map_index[insn.map_name]) << 56
            self.w(f"r{insn.dst} = {u64c(tag)};")
        elif op == "call":
            self._emit_call(pc, insn)
        elif op == "call_fn":
            self.w(f"r0 = {self.prefix}fn{insn.imm}(M, r1, r2, r3, r4, r5);")
            self.w("r1 = 0; r2 = 0; r3 = 0; r4 = 0; r5 = 0;")
        elif is_alu(op):
            self._emit_alu(insn)
        elif is_load(op):
            info = self.fninfo.mem_info.get(pc)
            n = mem_size(op)
            addr = f"r{insn.src} + {u64c(insn.off)}"
            if info is None:
                self.w(f"r{insn.dst} = 0; /* unreachable */")
            elif info[0] == "stack" and self.regs:
                self.w(f"r{insn.dst} = {_slot_ld(info[2] + insn.off, n)};")
            elif info[0] == "stack":
                self.w(f"r{insn.dst} = bpf_ld_stack({addr}, {n});")
            else:
                self.w(f"r{insn.dst} = bpf_ld_cell({addr}, {n});")
        elif is_store(op):
            info = self.fninfo.mem_info.get(pc)
            n = mem_size(op)
            val = f"r{insn.src}" if op.startswith("stx") \
                else u64c(insn.imm)
            addr = f"r{insn.dst} + {u64c(insn.off)}"
            if info is None:
                self.w("; /* unreachable store */")
            elif info[0] == "stack" and self.regs:
                self.w(_slot_st(info[2] + insn.off, n, val))
            elif info[0] == "stack":
                self.w(f"bpf_st_stack({addr}, {n}, {val});")
            else:
                self.w(f"bpf_st_cell({addr}, {val});")
        else:
            raise CudacError(f"unhandled op {op}")

    def _emit_alu(self, insn: Insn) -> None:
        base = alu_base(insn.op)
        d = f"r{insn.dst}"
        if alu_width(insn.op) == 64:
            s = u64c(insn.imm) if is_imm_form(insn.op) else f"r{insn.src}"
            if base == "mov":
                expr = s
            elif base == "neg":
                expr = f"(u64)0 - {d}"
            elif base in _ALU_SYM:
                expr = f"{d} {_ALU_SYM[base]} {s}"
            elif base in ("div", "mod"):
                sym = "/" if base == "div" else "%"
                expr = f"{d} {sym} ({s} ? {s} : 1ULL)"
            elif base in ("lsh", "rsh"):
                sym = "<<" if base == "lsh" else ">>"
                expr = f"{d} {sym} ({s} & 63)"
            elif base == "arsh":
                expr = f"(u64)((long long){d} >> ({s} & 63))"
            else:
                raise CudacError(f"ALU base {base}")
            self.w(f"{d} = {expr};")
            return
        # 32-bit: u32 views, result zero-extended
        s = f"0x{insn.imm & M32:x}U" if is_imm_form(insn.op) \
            else f"(uint32_t)r{insn.src}"
        a = f"(uint32_t){d}"
        if base == "mov":
            expr = s
        elif base == "neg":
            expr = f"0U - {a}"
        elif base in _ALU_SYM:
            expr = f"{a} {_ALU_SYM[base]} {s}"
        elif base in ("div", "mod"):
            sym = "/" if base == "div" else "%"
            expr = f"{a} {sym} ({s} ? {s} : 1U)"
        elif base in ("lsh", "rsh"):
            sym = "<<" if base == "lsh" else ">>"
            expr = f"{a} {sym} ({s} & 31)"
        elif base == "arsh":
            expr = f"(uint32_t)((int32_t){a} >> ({s} & 31))"
        else:
            raise CudacError(f"ALU base {base}")
        self.w(f"{d} = (u64)(uint32_t)({expr});")

    def _emit_call(self, pc: int, insn: Insn) -> None:
        mname = self.fninfo.call_map.get(pc)
        if mname is None:
            self.w("r0 = 0; /* unreachable call */")
            return
        mi = self.map_index[mname]
        d = self.prog.map_decl(mname)
        rows, cols = device_shape(d.kind, d.value_size, d.max_entries)
        hname = H.HELPERS[insn.imm].name
        if self.regs and (pc, 2) in self.fninfo.stack_args:
            key = _slot_ld(self.fninfo.stack_args[(pc, 2)], d.key_size)
        else:
            key = f"bpf_ld_stack(r2, {d.key_size})"
        # the value words of an update: a map row or the memory frame by
        # address, the register slots gathered into a local array
        nval = cols if d.kind in ("array", "perdev_array") else cols - 2
        src = "bpf_at(r3)"
        if self.regs and (pc, 3) in self.fninfo.stack_args:
            w0 = self.fninfo.stack_args[(pc, 3)] >> 3
            src = "v_"
            vals = ", ".join(_slot(w0 + k) for k in range(nval))
        m = f"M[{mi}]"
        if d.kind == "ringbuf":
            op = {"ringbuf_reserve": "reserve", "ringbuf_submit": "submit",
                  "ringbuf_discard": "discard"}[hname]
            call = f"bpf_ringbuf_{op}({m}, {d.max_entries}ULL, {cols}ULL)"
        else:
            fam = {"array": "array", "perdev_array": "array",
                   "hash": "hash", "lru_hash": "lru"}[d.kind]
            cap = f"{d.max_entries}ULL, {cols}ULL"
            if hname == "map_lookup_elem":
                call = f"bpf_{fam}_lookup({m}, {cap}, {key})"
            elif hname == "map_update_elem":
                call = f"bpf_{fam}_update({m}, {cap}, {key}, {src})"
                if src == "v_":
                    self.w(f"{{ const u64 v_[{nval}] = {{{vals}}};")
                    self.w(f"  r0 = {call}; }}")
                    self.w("r1 = 0; r2 = 0; r3 = 0; r4 = 0; r5 = 0;")
                    return
            elif hname == "ema_update":
                call = f"bpf_{fam}_ema({m}, {cap}, {key}, r3, r4)"
            else:
                raise CudacError(f"helper {hname} not supported in-kernel")
        self.w(f"r0 = {call};")
        self.w("r1 = 0; r2 = 0; r3 = 0; r4 = 0; r5 = 0;")

    # ---- loops and exits -------------------------------------------------
    def _visit(self, h: int) -> str:
        """Header visit count against the proven trip bound."""
        return (f"if (++v{h} > {self.fninfo.loop_bounds[h] + 1}ULL) "
                "return 0;")

    def emit_exit(self) -> None:
        self.w("return r0;")

    def _loop_head(self, h: int) -> None:
        self.w(f"u64 v{h} = 0;")
        if self._keeps_rolled(self.blocks.loops[h]):
            self.lines.append("#pragma unroll 1")
        self.w(self.LOOP)
        self.w("    " + self._visit(h))     # first in every iteration

    def _keeps_rolled(self, L) -> bool:
        """Whether the loop's body stores through a ctx or map pointer,
        or calls a map-writing helper or a bpf-to-bpf callee.  Unrolled
        in full, the chain such a body makes through one cell is folded
        by nvcc, which for some does not finish (a 65-step EMA of a map
        cell built for over 10 minutes); every other loop unrolls as
        nvcc chooses, which measured fastest."""
        for b in L.body:
            for pc in range(*self.blocks.ranges[b]):
                insn = self.insns[pc]
                if insn.op == "call_fn" or (insn.op == "call" and insn.imm
                                            in torchc.WRITING_HELPERS):
                    return True
                if is_store(insn.op):
                    info = self.fninfo.mem_info.get(pc)
                    if info is not None and info[0] != "stack":
                        return True
        return False

    # ---- goto skeleton -----------------------------------------------------
    def emit_goto(self) -> None:
        for h in sorted(self.blocks.loops):
            self.w(f"u64 v{h} = 0;")
        super().emit_goto()

    def _goto_block(self, bi: int) -> None:
        if bi in self.blocks.loops:
            self.w(self._visit(bi))

    def _jump(self, src: int, tgt: int) -> str:
        """A jump into a loop from outside it restarts the visit count."""
        if tgt == CFG.EXIT:
            return "return r0;"
        L = self.blocks.loops.get(tgt)
        reset = f"v{tgt} = 0; " if L is not None \
            and src not in L.body else ""
        return f"{{ {reset}goto B{tgt}; }}"

    def _if_jump(self, cond: str, jump: str) -> None:
        self.w(f"if ({cond}) {jump}")

    # ---- whole functions ---------------------------------------------------
    def _fn_body(self, fi: int) -> List[str]:
        self.fninfo = self.fns[fi]
        self.regs = self.routes[fi] == "regs"
        self.insns = list(self.fninfo.insns)
        self.blocks = self.fninfo.cfg
        self.lines = []
        self.indent = 1
        try:
            self.emit_structured()
        except StructAbort:
            self.structured = False
            if self.blocks.loops and self.regs:
                # a goto loop takes no unroll pragma: keep its frame in
                # memory, where nvcc cannot follow it (see _loop_head)
                self.routes = tuple("memory" if i == fi else r
                                    for i, r in enumerate(self.routes))
                self.regs = False
            self.lines = []
            self.indent = 1
            self.emit_goto()
        return self.lines

    def generate(self) -> str:
        nsub = len(self.prog.subprogs)
        p = self.prefix
        sig = (f"BPF_DEV u64 {p}fn{{}}(u64 *const *M, u64 r1, u64 r2, "
               "u64 r3, u64 r4, u64 r5)")
        out = [sig.format(i) + ";" for i in range(nsub)]
        for i in range(nsub):
            body = self._fn_body(1 + i)
            out += [sig.format(i) + " {",
                    f"    // frame route: {self.routes[1 + i]}",
                    "    u64 r0 = 0, r6 = 0, r7 = 0, r8 = 0, r9 = 0;"]
            out += self._frame(1 + i) + body + ["}", ""]
        body = self._fn_body(0)
        out += [f"BPF_DEV u64 {p}main(u64 *const *M, u64 *ctx) {{",
                f"    // frame route: {self.routes[0]}",
                "    u64 r0 = 0, r1 = bpf_ptr(ctx), r2 = 0, r3 = 0, r4 = 0,"
                " r5 = 0, r6 = 0, r7 = 0, r8 = 0, r9 = 0;"]
        out += self._frame(0) + body + ["}", ""]
        return "\n".join(out)

    def _frame(self, fi: int) -> List[str]:
        """Route ``memory``: a zeroed 512-byte local frame and ``r10`` its
        top.  Route ``regs``: each slot the function touches a zeroed
        ``u64`` local, and ``r10`` the plain version's tagged frame top,
        which only the verifier's offsets ever read."""
        if self.routes[fi] == "memory":
            return [f"    u64 fr[{STACK_SIZE // 8}] = {{}};",
                    f"    u64 r10 = bpf_ptr(fr + {STACK_SIZE // 8});",
                    "    (void)r10;"]
        words = sorted(frame_words(self.fns[fi], self.prog))
        out = [f"    u64 {_slot(w)} = 0;" for w in words]
        return out + [f"    u64 r10 = {u64c(torchc._STACK_TAG | STACK_SIZE)};",
                      "    (void)r10;"]


THREADS = 32            # one warp: the decision runs warp-uniform


@dataclasses.dataclass(frozen=True)
class KernelSource:
    """One program's translation unit.  ``device`` is the helper runtime
    (``header``) plus the program's ``__device__`` functions (``body``;
    host-compilable with ``BPF_DEV`` redefined); ``kernels`` holds the
    ``__global__`` entries — ``<prefix>kernel`` over u64 words and, for
    programs the pair tier takes, ``<prefix>kernel32`` over ``[lo, hi]``
    pairs — and ``launchers`` their C entries (``launcher`` is both).
    ``routes`` is each function's frame route (main first), ``threads``
    the block."""
    header: str
    body: str
    kernels: str
    launchers: str
    structured: bool
    routes: Tuple[str, ...]
    threads: int

    @property
    def device(self) -> str:
        return self.header + "\n" + self.body

    @property
    def launcher(self) -> str:
        return self.kernels + "\n" + self.launchers

    @property
    def full(self) -> str:
        return self.device + "\n" + self.launcher


def supports_pairs(prog: Program) -> bool:
    """The pair tier lowers no ``lru_hash`` map (the reference's rule)."""
    return not any(d.kind == "lru_hash" for d in prog.maps)


def _entry(prog: Program, p: str, word: str, suffix: str, threads: int,
           ret: List[str]) -> Tuple[List[str], List[str]]:
    """The kernel ``<p>kernel<suffix>`` and its launcher: one decision,
    run by every lane of the warp or by one thread, and thread 0's
    return word."""
    nm = len(prog.maps)
    kparams = ", ".join([f"{word} *ctx", f"{word} *ret"]
                        + [f"{word} *m{i}" for i in range(nm)])
    lparams = ", ".join(["void *ctx", "void *ret"]
                        + [f"void *m{i}" for i in range(nm)]
                        + ["void *stream"])
    kargs = ", ".join([f"({word} *)ctx", f"({word} *)ret"]
                      + [f"({word} *)m{i}" for i in range(nm)])
    margs = ", ".join(f"(u64 *)m{i}" for i in range(nm)) or "nullptr"
    k = [f"extern \"C\" __global__ void {p}kernel{suffix}({kparams}) {{",
         f"    u64 *const M[{max(nm, 1)}] = {{{margs}}};",
         f"    u64 r = {p}main(M, (u64 *)ctx);",
         "    if (threadIdx.x == 0) {", *ret, "    }", "}", ""]
    launch = [
        f"extern \"C\" int {p}launch{suffix}({lparams}) {{",
        f"    {p}kernel{suffix}<<<1, {threads}, 0, "
        f"(cudaStream_t)stream>>>({kargs});",
        "    return (int)cudaGetLastError();",
        "}",
        ""]
    return k, launch


def _attrs_entry(p: str, entries: List[str]) -> List[str]:
    """``<p>attrs(entry, out)`` reports an entry's
    ``cudaFuncGetAttributes``: local bytes, registers and shared bytes
    a thread."""
    return [f"extern \"C\" int {p}attrs(int entry, long long *out) {{",
            "    cudaFuncAttributes a;",
            "    cudaError_t err = " + " : ".join(
                f"entry == {i} ? cudaFuncGetAttributes(&a, {p}{e})"
                for i, e in enumerate(entries)) + " : cudaErrorInvalidValue;",
            "    if (err != cudaSuccess) return (int)err;",
            "    out[0] = (long long)a.localSizeBytes;",
            "    out[1] = (long long)a.numRegs;",
            "    out[2] = (long long)a.sharedSizeBytes;",
            "    return 0;", "}", ""]


def scans(prog: Program) -> bool:
    """Whether the program has a map its helpers scan (``hash``,
    ``lru_hash``): the rule that runs its decision warp-uniform."""
    return any(d.kind in ("hash", "lru_hash") for d in prog.maps)


def emit_source(prog: Program, vinfo, prefix: str = "bpf_", *,
                route: Optional[str] = None,
                one_thread: bool = False) -> KernelSource:
    """Generate the CUDA translation unit for a verified program.  Every
    program-specific symbol starts with ``prefix``, so several programs
    can share one translation unit (:func:`build_bundle`).

    The defaults are the kernel the port ships: each function's frame
    route by :func:`frame_route`, the decision warp-uniform on one warp
    where :func:`scans` holds, else on one thread.  ``route`` forces a
    frame route on every function; ``one_thread`` runs every decision on
    one thread (with ``route="memory"``, the earlier ``<<<1,1>>>``
    kernel, which ``chip_smoke.py`` times beside this one)."""
    if route not in (None, "regs", "memory"):
        raise CudacError(f"unknown frame route {route!r}")
    warp = scans(prog) and not one_thread
    gen = _CudaGen(prog, vinfo, prefix, route)
    if route == "regs" and "memory" in map(frame_route, gen.fns):
        raise CudacError(f"policy '{prog.name}': a function with a "
                         "variable stack offset cannot take route regs")
    body = gen.generate()
    header = (CSRC / "policy_kernel.cuh").read_text()
    if not warp:
        header = "#define BPF_WARP 0\n" + header
    threads = THREADS if warp else 1
    p = prefix
    kernels = [f"// policy '{prog.name}': frame routes "
               f"{', '.join(gen.routes)}; {threads} thread(s)"]
    k, launch = _entry(prog, p, "u64", "", threads, ["        *ret = r;"])
    kernels += k
    entries = ["kernel"]
    if supports_pairs(prog):
        # B2, the pair form: the same decision over uint32 [lo, hi]
        # operands, which hold the bytes of little-endian u64 words
        k32, launch32 = _entry(prog, p, "uint32_t", "32", threads,
                               ["        ret[0] = (uint32_t)r;",
                                "        ret[1] = (uint32_t)(r >> 32);"])
        kernels += k32
        launch += launch32
        entries.append("kernel32")
    launch += _attrs_entry(p, entries)
    return KernelSource(header=header, body=body,
                        kernels="\n".join(kernels),
                        launchers="\n".join(launch),
                        structured=gen.structured, routes=gen.routes,
                        threads=threads)


# ---------------------------------------------------------------------------
# build: nvcc -> .so, cached by source hash
# ---------------------------------------------------------------------------

_LIBS: Dict[str, ctypes.CDLL] = {}
_KEY_LOCKS: Dict[str, threading.Lock] = {}
_LOCK = threading.Lock()
_STATS = {"builds": 0, "cache_hits": 0}


def cache_stats() -> Dict[str, int]:
    """``builds`` (nvcc runs) and ``cache_hits`` (a library this process
    or an earlier one already built) — a warm reload adds only hits."""
    with _LOCK:
        return dict(_STATS)


def compile_library(src: str, name: str) -> ctypes.CDLL:
    """Build ``src`` with nvcc into ``BUILD_DIR`` (once per source hash)
    and load it; ``name`` says what the source is, for the errors."""
    key = hashlib.sha256(
        (" ".join(NVCC_FLAGS) + "\n" + src).encode()).hexdigest()[:24]
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is not None:
            _STATS["cache_hits"] += 1
            return lib
        klock = _KEY_LOCKS.setdefault(key, threading.Lock())
    with klock:
        with _LOCK:
            lib = _LIBS.get(key)
            if lib is not None:
                _STATS["cache_hits"] += 1
                return lib
        so = BUILD_DIR / f"bpf_{key}.so"
        built = False
        if not so.exists():
            nvcc = nvcc_path()
            if nvcc is None:
                raise CudacError(f"cannot build {name}: no nvcc on PATH or "
                                 "under /usr/local/cuda")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # source and library under names of this process and thread,
            # so another process building the same key never reads a
            # half-written file; only the finished .so is renamed in
            tmp = BUILD_DIR / f"bpf_{key}.{os.getpid()}.{threading.get_ident()}"
            cu = BUILD_DIR / f"{tmp.name}.cu"
            cu.write_text(src)
            try:
                r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                                    str(cu)], capture_output=True,
                                   timeout=NVCC_TIMEOUT_S)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise CudacError(f"nvcc did not run on {name}: {e}") from e
            finally:
                cu.unlink(missing_ok=True)
            if r.returncode != 0:
                raise CudacError(
                    f"nvcc failed ({r.returncode}) on {name} (source {key}): "
                    f"{r.stderr.decode(errors='replace')[:4000]}")
            os.replace(tmp, so)
            built = True
        lib = ctypes.CDLL(str(so))
        with _LOCK:
            _LIBS[key] = lib
            _STATS["builds" if built else "cache_hits"] += 1
        return lib


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def check_supported32(prog: Program) -> None:
    """Raise :class:`CudacError` if ``prog`` cannot run as the pair-form
    kernel: the ``cuda`` tier's rejections, and ``lru_hash`` maps (the
    reference's ``pallas32`` rejection, its text kept)."""
    try:
        torchc.check_supported(prog)
    except torchc.TorchcError as e:
        raise CudacError(
            f"policy '{prog.name}' cannot lower to the cuda32 tier: {e}"
        ) from e
    lru = [d.name for d in prog.maps if d.kind == "lru_hash"]
    if lru:
        raise CudacError(
            f"policy '{prog.name}' uses lru_hash map(s) "
            f"{', '.join(repr(n) for n in lru)}; the 32-bit-pair tier does "
            "not lower LRU recency/clock metadata.  Workarounds: declare "
            "the map with kind=\"hash\" (the fixed-capacity open-addressing "
            "table lowers in-graph on every tier, including cuda32 — you "
            "lose eviction, inserts fail with E2BIG when full), keep "
            "word_width=64 (tier=\"cuda\"), or run this policy on a host "
            "tier (interp), where lru_hash is fully supported")


class PolicyKernel:
    """One verified program as a CUDA kernel, with its plain version.

    ``launch(ctx, ret, maps)`` runs one decision in place: ``ctx`` is
    ``int64[n_fields]``, ``ret`` ``int64[1]``, each map
    ``int64[device_shape]``, all contiguous on one device.  On CUDA
    tensors it launches the kernel (one thread, or one warp for a
    program that scans, on the current stream, no synchronisation) and
    counts the launch in :attr:`launches`; on CPU tensors it runs
    :mod:`torchc`.

    ``launch32(ctx2, ret2, maps2)`` is the pair form (B2): ``ctx2``
    ``int32[n_fields, 2]``, ``ret2`` ``int32[2]``, each map
    ``int32[*device_shape, 2]``, every u64 as ``[lo, hi]``
    (:mod:`repro_torch.core.pair`); counted in :attr:`launches32`, its
    plain version is :func:`torchc.run32`.

    The kernel library is built at first CUDA use, or up front with
    :meth:`build`; ``prefix`` names the program's symbols in it;
    ``route`` and ``one_thread`` go to :func:`emit_source` (the defaults
    are the shipped design)."""

    def __init__(self, prog: Program, vinfo=None, *, prefix: str = "bpf_",
                 route: Optional[str] = None, one_thread: bool = False):
        try:
            torchc.check_supported(prog)
        except torchc.TorchcError as e:
            raise CudacError(
                f"policy '{prog.name}' cannot lower to the cuda tier: {e}"
            ) from e
        if vinfo is None:
            vinfo = verify_with_info(prog)
        self.prog = prog
        self.vinfo = vinfo
        self.prefix = prefix
        self.names = [d.name for d in prog.maps]
        self.shapes = {d.name: device_shape(d.kind, d.value_size,
                                            d.max_entries)
                       for d in prog.maps}
        self.n_fields = prog.ctx_type.size // 8
        # whether the pair-form entry exists (the pair tier's rule)
        self.pairs = supports_pairs(prog)
        self.source = emit_source(prog, vinfo, prefix, route=route,
                                  one_thread=one_thread)
        self.launches = 0
        self.launches32 = 0
        self._fn = None
        self._fn32 = None
        self._lib = None

    @property
    def name(self) -> str:
        return self.prog.name

    def _bind(self, lib: ctypes.CDLL) -> None:
        nargs = 3 + len(self.names)
        fn = getattr(lib, f"{self.prefix}launch")
        fn.argtypes = [ctypes.c_void_p] * nargs
        fn.restype = ctypes.c_int
        if self.pairs:
            fn32 = getattr(lib, f"{self.prefix}launch32")
            fn32.argtypes = [ctypes.c_void_p] * nargs
            fn32.restype = ctypes.c_int
            self._fn32 = fn32
        self._lib = lib
        self._fn = fn

    def attributes(self) -> Dict[str, Dict[str, int]]:
        """``cudaFuncGetAttributes`` of each built entry (``kernel``,
        and ``kernel32`` where the pair form exists): local bytes a
        thread, registers a thread, static shared bytes."""
        self.build()
        fn = getattr(self._lib, f"{self.prefix}attrs")
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        out = {}
        for i, entry in enumerate(["kernel"] + (["kernel32"] if self.pairs
                                                 else [])):
            vals = (ctypes.c_longlong * 3)()
            err = fn(i, vals)
            if err:
                raise CudacError(f"policy kernel '{self.name}': attributes "
                                 f"of {entry}: CUDA error {err}")
            out[entry] = dict(zip(("local_bytes", "registers",
                                   "shared_bytes"), vals))
        return out

    def build(self) -> "PolicyKernel":
        if self._fn is None:
            self._bind(compile_library(self.source.full,
                                       f"policy kernel '{self.name}'"))
        return self

    def _check(self, want, dtype, align: int) -> None:
        dev = want[0][1].device
        for what, t, shape in want:
            if t.device != dev or t.dtype != dtype \
                    or tuple(t.shape) != tuple(shape) \
                    or not t.is_contiguous() or t.data_ptr() % align:
                raise CudacError(
                    f"policy kernel '{self.name}': {what} must be a "
                    f"contiguous {str(dtype)[6:]}{list(shape)} on {dev}"
                    f"{f' aligned to {align} bytes' if align > 1 else ''}"
                    f", got {t.dtype}{list(t.shape)} on {t.device}")

    def _device_ok(self, dev: torch.device) -> None:
        if dev.type != "cuda":
            raise DeviceError(f"policy kernel '{self.name}': no kernel "
                              f"for device {dev}")
        if dev.index != torch.cuda.current_device():
            raise DeviceError(
                f"policy kernel '{self.name}': tensors on {dev} "
                f"but the current device is cuda:"
                f"{torch.cuda.current_device()}")

    def launch(self, ctx: torch.Tensor, ret: torch.Tensor,
               maps: Dict[str, torch.Tensor]) -> None:
        want = [("ctx", ctx, (self.n_fields,)), ("ret", ret, (1,))]
        want += [(n, maps[n], self.shapes[n]) for n in self.names]
        self._check(want, torch.int64, 1)
        if ctx.device.type == "cpu":
            r, c, ms = torchc.run(self.prog, self.vinfo, ctx, maps)
            ctx.copy_(c)
            ret[0] = r
            for n in self.names:
                maps[n].copy_(ms[n])
            return
        self._device_ok(ctx.device)
        self.build()
        err = self._fn(ctx.data_ptr(), ret.data_ptr(),
                       *[maps[n].data_ptr() for n in self.names],
                       torch.cuda.current_stream().cuda_stream)
        if err:
            raise CudacError(f"policy kernel '{self.name}' launch failed: "
                             f"CUDA error {err}")
        self.launches += 1

    def launch32(self, ctx2: torch.Tensor, ret2: torch.Tensor,
                 maps2: Dict[str, torch.Tensor]) -> None:
        if not self.pairs:
            check_supported32(self.prog)        # raises: lru_hash
        want = [("ctx", ctx2, (self.n_fields, 2)), ("ret", ret2, (2,))]
        want += [(n, maps2[n], (*self.shapes[n], 2)) for n in self.names]
        # the kernel reads each pair as one u64 word
        self._check(want, torch.int32, 8)
        if ctx2.device.type == "cpu":
            r, c, ms = torchc.run32(self.prog, self.vinfo, ctx2, maps2)
            ctx2.copy_(c)
            ret2.copy_(r)
            for n in self.names:
                maps2[n].copy_(ms[n])
            return
        self._device_ok(ctx2.device)
        self.build()
        err = self._fn32(ctx2.data_ptr(), ret2.data_ptr(),
                         *[maps2[n].data_ptr() for n in self.names],
                         torch.cuda.current_stream().cuda_stream)
        if err:
            raise CudacError(f"pair-form policy kernel '{self.name}' launch "
                             f"failed: CUDA error {err}")
        self.launches32 += 1


def build_all(kernels: Iterable) -> List:
    """Build every kernel (anything with a ``build()`` that returns it:
    policy kernels, the model kernels), one nvcc process per source, in
    parallel."""
    kernels = list(kernels)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        return list(ex.map(lambda k: k.build(), kernels))


def build_bundle(kernels: Iterable[PolicyKernel], per_library: int = 48
                 ) -> List[PolicyKernel]:
    """Build many small kernels into shared libraries of up to
    ``per_library`` programs each (one helper runtime per library, one
    nvcc process per library, all in parallel): nvcc's fixed cost per
    process dominates a program of a few instructions.  Programs whose
    helper runtime differs (one thread or a warp) go to libraries of
    their own.  Every kernel needs its own ``prefix``."""
    kernels = list(kernels)
    prefixes = [k.prefix for k in kernels]
    if len(set(prefixes)) != len(prefixes):
        raise CudacError("build_bundle: kernels share a symbol prefix")
    # one helper runtime a library: programs whose runtime differs (the
    # warp setting) go to libraries of their own
    by_header: Dict[str, List[PolicyKernel]] = {}
    for k in kernels:
        by_header.setdefault(k.source.header, []).append(k)
    groups = [ks[i:i + per_library] for ks in by_header.values()
              for i in range(0, len(ks), per_library)]

    def one(group: List[PolicyKernel]) -> None:
        src = "\n".join([group[0].source.header]
                         + [k.source.body + "\n" + k.source.launcher
                            for k in group])
        lib = compile_library(src, f"policy kernel bundle "
                              f"'{group[0].name}' .. '{group[-1].name}'")
        for k in group:
            k._bind(lib)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        list(ex.map(one, groups))
    return kernels
