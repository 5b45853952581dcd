"""The policy kernel's whole ``__global__`` entry (B1 and B2) on the CPU.

No ``nvcc`` here, so the kernel half of the emitted translation unit —
the helper runtime, the program's functions and the kernels, without
the host launchers — builds as host C++ against ``tests/cuda_emu/``
(each CUDA thread a ``std::thread``, barriers for ``__syncthreads``,
``__syncwarp`` and the warp votes and shuffles).  What runs is what the
card runs: the warp-uniform decision of a program with a scanned map
(lane-0 stores, the warp scans of the hash probe and the LRU key and
victim) and the one-thread decision of any other.  Every output (ret,
ctx, every map word) is held bit for bit to the interpreter and the
plain version (``torchc.run``).

Covered: every shipped policy's shipped kernel on phase 3's seeded maps
and samples (``chip_smoke.py`` seeds them ``100 + i``), through
``kernel`` and, where the pair tier takes the program, ``kernel32``;
ctx and maps only 8-byte aligned; and hash chains of more than 32 rows
that wrap (ROADMAP C2), in tables of 100, 2,100 and 10,000 rows.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

import torch_samples as samples
from repro_torch.core import cudac, torchc
from repro_torch.core.verifier import verify_with_info
from repro_torch.core.vm import VM
from repro_torch.policies import ALL_POLICIES

EMU = Path(__file__).resolve().parent / "cuda_emu"
N_SAMPLES = 6
M64 = (1 << 64) - 1

_PRELUDE = """#include "cuda_runtime.h"
#define BPF_KERNEL 1
"""


def _build(srcs, tmp_path, name: str):
    """Host libraries holding each source's kernels (prefix ``p<i>_``;
    one library a helper runtime, as ``cudac.build_bundle`` groups them)
    and, for each, a runner ``p<i>_run(ctx, ret, maps, pairs)`` that
    launches one block of the source's threads under the emulation."""
    groups = {}
    for i, (_, s) in enumerate(srcs):
        groups.setdefault(s.header, []).append(i)
    runs = [None] * len(srcs)
    for j, idx in enumerate(groups.values()):
        lib = _build_one([(i, *srcs[i]) for i in idx], tmp_path, f"{name}{j}")
        for i in idx:
            fn = getattr(lib, f"p{i}_run")
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
            runs[i] = fn
    return runs


def _build_one(srcs, tmp_path, name: str):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    unit = [_PRELUDE, srcs[0][2].header]
    for i, prog, s in srcs:
        nm = len(prog.maps)
        args = lambda w: ", ".join(   # noqa: E731
            [f"({w} *)ctx", f"({w} *)ret"]
            + [f"({w} *)maps[{j}]" for j in range(nm)])
        call32 = (f"p{i}_kernel32({args('uint32_t')});"
                  if cudac.supports_pairs(prog) else "")
        unit += [s.body, s.kernels,
                 f'extern "C" void p{i}_run(void *ctx, void *ret, '
                 f'void **maps, int pairs) {{',
                 f"    emu::launch(dim3(1), {s.threads}, [&] {{",
                 f"        if (pairs) {{ {call32} }}",
                 f"        else p{i}_kernel({args('u64')});",
                 "    });", "}"]
    cpp, so = tmp_path / f"{name}.cpp", tmp_path / f"{name}.so"
    cpp.write_text("\n".join(unit))
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-Wno-psabi",
                        "-w", "-shared", "-fPIC", f"-I{EMU}", "-o", str(so),
                        str(cpp)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[:4000]
    return ctypes.CDLL(str(so))


def _aligned(words: np.ndarray, misalign: bool) -> tuple:
    """A copy of ``words`` (int64) starting 16-byte aligned, or 8 bytes
    past that, and the array holding it."""
    n = words.size
    buf = np.zeros(n + 4, dtype="<i8")
    start = (-buf.ctypes.data % 16) // 8 + (1 if misalign else 0)
    view = buf[start:start + n]
    view[:] = words.reshape(-1)
    assert (view.ctypes.data % 16 == 8) == misalign
    return view, buf


def _run(fn, prog, vinfo, host, bufs, pairs=False, misalign=False) -> None:
    """Each ctx buffer through the emulated entry, the plain version and
    the interpreter in turn, the maps carried along on every side."""
    names = [d.name for d in prog.maps]
    keep = []
    words = {}
    for n, m in host.items():
        words[n], b = _aligned(m.to_device().view("<i8"), misalign)
        keep.append(b)
    plain = {n: torchc.map_to_array(m) for n, m in host.items()}
    vm = VM(prog.insns, host, subprogs=prog.subprogs)
    ptrs = (ctypes.c_void_p * max(1, len(names)))(
        *[words[n].ctypes.data for n in names])
    for buf in bufs:
        ctx, cb = _aligned(np.frombuffer(bytes(buf), "<i8"), misalign)
        ret = np.zeros(1, dtype="<u8")
        fn(ctx.ctypes.data, ret.ctypes.data, ctypes.addressof(ptrs),
           int(pairs))
        p_ret, p_ctx, plain = torchc.run(prog, vinfo, torchc.ctx_to_vec(buf),
                                         plain)
        v_buf = bytearray(buf)
        v_ret = vm.run(v_buf) & M64
        assert int(ret[0]) == int(p_ret) & M64 == v_ret, prog.name
        assert ctx.tobytes() == torchc.vec_to_bytes(p_ctx) == bytes(v_buf)
        for n in names:
            want = host[n].to_device().view("<i8")
            assert np.array_equal(words[n], want.reshape(-1)), (prog.name, n)
            assert np.array_equal(plain[n].numpy(), want), (prog.name, n)


def _samples(prog, seed: int):
    rng = np.random.default_rng(seed + 1)
    return [samples.make_ctx(prog, rng) for _ in range(N_SAMPLES)]


@pytest.fixture(scope="module")
def shipped(tmp_path_factory):
    """Every shipped policy's shipped kernel, one library."""
    progs = [p.program for p in ALL_POLICIES]
    srcs = [(p, cudac.emit_source(p, verify_with_info(p), prefix=f"p{i}_"))
            for i, p in enumerate(progs)]
    return srcs, _build(srcs, tmp_path_factory.mktemp("emu"), "shipped")


@pytest.mark.parametrize("i", range(len(ALL_POLICIES)),
                         ids=[p.program.name for p in ALL_POLICIES])
def test_entry_matches_plain_version_and_vm(shipped, i):
    srcs, runs = shipped
    prog, src = srcs[i]
    assert set(src.routes) == {"regs"}
    assert src.threads == (32 if cudac.scans(prog) else 1)
    vinfo = verify_with_info(prog)
    seed = 100 + i                              # phase 3's seeds
    host = samples.make_maps(prog, np.random.default_rng(seed))
    _run(runs[i], prog, vinfo, host, _samples(prog, seed))
    if cudac.supports_pairs(prog):
        host = samples.make_maps(prog, np.random.default_rng(seed))
        _run(runs[i], prog, vinfo, host, _samples(prog, seed), pairs=True)


_VIEWS = ("straggler_trap", "latency_histogram", "adapt_tuner",
          "histogram_bucket_tuner", "slo_enforcer", "bucket_tuner")


def test_entry_on_bases_aligned_to_8_only(shipped):
    """ctx and every map 8 bytes past a 16-byte bound, as a view of a
    larger buffer can be (``bridge._io``, a shard's slice): the one-thread
    and the warp-uniform decisions read and write them in place."""
    srcs, runs = shipped
    names = [p.program.name for p in ALL_POLICIES]
    for name in _VIEWS:
        i = names.index(name)
        prog = srcs[i][0]
        seed = 100 + i
        host = samples.make_maps(prog, np.random.default_rng(seed))
        _run(runs[i], prog, verify_with_info(prog), host,
             _samples(prog, seed), misalign=True)


def test_hash_chains_wrap_and_state_past_the_budget(tmp_path):
    """A 100-row table whose 40-key chain wraps past row 99 and spans
    two 32-row windows of the warp probe, and the same keys in tables of
    2,100 and 10,000 rows (50.4 and 240 KB, past what a block's shared
    memory could stage; 66 and 313 windows for an absent key), all read
    in device memory: hits, misses and inserts agree with the serial
    walk."""
    cases = [samples.hash_chain_case(n) for n in (100, 2100, 10_000)]
    srcs = [(prog, cudac.emit_source(prog, verify_with_info(prog),
                                     prefix=f"p{j}_"))
            for j, (prog, _, _) in enumerate(cases)]
    assert all(s.threads == 32 for _, s in srcs)
    rows = cases[0][1]["chain_map"].to_device()
    assert list(rows[[99, 0, 38], 1]) == [99, 199, 3999]  # past the wrap
    runs = _build(srcs, tmp_path, "chains")
    for (prog, host, bufs), fn in zip(cases, runs):
        _run(fn, prog, verify_with_info(prog), host, bufs)


_TWINS = r"""
#include "cuda_runtime.h"
#include <cstdint>
// lane l of the warp: ballot of (l % 3 == 0), the value of lane
// (l * 7) % 32, a 64-bit butterfly partner, __ffs of a few words
extern "C" void twins(unsigned *ballot, int *idx, unsigned long long *bfly,
                      int *ffs) {
    emu::launch(dim3(1), 32, [&] {
        unsigned l = threadIdx.x;
        ballot[l] = __ballot_sync(0xffffffffu, l % 3 == 0);
        idx[l] = __shfl_sync(0xffffffffu, (int)(1000 + l), (l * 7) % 32);
        bfly[l] = __shfl_xor_sync(0xffffffffu,
                                  (0x100000000ULL << (l % 4)) + l, 5);
        ffs[l] = __ffs(l == 0 ? 0u : (1u << (l % 32)) | 0x80000000u);
    });
}
"""


def test_warp_twins_follow_the_ptx_isa(tmp_path):
    """``__ballot_sync`` (bit l = lane l's predicate), ``__shfl_sync``
    (the source lane's value), the 64-bit ``__shfl_xor_sync`` (lane
    l ^ mask's value, all 64 bits) and ``__ffs`` (1-based lowest set
    bit, 0 for 0) of the emulation."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    cpp, so = tmp_path / "twins.cpp", tmp_path / "twins.so"
    cpp.write_text(_TWINS)
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-w",
                        "-shared", "-fPIC", f"-I{EMU}", "-o", str(so),
                        str(cpp)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[:4000]
    ballot = np.zeros(32, dtype=np.uint32)
    idx = np.zeros(32, dtype=np.int32)
    bfly = np.zeros(32, dtype=np.uint64)
    ffs = np.zeros(32, dtype=np.int32)
    ctypes.CDLL(str(so)).twins(*(a.ctypes.data_as(ctypes.c_void_p)
                                 for a in (ballot, idx, bfly, ffs)))
    want = sum(1 << lane for lane in range(32) if lane % 3 == 0)
    assert list(ballot) == [want] * 32
    assert list(idx) == [1000 + (lane * 7) % 32 for lane in range(32)]
    assert list(bfly) == [(0x100000000 << ((lane ^ 5) % 4)) + (lane ^ 5)
                          for lane in range(32)]
    assert list(ffs) == [0] + [lane + 1 for lane in range(1, 32)]
