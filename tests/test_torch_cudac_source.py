"""The emitted CUDA translation unit, run on the CPU.

The policy kernel's device code (the helper runtime ``csrc/
policy_kernel.cuh`` plus the program's generated ``__device__``
functions) is plain C++ behind the ``BPF_DEV`` macro.  These tests build
that part with the system C++ compiler (``BPF_DEV`` as ``static
inline``, a host entry calling ``bpf_main``), run it over the same seeded
maps and ctx samples as the plain PyTorch version and the interpreter,
and require all three to agree bit for bit (ret, ctx, every map word).
The shim lives only here; the cuda tier builds the full unit with nvcc.

Both emitters are covered: structured regions (every shipped policy)
and the label-per-block goto skeleton (forced); and both frame routes:
``regs`` (every stack slot a local, the shipped route of every shipped
policy and pair golden) and ``memory`` (the zeroed local frame: forced,
and taken by a function whose stack offsets are not all constant).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

import torch_samples as samples
from repro_torch.core import cudac, torchc
from repro_torch.core.emit import StructAbort
from repro_torch.core.verifier import verify_with_info
from repro_torch.core.vm import VM
from repro_torch.policies import ALL_POLICIES, LOOP_POLICIES
from repro_torch.policies.telemetry import TELEMETRY_POLICIES

N_SAMPLES = 6
_SHIM = ("#define BPF_DEV static inline\n", "\nextern \"C\" u64 "
         "bpf_host_run(u64 *ctx, u64 **maps) { return bpf_main(maps, ctx); }\n")


def _host_kernel(src: cudac.KernelSource, tmp_path, name: str):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no system C++ compiler")
    cpp = tmp_path / f"{name}.cpp"
    so = tmp_path / f"{name}.so"
    cpp.write_text(_SHIM[0] + src.device + _SHIM[1])
    r = subprocess.run([cxx, "-O1", "-shared", "-fPIC", "-w", "-o",
                        str(so), str(cpp)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[:4000]
    fn = ctypes.CDLL(str(so)).bpf_host_run
    fn.restype = ctypes.c_uint64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _host_unit(srcs, tmp_path, name: str) -> list:
    """Build many programs' device code into one host library, each
    under its own prefix (``p<i>_``), and return their entries."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no system C++ compiler")
    unit = [_SHIM[0], srcs[0].header]
    for i, s in enumerate(srcs):
        unit += [s.body, f'extern "C" u64 run{i}(u64 *ctx, u64 **maps) '
                 f'{{ return p{i}_main(maps, ctx); }}']
    cpp, so = tmp_path / f"{name}.cpp", tmp_path / f"{name}.so"
    cpp.write_text("\n".join(unit))
    r = subprocess.run([cxx, "-O1", "-shared", "-fPIC", "-w", "-o", str(so),
                        str(cpp)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[:4000]
    lib = ctypes.CDLL(str(so))
    fns = []
    for i in range(len(srcs)):
        fn = getattr(lib, f"run{i}")
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fns.append(fn)
    return fns


def _differential(prog, fn, seed: int) -> None:
    vinfo = verify_with_info(prog)
    names = [d.name for d in prog.maps]
    vm_maps = samples.make_maps(prog, np.random.default_rng(seed))
    host = {n: m.to_device().view("<i8").copy() for n, m in vm_maps.items()}
    plain = {n: torchc.map_to_array(m) for n, m in vm_maps.items()}
    vm = VM(prog.insns, vm_maps, subprogs=prog.subprogs)
    ptrs = (ctypes.c_void_p * max(1, len(names)))(
        *[host[n].ctypes.data for n in names])
    rng = np.random.default_rng(seed + 1)
    for _ in range(N_SAMPLES):
        buf = samples.make_ctx(prog, rng)
        ctx = np.frombuffer(bytes(buf), dtype="<i8").copy()
        ret = fn(ctx.ctypes.data, ctypes.addressof(ptrs))
        p_ret, p_ctx, plain = torchc.run(prog, vinfo,
                                         torchc.ctx_to_vec(buf), plain)
        v_buf = bytearray(buf)
        v_ret = vm.run(v_buf)
        assert ret == int(p_ret) & (2**64 - 1) == v_ret & (2**64 - 1)
        assert ctx.tobytes() == torchc.vec_to_bytes(p_ctx) == bytes(v_buf)
        for n in names:
            want = vm_maps[n].to_device().view("<i8")
            assert np.array_equal(host[n], want), n
            assert np.array_equal(plain[n].numpy(), want), n


@pytest.mark.parametrize("pol", ALL_POLICIES, ids=lambda p: p.program.name)
def test_emitted_kernel_matches_plain_version_and_vm(pol, tmp_path):
    prog = pol.program
    src = cudac.emit_source(prog, verify_with_info(prog))
    assert src.structured
    assert set(src.routes) == {"regs"} and "bpf_ld_stack(" not in src.body
    fn = _host_kernel(src, tmp_path, prog.name)
    _differential(prog, fn, sum(map(ord, prog.name)))


@pytest.mark.parametrize("pol", ALL_POLICIES, ids=lambda p: p.program.name)
def test_memory_route_matches_plain_version_and_vm(pol, tmp_path):
    """The earlier frame, forced on every function: the same decision."""
    prog = pol.program
    src = cudac.emit_source(prog, verify_with_info(prog), route="memory")
    assert set(src.routes) == {"memory"} and "u64 fr[64] = {};" in src.body
    fn = _host_kernel(src, tmp_path, prog.name + "_memory")
    _differential(prog, fn, sum(map(ord, prog.name)))


@pytest.mark.parametrize("route", ["regs", "memory"])
def test_pair_goldens_on_both_routes(route, tmp_path):
    """Every pair golden's device code (the ``bpf_main`` both entries
    run) against the interpreter and the plain version, on one frame
    route: sub-word stack writes, full-row updates, loops."""
    import repro_torch.core as C
    _goldens_agree(C, samples.pair_goldens(), route, tmp_path)


def _goldens_agree(C, gs, route: str, tmp_path) -> None:
    """``gs``' device code on ``route``, one host library, each program
    on ``PAIR_CTX`` and its seeded maps against the interpreter and the
    plain version (ret, ctx, every map word)."""
    progs = [g.program(C) for g in gs]
    vinfos = [verify_with_info(p) for p in progs]
    srcs = [cudac.emit_source(p, v, prefix=f"p{i}_",
                              route=None if route == "regs" else route)
            for i, (p, v) in enumerate(zip(progs, vinfos))]
    assert {r for s in srcs for r in s.routes} == {route}
    fns = _host_unit(srcs, tmp_path, f"goldens_{route}")
    for g, prog, vinfo, fn in zip(gs, progs, vinfos, fns):
        host = g.host_maps(C)
        names = [d.name for d in prog.maps]
        words = {n: m.to_device().view("<i8").copy() for n, m in host.items()}
        plain = {n: torchc.map_to_array(m) for n, m in host.items()}
        buf = C.make_ctx("tuner", **samples.PAIR_CTX).buf
        ctx = np.frombuffer(bytes(buf), dtype="<i8").copy()
        ptrs = (ctypes.c_void_p * max(1, len(names)))(
            *[words[n].ctypes.data for n in names])
        ret = fn(ctx.ctypes.data, ctypes.addressof(ptrs))
        p_ret, p_ctx, plain = torchc.run(prog, vinfo, torchc.ctx_to_vec(buf),
                                         plain)
        v_buf = bytearray(buf)
        v_ret = VM(prog.insns, host).run(v_buf) & (2**64 - 1)
        assert ret == int(p_ret) & (2**64 - 1) == v_ret, g.id
        assert ctx.tobytes() == torchc.vec_to_bytes(p_ctx) == bytes(v_buf), \
            g.id
        for n in names:
            want = host[n].to_device().view("<i8")
            assert np.array_equal(words[n], want), (g.id, n)
            assert np.array_equal(plain[n].numpy(), want), (g.id, n)


# a load and a store through a stack pointer whose offset is one of two
# (comm_id & 8 picks it), then a lookup whose key sits at such an offset
_VAR_OFFSET_ASM = """
    stdw   [r10-8], 11
    stdw   [r10-16], 22
    stdw   [r10-24], 33
    ldxdw  r3, [r1+comm_id]
    and64i r3, 8
    mov64  r2, r10
    add64i r2, -16
    add64  r2, r3
    ldxdw  r0, [r2+0]
    stxdw  [r2-8], r0
    ldxdw  r4, [r10-16]
    add64  r0, r4
    ldxdw  r4, [r10-24]
    add64  r0, r4
    mov64  r6, r0
    ldmap  r1, var_map
    mov64  r2, r10
    add64i r2, -24
    add64  r2, r3
    call   map_lookup_elem
    jeqi   r0, 0, miss
    ldxdw  r3, [r0+0]
    add64  r6, r3
miss:
    mov64  r0, r6
    exit
"""


def _var_offset_prog():
    from repro_torch.core import assemble, map_decl
    decl = map_decl("var_map", kind="array", value_size=8, max_entries=64)
    return assemble(_VAR_OFFSET_ASM, name="var_offset", section="tuner",
                    maps=(decl,))


def _sub_prog(main_asm: str, sub_asm: str, n_args: int, name: str):
    """A program whose main calls one subprogram where ``main_asm`` has
    ``mov64 r0, 4242`` (the assembler spells no ``call_fn``)."""
    from repro_torch.core import assemble
    from repro_torch.core.isa import Insn
    from repro_torch.core.program import Program, SubProgram
    main = assemble(main_asm, name=name, section="tuner")
    insns = [Insn("call_fn", imm=0) if i.op == "mov64i" and i.imm == 4242
             else i for i in main.insns]
    sub = assemble(sub_asm, name=name + "_f", section="tuner")
    return Program(name, "tuner", insns,
                   subprogs=(SubProgram("f", tuple(sub.insns), n_args),))


def test_variable_stack_offset_takes_the_memory_route(tmp_path):
    """A variable-offset stack load, store and helper key: the verifier
    admits them (stack pointers are intervals), ``frame_route`` sends
    the function to the memory frame, a forced ``regs`` is refused, and
    the decision agrees with the interpreter and the plain version."""
    from repro_torch.core.isa import STACK_SIZE
    prog = _var_offset_prog()
    vinfo = verify_with_info(prog)
    offs = {info[2] for info in vinfo.mem_info.values()
            if info[0] == "stack"}
    assert None in offs and STACK_SIZE in offs
    assert None in vinfo.stack_args.values()
    src = cudac.emit_source(prog, vinfo)
    assert src.routes == ("memory",) and "bpf_ld_stack(" in src.body
    with pytest.raises(cudac.CudacError, match="variable stack offset"):
        cudac.emit_source(prog, vinfo, route="regs")
    fn = _host_kernel(src, tmp_path, "var_offset")
    _differential(prog, fn, 5)


def test_stack_pointer_never_reaches_a_callee(tmp_path):
    """A stack pointer passed as a callee's argument is rejected by the
    verifier (the callee's frame is fresh), so no verified function
    needs the memory route for it.  One left in a register the callee
    does not take is dead there: both functions take route regs and
    agree with the interpreter and the plain version."""
    from repro_torch.core.verifier import VerifierError
    sub = """
        mov64  r0, r1
        stxdw  [r10-8], r0
        ldxdw  r0, [r10-8]
        add64i r0, 7
        exit
    """
    passed = _sub_prog("""
        mov64  r1, r10
        add64i r1, -8
        stdw   [r10-8], 3
        mov64  r0, 4242
        exit
    """, sub, 1, "ptr_arg")
    with pytest.raises(VerifierError, match="scalar arguments only"):
        verify_with_info(passed)
    stale = _sub_prog("""
        stdw   [r10-8], 3
        ldxdw  r1, [r10-8]
        mov64  r2, r10
        add64i r2, -8
        mov64  r0, 4242
        ldxdw  r3, [r10-8]
        add64  r0, r3
        exit
    """, sub, 1, "stale_ptr")
    vinfo = verify_with_info(stale)
    src = cudac.emit_source(stale, vinfo)
    assert src.routes == ("regs", "regs")
    fn = _host_kernel(src, tmp_path, "stale_ptr")
    _differential(stale, fn, 9)


@pytest.mark.parametrize("pol", LOOP_POLICIES + TELEMETRY_POLICIES,
                         ids=lambda p: p.program.name)
def test_goto_skeleton_matches(pol, tmp_path, monkeypatch):
    """Loops and bpf-to-bpf calls through the goto fallback."""
    def abort(self):
        raise StructAbort
    monkeypatch.setattr(cudac._CudaGen, "emit_structured", abort)
    prog = pol.program
    src = cudac.emit_source(prog, verify_with_info(prog))
    assert not src.structured and "goto B" in src.device
    # a function whose loops take the goto skeleton keeps the memory frame
    for fi, route in zip(torchc.fn_infos(verify_with_info(prog)),
                         src.routes):
        assert route == ("memory" if fi.cfg.loops else "regs")
    fn = _host_kernel(src, tmp_path, prog.name + "_goto")
    _differential(prog, fn, 7)


_WRAP_ASM = """
    ldxdw  r2, [r1+comm_id]
    and64i r2, 3
    mul64i r2, 100
    add64i r2, 99
    stxdw  [r10-8], r2
    ldmap  r1, wrap_map
    mov64  r2, r10
    add64i r2, -8
    call   map_lookup_elem
    jeqi   r0, 0, miss
    ldxdw  r3, [r0+0]
    add64i r3, 1
    stxdw  [r0+0], r3
    mov64  r0, r3
    exit
miss:
    stdw   [r10-16], 7
    ldmap  r1, wrap_map
    mov64  r2, r10
    add64i r2, -8
    mov64  r3, r10
    add64i r3, -16
    mov64  r4, 0
    call   map_update_elem
    exit
"""


def test_hash_probe_wraps_like_the_host_map(tmp_path):
    """A 100-row hash table whose keys all home to row 99: the host packs
    the chain 99 -> 0 -> 1 -> 2, and every tier must find (and extend) it
    there.  (The reference lowering misses keys past the wrap when the
    capacity is not a power of two — ROADMAP C2.)"""
    from repro_torch.core import assemble, map_decl
    from repro_torch.core.maps import MapRegistry

    decl = map_decl("wrap_map", kind="hash", key_size=8, value_size=8,
                    max_entries=100)
    prog = assemble(_WRAP_ASM, name="wrap", section="tuner", maps=(decl,))
    vinfo = verify_with_info(prog)
    fn = _host_kernel(cudac.emit_source(prog, vinfo), tmp_path, "wrap")
    m = MapRegistry().create("wrap_map", "hash", key_size=8, value_size=8,
                             max_entries=100)
    for k, v in ((99, 5), (199, 6), (299, 7)):
        m.update_u64(k, v)
    host = m.to_device().view("<i8").copy()
    assert list(host[[99, 0, 1], 1]) == [99, 199, 299]
    plain = {"wrap_map": torchc.map_to_array(m)}
    vm = VM(prog.insns, {"wrap_map": m})
    ptrs = (ctypes.c_void_p * 1)(host.ctypes.data)
    rets = []
    for comm in range(8):
        buf = bytearray(prog.ctx_type.size)
        off = prog.ctx_type.offset_of("comm_id")
        buf[off:off + 8] = comm.to_bytes(8, "little")
        ctx = np.frombuffer(bytes(buf), dtype="<i8").copy()
        ret = fn(ctx.ctypes.data, ctypes.addressof(ptrs))
        p_ret, _, plain = torchc.run(prog, vinfo, torchc.ctx_to_vec(buf),
                                     plain)
        assert ret == int(p_ret) == vm.run(bytearray(buf))
        rets.append(ret)
    assert rets == [6, 7, 8, 0, 7, 8, 9, 8]     # found past the wrap
    want = m.to_device().view("<i8")
    assert np.array_equal(host, want)
    assert np.array_equal(plain["wrap_map"].numpy(), want)


def test_translation_unit_shape():
    """One warp on the caller's stream, a C launcher that reports
    cudaGetLastError, maps passed as device pointers, sm_90a; the
    earlier design (route memory, one thread) is the <<<1,1>>>
    kernel."""
    prog = TELEMETRY_POLICIES[0].program
    src = cudac.emit_source(prog, verify_with_info(prog))
    assert "bpf_kernel<<<1, 32, 0, (cudaStream_t)stream>>>" in src.launcher
    assert "    u64 *const M[1] = {(u64 *)m0};" in src.kernels
    assert not src.header.startswith("#define BPF_WARP 0\n")
    earlier = cudac.emit_source(prog, verify_with_info(prog),
                                route="memory", one_thread=True)
    assert "bpf_kernel<<<1, 1, 0, (cudaStream_t)stream>>>" in \
        earlier.launcher
    assert earlier.header.startswith("#define BPF_WARP 0\n")
    assert set(earlier.routes) == {"memory"}
    assert "return (int)cudaGetLastError();" in src.launcher
    assert 'extern "C" int bpf_launch(void *ctx, void *ret, void *m0, ' \
        'void *stream)' in src.launcher
    assert "arch=compute_90a,code=sm_90a" in cudac.NVCC_FLAGS
    assert src.full.startswith(src.device)


def test_only_loops_that_write_through_helpers_keep_nvcc_from_unrolling():
    """Every loop of the shipped policies is left to nvcc's unroller; a
    loop that calls a map-writing helper (the pair goldens' 65-step
    EMA) or stores through a map pointer gets ``#pragma unroll 1``; a
    chain through a stack slot or a register does not."""
    import repro_torch.core as C
    for pol in ALL_POLICIES:
        prog = pol.program
        assert "#pragma" not in cudac.emit_source(
            prog, verify_with_info(prog)).body
    emas = [g.program(C) for g in samples.pair_goldens()
            if g.id.startswith("inloop_ema")]
    assert emas
    for prog in emas:
        body = cudac.emit_source(prog, verify_with_info(prog)).body
        assert "#pragma unroll 1\n    while (1) {" in body
    for g in samples.loop_chain_goldens():
        prog = g.program(C)
        body = cudac.emit_source(prog, verify_with_info(prog)).body
        assert ("#pragma unroll 1\n    while (1) {" in body) == \
            g.id.endswith("lookup_store"), g.id


@pytest.mark.parametrize("route", ["regs", "memory"])
def test_loop_chains_on_both_routes(route, tmp_path):
    """The 65-step chains through a map cell, a stack slot and a
    register (``torch_samples.loop_chain_goldens``): the device code on
    each frame route against the interpreter and the plain version."""
    import repro_torch.core as C
    gs = samples.loop_chain_goldens()
    _goldens_agree(C, gs, route, tmp_path)


def test_same_program_same_source():
    """The source is address-free, so the build cache keys on it and a
    warm link.replace() finds the library already built."""
    prog = ALL_POLICIES[0].program
    a = cudac.emit_source(prog, verify_with_info(prog)).full
    b = cudac.emit_source(prog, verify_with_info(prog)).full
    assert a == b


def test_cpu_tensors_run_the_plain_version_in_place():
    import torch
    pol = TELEMETRY_POLICIES[0]
    prog = pol.program
    k = cudac.PolicyKernel(prog)
    maps = samples.make_maps(prog, np.random.default_rng(3))
    arrays = {n: torchc.map_to_array(m) for n, m in maps.items()}
    buf = samples.make_ctx(prog, np.random.default_rng(4))
    want = torchc.run(prog, k.vinfo, torchc.ctx_to_vec(buf), arrays)
    ctx = torchc.ctx_to_vec(buf)
    ret = torch.zeros(1, dtype=torch.int64)
    k.launch(ctx, ret, arrays)
    assert int(ret[0]) == int(want[0])
    assert torch.equal(ctx, want[1])
    assert all(torch.equal(arrays[n], want[2][n]) for n in arrays)
    assert k.launches == 0              # no kernel ran
    with pytest.raises(cudac.CudacError, match="contiguous int64"):
        k.launch(ctx.to(torch.int32), ret, arrays)


def test_prefixed_programs_share_one_translation_unit(tmp_path):
    """``build_bundle``'s layout: one helper runtime, then each program's
    functions under its own symbol prefix (bpf-to-bpf callees included)
    — the unit builds once and every program still runs bit-exact."""
    progs = [p.program for p in TELEMETRY_POLICIES]
    srcs = [cudac.emit_source(p, verify_with_info(p), prefix=f"p{i}_")
            for i, p in enumerate(progs)]
    fns = _host_unit(srcs, tmp_path, "bundle")
    for i, (prog, fn) in enumerate(zip(progs, fns)):
        _differential(prog, fn, 11 + i)
