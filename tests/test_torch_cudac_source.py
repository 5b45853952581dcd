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
and the label-per-block goto skeleton (forced).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

import torch_samples as samples
from repro_torch.core import cudac, torchc
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
    fn = _host_kernel(src, tmp_path, prog.name)
    _differential(prog, fn, sum(map(ord, prog.name)))


@pytest.mark.parametrize("pol", LOOP_POLICIES + TELEMETRY_POLICIES,
                         ids=lambda p: p.program.name)
def test_goto_skeleton_matches(pol, tmp_path, monkeypatch):
    """Loops and bpf-to-bpf calls through the goto fallback."""
    def abort(self):
        raise cudac._StructAbort
    monkeypatch.setattr(cudac._CudaGen, "emit_structured", abort)
    prog = pol.program
    src = cudac.emit_source(prog, verify_with_info(prog))
    assert not src.structured and "goto B" in src.device
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
    """One <<<1,1>>> kernel on the caller's stream, a C launcher that
    reports cudaGetLastError, maps passed as device pointers, sm_90a."""
    prog = TELEMETRY_POLICIES[0].program
    src = cudac.emit_source(prog, verify_with_info(prog))
    assert "bpf_kernel<<<1, 1, 0, (cudaStream_t)stream>>>" in src.launcher
    assert "return (int)cudaGetLastError();" in src.launcher
    assert 'extern "C" int bpf_launch(void *ctx, void *ret, void *m0, ' \
        'void *stream)' in src.launcher
    assert "arch=compute_90a,code=sm_90a" in cudac.NVCC_FLAGS
    assert src.full.startswith(src.device)


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
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no system C++ compiler")
    progs = [p.program for p in TELEMETRY_POLICIES]
    srcs = [cudac.emit_source(p, verify_with_info(p), prefix=f"p{i}_")
            for i, p in enumerate(progs)]
    unit = [_SHIM[0], srcs[0].header]
    for i, s in enumerate(srcs):
        unit += [s.body, f'extern "C" u64 run{i}(u64 *ctx, u64 **maps) '
                 f'{{ return p{i}_main(maps, ctx); }}']
    cpp, so = tmp_path / "bundle.cpp", tmp_path / "bundle.so"
    cpp.write_text("\n".join(unit))
    r = subprocess.run([cxx, "-O1", "-shared", "-fPIC", "-w", "-o", str(so),
                        str(cpp)], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[:4000]
    lib = ctypes.CDLL(str(so))
    for i, prog in enumerate(progs):
        fn = getattr(lib, f"run{i}")
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        _differential(prog, fn, 11 + i)
