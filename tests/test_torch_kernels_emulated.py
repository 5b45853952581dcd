"""The model kernels' CUDA code, run on the CPU against the plain versions.

There is no ``nvcc`` and no card here, so the CUDA kernels of
``src/repro_torch/kernels/*/csrc/*.cu`` cannot run as written.  Their
kernel halves (everything before the ``extern "C"`` launchers) build as
host C++ against ``tests/cuda_emu/``: a stand-in runtime that runs each
CUDA thread of a block as a ``std::thread``, with barriers for
``__syncthreads``, the warp shuffles and the warpgroups, and CPU twins
of the inline PTX: ``ptx.h`` for flash attention's tensor-core kernel
(``mma.sync``, ``ldmatrix``, ``cvt.rn.bf16x2``, ``ex2.approx``,
``cp.async``) and ``hopper.h`` for the grouped matmul's ``wgmma``
kernel (``wgmma.mma_async`` read through its shared-memory descriptors,
its fence, commit and wait; the 3-D TMA tile load with its swizzle and
zero fill; ``mbarrier`` arrivals, transaction counts and parity waits
that block across the threads), all after the PTX ISA's layouts.  Each
twin is also held here against a plain matrix product, rounding, power
or copy built from the ISA's documented layout.  The kernels' own index
arithmetic, tiling, masking, pipelines, reductions and roundings then
run on the CPU, at small shapes that cross their tiles' edges, and are
held against the plain versions with the reference's tolerance (rtol =
atol = 2e-5 in float32, 2e-2 in bfloat16).  What only the card can show
(that ``nvcc`` accepts the source, launch limits, shared-memory sizes,
the speed) is ``tests/test_torch_kernels_cuda.py``'s and
``chip_smoke.py``'s.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_samples as samples
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.grouped_matmul import kernel as gmm
from repro_torch.kernels._build import DTYPE_CODE
from repro_torch.kernels.rmsnorm import kernel as rms

ROOT = Path(__file__).resolve().parents[1]
EMU = ROOT / "tests" / "cuda_emu"
CSRC = ROOT / "src" / "repro_torch" / "kernels"
SOURCES = {"rms": "rmsnorm/csrc/rmsnorm.cu",
           "gmm": "grouped_matmul/csrc/grouped_matmul.cu",
           "fla": "flash_attention/csrc/flash_attention.cu"}
BF16 = torch.bfloat16
# the harness's dtype arguments
TAG = {torch.float32: "f32", BF16: "bf16", torch.float16: "f16"}


def kernel_half(cu: str, ns: str) -> str:
    """The part of a kernel source before its ``extern "C"`` launchers,
    as host C++: its anonymous namespace named ``ns``, dynamic shared
    memory a plain ``extern`` array, the ``<<<...>>>`` launches gone."""
    text = cu[:cu.index("}  // namespace")] + "}  // namespace\n"
    text = text.replace("namespace {", f"namespace {ns} {{", 1)
    text = text.replace("extern __shared__", "extern")
    return re.sub(r"<<<[^>]*>>>", "", text)


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("cuda_emu")
    for ns, src in SOURCES.items():
        name = Path(src).stem + ".inc"
        (out / name).write_text(kernel_half((CSRC / src).read_text(), ns))
    exe = out / "harness"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-Wno-psabi",
                        "-I", str(EMU),
                        "-I", str(out), str(EMU / "harness.cpp"), "-o",
                        str(exe)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]

    def raw(*args) -> None:
        r = subprocess.run([str(exe), *map(str, args)], capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr

    def run(kernel: str, dtype: torch.dtype, inputs: dict, args,
            outputs: dict, extra: dict = None) -> dict:
        work = Path(tmp_path_factory.mktemp(kernel))
        for name, t in {**inputs, **(extra or {})}.items():
            arr = t.view(torch.int16) if t.element_size() == 2 else t
            arr.numpy().tofile(work / f"{name}.bin")
        r = subprocess.run([str(exe), kernel, TAG[dtype], str(work),
                            *map(str, args)], capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        run.last = work
        res = {}
        for name, shape in outputs.items():
            raw = np.fromfile(work / f"{name}.bin",
                              np.float32 if dtype == torch.float32
                              else np.int16)
            t = torch.from_numpy(raw.reshape(shape))
            res[name] = t if dtype == torch.float32 else t.view(dtype)
        return res
    run.raw = raw
    run.workdir = lambda: Path(tmp_path_factory.mktemp("ptx"))
    return run


DTYPES = {"float32": torch.float32, "bfloat16": BF16,
          "float16": torch.float16}


def _close(got, want, dtype: str) -> None:
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=tol, atol=tol)


def _rms(harness, x, s, r, plan, offset=0) -> dict:
    """The launcher's kernel for ``plan`` (rms_plan's) under the
    emulation, x, r, y and res ``offset`` elements into their buffers;
    y, and res where the kernel writes one."""
    T, D = x.shape
    rdt = TAG[(r if r is not None else x).dtype]
    ins = {"x": x, "scale": s.float(), **({"r": r} if r is not None else {})}
    outs = {"y": (T, D), **({"res": (T, D)} if r is not None else {})}
    got = harness("rmsnorm", x.dtype, ins,
                  (T, D, int(r is not None), 1e-6, rdt,
                   rms.RMS_ROUTES[plan["route"]], plan["warps"], plan["nv"],
                   plan["blocks"], offset), outs)
    # without a residual the kernel writes no stream (the wrapper
    # returns x)
    assert (harness.last / "res.bin").exists() == (r is not None)
    return got


def _rms_inputs(seed, T, D, dtype, with_residual, rdtype=None):
    a = samples.kernel_inputs("rmsnorm", seed, T=T, D=D,
                              with_residual=with_residual)
    x = torch.from_numpy(a["x"]).to(DTYPES[dtype])
    r = torch.from_numpy(a["residual"]).to(DTYPES[rdtype or dtype]) \
        if with_residual else None
    return x, torch.from_numpy(a["scale"]), r


def _rms_check(got, x, s, r) -> None:
    """y within the reference's tolerance of the plain version, the
    residual stream bit-exact."""
    y, res = rms.fused_rmsnorm_plain(x, s, r, bt=x.shape[0])
    _close(got["y"], y, {v: k for k, v in DTYPES.items()}[x.dtype])
    if r is not None:
        assert torch.equal(got["res"], res)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,with_residual", [
    (16, 512, False), (16, 512, True), (4, 1000, True), (2, 5120, True),
    (4, 1001, False), (4, 1001, True), (4, 2048, False), (4, 2048, True)])
def test_rmsnorm_kernel_code(harness, T, D, with_residual, dtype):
    """The route rms_plan picks (vector where D is a multiple of 16
    bytes of x and fits the registers, smem for D = 1001) against the
    plain version."""
    x, s, r = _rms_inputs(0, T, D, dtype, with_residual)
    plan = rms.rms_plan(T, D, x.dtype, r.dtype if r is not None else None)
    unit = 16 // x.element_size()
    held = 32 * rms.MAX_WARPS * max(rms.VECTOR_NVS) * unit
    assert plan["route"] == ("smem" if D % unit or D > held else "vector")
    _rms_check(_rms(harness, x, s, r, plan), x, s, r)


@pytest.mark.parametrize("xdt,rdt,sdt", [
    ("bfloat16", "float32", "float32"), ("float32", "bfloat16", "bfloat16"),
    ("float16", "float16", "float16"), ("float16", "float32", "bfloat16"),
    ("bfloat16", "float16", "float32")])
def test_rmsnorm_kernel_code_mixed_dtypes(harness, xdt, rdt, sdt):
    """x, the residual and scale each in their own dtype (ROADMAP C7):
    the kernel reads each in its dtype and writes both outputs in x's,
    as the plain version does (16-byte units of x: 4 f32 values beside
    8 bytes of a bf16 residual, 8 bf16 values beside 32 bytes of an f32
    one)."""
    T, D = 4, 1000
    x, _, r = _rms_inputs(3, T, D, xdt, True, rdt)
    s = torch.from_numpy(samples.kernel_inputs("rmsnorm", 3, T=T, D=D)[
        "scale"]).to(DTYPES[sdt])
    plan = rms.rms_plan(T, D, x.dtype, r.dtype)
    assert plan["route"] == "vector"
    _rms_check(_rms(harness, x, s, r, plan), x, s, r)


# (dtype, D, warps, nv): every register shape of the vector route
# (launched with that shape), and the smem route for a D that is not a
# multiple of 16 bytes of x (rms_plan's shape)
RMS_ROUTE_CASES = [
    ("bfloat16", 2048, 2, 4), ("bfloat16", 2048, 3, 4),
    ("bfloat16", 2048, 4, 2), ("bfloat16", 2048, 8, 1),
    ("bfloat16", 640, 5, 2), ("bfloat16", 5120, 10, 2),
    ("float32", 1000, 4, 2),
    ("float16", 1000, None, None), ("bfloat16", 1001, None, None),
    ("float32", 1001, None, None), ("bfloat16", 4097, None, None)]


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype,D,warps,nv", RMS_ROUTE_CASES)
def test_rmsnorm_routes(harness, dtype, D, warps, nv, with_residual):
    """Each route, and each register shape the launcher takes, on a
    persistent grid of 2 blocks (fewer than the rows): every block walks
    several rows, prefetching the next, and the warps' partial sums
    alternate between their two sets."""
    T = 20
    x, s, r = _rms_inputs(5, T, D, dtype, with_residual)
    plan = rms.rms_plan(T, D, x.dtype, r.dtype if r is not None else None,
                        sms=1)
    assert plan["route"] == ("vector" if D % (16 // x.element_size()) == 0
                             else "smem")
    if warps is not None:
        plan = dict(plan, warps=warps, nv=nv,
                    rows_per_block=max(1, rms.ROW_THREADS // (32 * warps)))
    plan = dict(plan, blocks=2)
    assert plan["blocks"] * plan["rows_per_block"] < T
    _rms_check(_rms(harness, x, s, r, plan), x, s, r)


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype,D", [("bfloat16", 2048), ("float32", 512),
                                     ("bfloat16", 5120)])
def test_rmsnorm_misaligned_base(harness, dtype, D, with_residual):
    """Operands one element (2 bytes in bf16, 4 in f32) off 16-byte
    alignment, as a view with a storage offset gives them: rms_plan
    takes the smem route and the kernel reads and writes at the
    offset."""
    T = 6
    x, s, r = _rms_inputs(6, T, D, dtype, with_residual)
    esize = x.element_size()
    plan = rms.rms_plan(T, D, x.dtype, r.dtype if r is not None else None,
                        ptrs=[64 + esize, 64], sms=1)
    assert plan["route"] == "smem"
    assert "aligned" in plan["why"]
    _rms_check(_rms(harness, x, s, r, plan, offset=1), x, s, r)


def test_rmsnorm_plan_shapes():
    """The register shape holds the row with the fewest idle slots, then
    2 vectors a thread, then the fewest warps.  The grid: without a
    residual (a bf16 row moves no more bytes than its f32 scale) the
    blocks the card keeps resident, each walking rows; with one, a block
    a row group."""
    bf = torch.bfloat16
    plan = rms.rms_plan(4096, 2048, bf, bf, sms=132)
    assert (plan["route"], plan["unit"], plan["warps"], plan["nv"],
            plan["rows_per_block"], plan["threads"], plan["resident"],
            plan["persistent"], plan["blocks"], plan["launches"],
            plan["writes_res"]) == (
                "vector", 8, 4, 2, 2, 256, 528, False, 2048, 1, True)
    plan = rms.rms_plan(4096, 2048, bf, sms=132)
    assert (plan["persistent"], plan["blocks"], plan["writes_res"]) == (
        True, 528, False)
    plan = rms.rms_plan(4096, 5120, bf, bf, sms=132)
    assert (plan["warps"], plan["nv"], plan["rows_per_block"],
            plan["threads"], plan["resident"], plan["blocks"]) == (
                10, 2, 1, 320, 396, 4096)
    plan = rms.rms_plan(4096, 4096, bf, sms=132)
    assert (plan["warps"], plan["nv"], plan["threads"], plan["persistent"],
            plan["blocks"]) == (8, 2, 256, True, 528)
    plan = rms.rms_plan(4096, 1001, bf, sms=132)
    assert (plan["route"], plan["unit"], plan["threads"], plan["blocks"]) \
        == ("smem", 1, 256, 1056)
    assert "not a multiple of 8" in plan["why"]
    assert not rms.rms_plan(4096, 2048, torch.float32)["persistent"]
    assert rms.rms_plan(4, 2048, bf, sms=132)["blocks"] == 2   # 2 rows a block
    assert rms.rms_plan(8, 16384, bf)["route"] == "vector"
    assert rms.rms_plan(8, 32768, bf)["route"] == "smem"
    assert rms.rms_plan(8, 16384, torch.float32)["route"] == "smem"
    # every base 16-byte aligned, or the smem route
    assert rms.rms_plan(8, 2048, bf, bf, ptrs=[0, 16, 32, 48])["route"] \
        == "vector"
    assert rms.rms_plan(8, 2048, bf, bf, ptrs=[0, 16, 34, 48])["route"] \
        == "smem"
    with pytest.raises(ValueError, match="shared memory"):
        rms.rms_plan(8, 60000, torch.float32)


@pytest.fixture
def emulated_launch(harness, monkeypatch):
    """``fused_rmsnorm_cuda`` on CPU tensors, its launch run by the
    emulated kernel on the bytes at the pointers it passes (the wrapper's
    checks, plan and outputs as on the card); the launches' arguments."""
    codes = {v: k for k, v in DTYPE_CODE.items()}
    calls = []

    def grab(ptr, n, dt):
        return torch.frombuffer(bytearray(ctypes.string_at(
            ptr, n * dt.itemsize)), dtype=dt)

    def launch(entry, x, r, s, y, res, T, D, eps, route, warps, nv, blocks,
               code, rcode):
        assert entry == "rmsnorm_launch"
        xdt, rdt = codes[code], codes[rcode]
        calls.append({"r": r, "res": res, "route": route, "warps": warps,
                      "nv": nv, "blocks": blocks})
        plan = {"route": {v: k for k, v in rms.RMS_ROUTES.items()}[route],
                "warps": warps, "nv": nv, "blocks": blocks}
        xt = grab(x, T * D, xdt).view(T, D)
        rt = grab(r, T * D, rdt).view(T, D) if r else None
        got = _rms(harness, xt, grab(s, D, torch.float32), rt, plan,
                   offset=(x % 16) // xdt.itemsize)
        for ptr, name in ((y, "y"), (res, "res")):
            if ptr:
                out = got[name].contiguous()
                ctypes.memmove(ptr, out.data_ptr(), T * D * xdt.itemsize)

    monkeypatch.setattr(rms, "on_card", lambda *a: None)
    monkeypatch.setattr(rms.KERNEL, "launch", launch)
    return calls


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("dtype,D", [("bfloat16", 2048), ("float32", 1001)])
def test_rmsnorm_wrapper_on_the_emulated_kernel(emulated_launch, dtype, D,
                                                with_residual, offset):
    """The wrapper end to end: its plan from the operands' pointers (a
    view ``offset`` elements into its storage leaves the vector route),
    one launch, y within tolerance of the plain version, and the
    residual stream bit-exact; without a residual no stream pointer is
    passed and the stream returned is x itself."""
    T = 8
    x, s, r = _rms_inputs(7, T, D, dtype, with_residual)
    if offset:
        x = torch.cat([x.flatten()[:offset], x.flatten()])[offset:].view(T, D)
        if r is not None:
            r = torch.cat([r.flatten()[:offset], r.flatten()])[
                offset:].view(T, D)
    y, res = rms.fused_rmsnorm_cuda(x, s, r, bt=T)
    (call,) = emulated_launch
    want = "vector" if D % 8 == 0 and not offset else "smem"
    assert call["route"] == rms.RMS_ROUTES[want]
    _rms_check({"y": y, "res": res}, x, s, r)
    if r is None:
        assert call["res"] is None and call["r"] is None
        assert res is x and res.data_ptr() == x.data_ptr()
    else:
        assert res.data_ptr() != x.data_ptr()


def test_rmsnorm_misaligned_scale_takes_the_smem_route(emulated_launch):
    """A float32 scale view off 16-byte alignment is passed as it is
    (no copy), so its base sends the call to the smem route."""
    T, D = 8, 2048
    x, s, r = _rms_inputs(8, T, D, "bfloat16", True)
    s = torch.cat([s[:1], s])[1:]
    assert s.data_ptr() % 16
    y, res = rms.fused_rmsnorm_cuda(x, s, r, bt=T)
    (call,) = emulated_launch
    assert call["route"] == rms.RMS_ROUTES["smem"]
    _rms_check({"y": y, "res": res}, x, s, r)


def _gmm(harness, E, C, D, F, dtype, route=None, blocks=2):
    """The launcher's kernel for ``route`` (gmm_plan's by default, with
    a persistent grid of at most ``blocks`` blocks) against the plain
    version."""
    a = samples.kernel_inputs("grouped_matmul", 0, E=E, C=C, D=D, F=F)
    x = torch.from_numpy(a["x"]).to(DTYPES[dtype])
    w = torch.from_numpy(a["w"]).to(DTYPES[dtype])
    plan = gmm.gmm_plan(E, C, D, F, x.dtype, sms=blocks)
    route = plan["route"] if route is None else route
    got = harness("gmm", x.dtype, {"x": x, "w": w},
                  (E, C, D, F, gmm.GMM_ROUTES[route], plan["blocks"]),
                  {"out": (E, C, F)})["out"]
    _close(got, gmm.grouped_matmul_plain(x, w, bc=C, bf=F, bd=D), dtype)
    return plan


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", [(2, 64, 64, 64), (3, 100, 72, 40),
                                     (1, 128, 48, 130)])
def test_grouped_matmul_kernel_code(harness, E, C, D, F, dtype):
    """The kernel gmm_plan picks: float32 the CUDA-core kernel, bfloat16
    wgmma where TMA describes the operands, else WMMA."""
    _gmm(harness, E, C, D, F, dtype)


@pytest.mark.parametrize("E,C,D,F,blocks", [
    (2, 200, 200, 296, 3),      # C, D and F each cross a tile edge
    (2, 300, 520, 264, 3),      # D % 64 == 8: each expert's K tail
    (3, 100, 72, 40, 2),        # C and F inside one tile
    (1, 128, 8, 8, 1),          # one k-step of 8
    (2, 136, 64, 512, 1),       # one block walks all 8 tiles
])
def test_grouped_matmul_wgmma_kernel_code(harness, E, C, D, F, blocks):
    """The wgmma kernel with fewer blocks than tiles: each block walks
    several tiles and the 4-stage ring wraps across them.  The copies
    past C, D or F are zero-filled by the 3-D maps, never the next
    expert's rows (test_hopper_tma_twin holds the zero fill)."""
    plan = _gmm(harness, E, C, D, F, "bfloat16", "wgmma", blocks)
    assert plan["route"] == "wgmma"
    assert plan["blocks"] == min(blocks, plan["tiles"])


@pytest.mark.parametrize("E,C,D,F", [(2, 64, 64, 64), (3, 100, 72, 40)])
def test_grouped_matmul_wmma_kernel_code(harness, E, C, D, F):
    """The WMMA kernel, which gmm_plan keeps for operands TMA cannot
    describe, also at shapes the wgmma kernel takes."""
    _gmm(harness, E, C, D, F, "bfloat16", "wmma")


@pytest.mark.parametrize("xdt,wdt", [("bfloat16", "float32"),
                                     ("float16", "float16"),
                                     ("float32", "float16")])
def test_grouped_matmul_kernel_code_mixed_dtypes(harness, xdt, wdt):
    """Mixed and float16 operands (ROADMAP C7) take the route the wrapper
    gives them: widened to float32, the CUDA-core kernel, one cast of its
    output to x's dtype, against the plain version on the operands as
    given."""
    E, C, D, F = 2, 100, 72, 40
    a = samples.kernel_inputs("grouped_matmul", 4, E=E, C=C, D=D, F=F)
    x = torch.from_numpy(a["x"]).to(DTYPES[xdt])
    w = torch.from_numpy(a["w"]).to(DTYPES[wdt])
    plan = gmm.gmm_plan(E, C, D, F, x.dtype, w_dtype=w.dtype)
    assert (plan["route"], plan["upcast"]) == ("cuda cores", True)
    got = harness("gmm", torch.float32, {"x": x.float(), "w": w.float()},
                  (E, C, D, F, gmm.GMM_ROUTES["cuda cores"], plan["blocks"]),
                  {"out": (E, C, F)})["out"].to(x.dtype)
    _close(got, gmm.grouped_matmul_plain(x, w, bc=C, bf=F, bd=D), xdt)


def _flash(harness, q, k, v, *, causal=True, window=0, group=1, nsplit=1,
           with_lse=False):
    """The launcher's kernel for q's dtype on (BH, S, d) q, (BH / group, T,
    d) k and (BH / group, T, dv) v, under the emulation; with
    ``with_lse`` the output and the log-sum-exp."""
    BH, S, d = q.shape
    T, dv = k.shape[1], v.shape[-1]
    scale = float(np.float32(d ** -0.5))
    got = harness("flash", q.dtype, {"q": q, "k": k, "v": v},
                  (BH, S, T, d, dv, int(causal), window, repr(scale), group,
                   nsplit, int(d % 8 == 0 and dv % 8 == 0), int(with_lse)),
                  {"out": (BH, S, dv)})["out"]
    if not with_lse:
        return got
    lse = np.fromfile(harness.last / "lse.bin", np.float32)
    return got, torch.from_numpy(lse.reshape(BH, S))


def _plain(q, k, v, group=1, **kw):
    """The plain version on k/v expanded as the reference's jnp.repeat."""
    k, v = (t.repeat_interleave(group, dim=0) for t in (k, v))
    return fa.flash_attention_plain(q, k, v, bq=q.shape[1], bk=k.shape[1],
                                    **kw)


def _qkv(seed, BH, S, T, d, dtype, group=1):
    a = samples.kernel_inputs("flash_attention", seed, q_shape=(BH, S, d),
                              kv_shape=(BH // group, T, d))
    return (torch.from_numpy(a[n]).to(DTYPES[dtype]) for n in "qkv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("BH,S,T,d,causal,window", [
    (2, 64, 64, 32, True, 0),
    (1, 128, 128, 64, True, 0),
    (1, 130, 200, 48, True, 0),       # ragged query and key tiles
    (1, 1, 256, 128, True, 0),        # decode
    (1, 64, 192, 64, True, 96),       # window, queries offset
    (1, 128, 128, 64, False, 40),     # window without causal
    (1, 192, 64, 32, True, 0),        # rows without keys
    (1, 64, 64, 160, True, 0),
    (1, 160, 160, 144, True, 0),      # two m-tiles a warp, d padded
    (1, 64, 64, 256, True, 16),
])
def test_flash_attention_kernel_code(harness, BH, S, T, d, causal, window,
                                     dtype):
    """float32 runs the CUDA-core kernel, bfloat16 the tensor-core one."""
    q, k, v = _qkv(3, BH, S, T, d, dtype)
    got = _flash(harness, q, k, v, causal=causal, window=window)
    _close(got, _plain(q, k, v, causal=causal, window=window), dtype)
    if causal and S > T:
        assert torch.equal(got[:, :S - T].float(),
                           torch.zeros(BH, S - T, d))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group,BH,S,T,d,window", [
    (2, 4, 96, 160, 64, 0),           # two kv heads, packed rows ragged
    (4, 4, 40, 40, 32, 24),           # one kv head, window
])
def test_flash_attention_kv_heads_indexed(harness, group, BH, S, T, d,
                                          window, dtype):
    """k/v hold BH / group heads; query head qh reads kv head qh // group,
    as the plain version on jnp.repeat-expanded k/v."""
    q, k, v = _qkv(11 + group, BH, S, T, d, dtype, group)
    got = _flash(harness, q, k, v, window=window, group=group)
    _close(got, _plain(q, k, v, group, window=window), dtype)


@pytest.mark.parametrize("case,group,BH,S,T,d,window,nsplit", [
    ("decode", 2, 4, 1, 512, 128, 0, 4),
    ("chunk masked off by a window", 2, 2, 64, 512, 64, 10, 2),
    ("empty chunk", 2, 2, 2, 512, 64, 70, 3),
    ("rows without keys", 1, 2, 96, 64, 32, 0, 2),
    ("more splits than tiles", 4, 4, 3, 100, 160, 0, 5),
])
def test_flash_attention_split_kv(harness, case, group, BH, S, T, d, window,
                                  nsplit):
    """The tensor-core kernel writes each chunk's (m, l, acc) and the
    combine kernel merges them; chunks without an open key add nothing
    and a row without keys is 0."""
    q, k, v = _qkv(21, BH, S, T, d, "bfloat16", group)
    got = _flash(harness, q, k, v, window=window, group=group, nsplit=nsplit)
    _close(got, _plain(q, k, v, group, window=window), "bfloat16")
    one = _flash(harness, q, k, v, window=window, group=group)
    _close(got, one, "bfloat16")
    if S > T:
        assert torch.equal(got[:, :S - T].float(), torch.zeros(BH, S - T, d))


@pytest.mark.parametrize("qdt,kvdt", [("bfloat16", "float32"),
                                      ("float16", "float16"),
                                      ("float32", "bfloat16")])
def test_flash_attention_kernel_code_mixed_dtypes(harness, qdt, kvdt):
    """Mixed and float16 operands (ROADMAP C7): widened to float32, the
    CUDA-core kernel with ``group``, one cast to q's dtype, against the
    plain version on the operands as given."""
    BH, S, T, d, group = 4, 96, 160, 64, 2
    a = samples.kernel_inputs("flash_attention", 5, q_shape=(BH, S, d),
                              kv_shape=(BH // group, T, d))
    q = torch.from_numpy(a["q"]).to(DTYPES[qdt])
    k, v = (torch.from_numpy(a[n]).to(DTYPES[kvdt]) for n in "kv")
    plan = fa.attention_plan(BH, S, T, d, group, q.dtype, k.dtype, v.dtype)
    assert (plan["kernel"], plan["upcast"], plan["launches"]) == (
        "cuda cores", True, 1)
    got = _flash(harness, q.float(), k.float(), v.float(), window=40,
                 group=group).to(q.dtype)
    _close(got, _plain(q, k, v, group, window=40), qdt)


def test_flash_attention_rows_not_of_whole_chunks(harness):
    """d % 8 != 0: the tensor-core kernel loads element by element."""
    q, k, v = _qkv(31, 2, 70, 90, 36, "bfloat16")
    _close(_flash(harness, q, k, v, window=50),
           _plain(q, k, v, window=50), "bfloat16")


def _grad_inputs(seed, BH, S, T, d, dv, group):
    a = samples.kernel_inputs("flash_attention_grad", seed,
                              q_shape=(BH, S, d), kv_shape=(BH // group, T, d),
                              v_shape=(BH // group, T, dv),
                              do_shape=(BH, S, dv))
    return [torch.from_numpy(a[n]).to(BF16) for n in ("q", "k", "v", "do")]


# the forward with the log-sum-exp: v of its own width (latent attention's
# 192 beside 128), GQA, windows, split-KV, rows without keys
@pytest.mark.parametrize("BH,S,T,d,dv,group,causal,window,nsplit", [
    (2, 96, 96, 64, 64, 1, True, 0, 1),
    (2, 80, 80, 192, 128, 1, True, 0, 1),
    (4, 72, 72, 128, 128, 2, True, 24, 1),
    (2, 40, 40, 40, 24, 2, False, 0, 1),       # not whole chunks; no mask
    (2, 2, 256, 64, 64, 2, True, 0, 2),        # split-KV: the combine's lse
])
def test_flash_attention_forward_with_lse(harness, BH, S, T, d, dv, group,
                                          causal, window, nsplit):
    """The output is the forward-only call's, bit for bit, and lse is the
    plain version's m + log(l) in f32."""
    q, k, v, _ = _grad_inputs(41, BH, S, T, d, dv, group)
    kw = dict(causal=causal, window=window, group=group, nsplit=nsplit)
    out, lse = _flash(harness, q, k, v, with_lse=True, **kw)
    assert torch.equal(out, _flash(harness, q, k, v, **kw))
    want, want_lse = _plain(q, k, v, group, causal=causal, window=window,
                            with_lse=True)
    _close(out, want, "bfloat16")
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-5,
                               atol=1e-5)


def _flash_bwd(harness, q, k, v, o, do, lse, *, causal=True, window=0,
               group=1):
    """The backward's two passes under the emulation: dq, dk, dv."""
    BH, S, d = q.shape
    T, dv = k.shape[1], v.shape[-1]
    scale = float(np.float32(d ** -0.5))
    got = harness("flash_bwd", BF16, {"q": q, "k": k, "v": v, "o": o,
                                      "do": do},
                  (BH, S, T, d, dv, int(causal), window, repr(scale), group,
                   int(d % 8 == 0 and dv % 8 == 0)),
                  {"dq": (BH, S, d), "dk": (BH // group, T, d),
                   "dv": (BH // group, T, dv)}, extra={"lse": lse})
    return got["dq"], got["dk"], got["dv"]


# the backward: tiles crossed in both passes, GQA groups accumulated in
# one block, the 192/128 pair, the column split (DP + DV > 320), windows,
# queries offset (T > S), rows without keys (S > T), no mask, rows of
# elements not whole 16-byte chunks
@pytest.mark.parametrize("BH,S,T,d,dv,group,causal,window", [
    (2, 130, 130, 64, 64, 1, True, 0),
    (4, 96, 96, 128, 128, 2, True, 0),
    (2, 100, 100, 192, 128, 1, True, 0),
    (2, 72, 72, 192, 192, 1, True, 0),
    (2, 64, 64, 256, 256, 2, True, 20),
    (2, 64, 160, 64, 64, 1, True, 40),
    (2, 96, 64, 64, 64, 1, True, 0),
    (2, 70, 70, 40, 24, 2, False, 0),
    (4, 80, 80, 160, 160, 4, False, 30),
])
def test_flash_attention_backward_kernel_code(harness, BH, S, T, d, dv,
                                              group, causal, window):
    """dq, dk, dv against the plain backward on the kernel's own o and lse,
    at the bfloat16 tolerance; a query row without keys has dq 0."""
    q, k, v, do = _grad_inputs(43, BH, S, T, d, dv, group)
    o, lse = _flash(harness, q, k, v, causal=causal, window=window,
                    group=group, with_lse=True)
    got = _flash_bwd(harness, q, k, v, o, do, lse, causal=causal,
                     window=window, group=group)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, group=group,
                                        causal=causal, window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().amax())
        assert err <= 2e-2 * float(w.float().abs().amax()) + 1e-3, (name, err)
    if causal and S > T:
        assert torch.equal(got[0][:, :S - T].float(),
                           torch.zeros(BH, S - T, d))


# ---------------------------------------------------------------------------
# the PTX twins, lane by lane against the PTX ISA's fragment layouts
# ---------------------------------------------------------------------------

def _bf16_bits(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x.astype(np.float32)).to(BF16).view(
        torch.int16).numpy().astype(np.uint16)


def _pairs(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return lo.astype(np.uint32) | (hi.astype(np.uint32) << 16)


def _ptx(harness, what, inputs: dict, out: str, dtype, n: int):
    """Run the twin ``what`` on raw arrays; its output as a numpy array."""
    work = harness.workdir()
    for name, arr in inputs.items():
        arr.tofile(work / f"{name}.bin")
    harness.raw("ptx", what, work)
    return np.fromfile(work / f"{out}.bin", dtype)[:n]


def test_ptx_mma_twin(harness):
    """m16n8k16: A (16 x 16) and B (16 x 8) spread over the lanes as the
    ISA's tables say; D = A B + C read back from its lanes."""
    rng = np.random.default_rng(0)
    A = samples.bf16_round(rng.standard_normal((16, 16)))
    B = samples.bf16_round(rng.standard_normal((16, 8)))
    C = rng.standard_normal((16, 8)).astype(np.float32)
    Ab, Bb = _bf16_bits(A), _bf16_bits(B)
    a = np.zeros((32, 4), np.uint32)
    b = np.zeros((32, 2), np.uint32)
    c = np.zeros((32, 4), np.float32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, (r, k) in enumerate([(g, 2 * t), (g + 8, 2 * t),
                                    (g, 2 * t + 8), (g + 8, 2 * t + 8)]):
            a[lane, i] = _pairs(Ab[r, k], Ab[r, k + 1])
        for i, k in enumerate([2 * t, 2 * t + 8]):
            b[lane, i] = _pairs(Bb[k, g], Bb[k + 1, g])
        c[lane] = [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                   C[g + 8, 2 * t + 1]]
    d = _ptx(harness, "mma", {"a": a, "b": b, "c": c}, "d", np.float32,
             128).reshape(32, 4)
    D = np.zeros((16, 8), np.float32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        D[g, 2 * t], D[g, 2 * t + 1] = d[lane, 0], d[lane, 1]
        D[g + 8, 2 * t], D[g + 8, 2 * t + 1] = d[lane, 2], d[lane, 3]
    np.testing.assert_allclose(D, A.astype(np.float64) @ B + C, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("trans", [False, True])
def test_ptx_ldmatrix_twin(harness, trans):
    """x4: lanes 8i .. 8i+7 name the rows of matrix i (here in a shuffled
    order); lane 4g + t gets row g, columns 2t and 2t + 1 of each matrix,
    or, transposed, rows 2t and 2t + 1 of column g."""
    rng = np.random.default_rng(1)
    m = rng.integers(0, 1 << 16, (32, 8), dtype=np.uint16)
    rows = rng.permutation(32).astype(np.int32)
    regs = _ptx(harness, "ldmatrix_trans" if trans else "ldmatrix",
                {"m": m, "rows": rows}, "regs", np.uint32,
                128).reshape(32, 4)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            mat = m[rows[8 * i:8 * i + 8]]          # matrix i, 8 x 8
            if trans:
                mat = mat.T
            assert regs[lane, i] == _pairs(mat[g, 2 * t], mat[g, 2 * t + 1])


def test_ptx_cvt_bf16x2_twin(harness):
    """Two floats rounded to bf16 (nearest even, ties included), the
    first in the lower half."""
    rng = np.random.default_rng(3)
    f = rng.standard_normal(64).astype(np.float32)
    # exact ties between two bf16 values: round to the even one
    f[:8] = (np.arange(8, dtype=np.uint32) << 16 | 0x3F808000).view(
        np.float32)
    regs = _ptx(harness, "cvt", {"f": f}, "regs", np.uint32, 32)
    bits = _bf16_bits(f).reshape(32, 2)
    np.testing.assert_array_equal(regs, _pairs(bits[:, 0], bits[:, 1]))


def test_ptx_ex2_twin(harness):
    """2^x, the exp of the kernel's log2-e-scaled logits."""
    x = np.linspace(-30, 2, 32).astype(np.float32)
    y = _ptx(harness, "ex2", {"f": x}, "y", np.float32, 32)
    np.testing.assert_allclose(y, np.exp2(x.astype(np.float64)), rtol=1e-6)


def test_ptx_cp_async_twin(harness):
    """16 bytes a lane; src-size 0 writes 16 zero bytes."""
    rng = np.random.default_rng(2)
    src = rng.integers(1, 256, (32, 16), dtype=np.uint8)
    nbytes = np.where(np.arange(32) % 3 == 0, 0, 16).astype(np.int32)
    dst = _ptx(harness, "cp_async", {"src": src, "bytes": nbytes}, "dst",
               np.uint8, 512).reshape(32, 16)
    want = np.where((nbytes == 16)[:, None], src, 0)
    np.testing.assert_array_equal(dst, want)


# ---------------------------------------------------------------------------
# the Hopper twins (hopper.h), against the PTX ISA's layouts
# ---------------------------------------------------------------------------

def _swizzle(addr, span: int):
    """Address bits 4.. XORed with bits 7.. (span 32, 64 or 128 bytes)."""
    if span < 32:
        return addr
    return addr ^ (((addr >> 7) & (span // 16 - 1)) << 4)


def _desc(start: int, lbo: int, sbo: int, span: int) -> int:
    """A wgmma shared-memory descriptor, field by field as the ISA lays
    it out: start, LBO and SBO in 16-byte units in bits 0-13, 16-29 and
    32-45, the layout (1: 128-byte swizzle, 0: none) in bits 62-63."""
    layout = {128: 1, 64: 2, 32: 3, 16: 0}[span]
    return ((start >> 4) & 0x3FFF) | ((lbo >> 4) & 0x3FFF) << 16 \
        | ((sbo >> 4) & 0x3FFF) << 32 | layout << 62


def _accumulator_cells(n: int):
    """(thread, register) -> (row, column) of a 64 x n wgmma
    accumulator: register i of lane 4 g + t in warp w is row 16 w + g +
    8 ((i % 4) // 2), column 8 (i // 4) + 2 t + i % 2."""
    tid = np.arange(128)[:, None]
    i = np.arange(n // 2)[None, :]
    rows = 16 * (tid // 32) + (tid % 32) // 4 + 8 * ((i % 4) // 2)
    cols = 8 * (i // 4) + 2 * (tid % 4) + i % 2
    return rows, cols


def _place(smem: np.ndarray, addrs: np.ndarray, bits: np.ndarray) -> None:
    smem.view(np.uint16)[addrs.ravel() // 2] = bits.ravel()


def _wgmma_case(case: str, rng):
    """Shared memory, descriptors, N, trans_b and the operands of one
    wgmma run, laid out by the ISA's canonical layouts."""
    smem = np.zeros(64 * 1024, np.uint8)
    if case == "swizzled":
        # A 64 x 64 K-major as TMA writes a 128-byte swizzled box (row r at
        # r * 128); B 64 x 256 MN-major as four 64-column boxes at 8 KiB
        # (row k at k * 128 within a box); four k-steps as the kernel
        # issues them, A's start 32 bytes and B's 2 KiB further each step
        K, N = 64, 256
        A = samples.bf16_round(rng.standard_normal((64, K)))
        B = samples.bf16_round(rng.standard_normal((K, N)))
        r, k = np.meshgrid(np.arange(64), np.arange(K), indexing="ij")
        _place(smem, _swizzle(r * 128 + 2 * k, 128), _bf16_bits(A))
        k, n = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
        _place(smem, _swizzle(8192 + n // 64 * 8192 + k * 128 + 2 * (n % 64),
                              128), _bf16_bits(B))
        desc = [(_desc(32 * s, 16, 1024, 128),
                 _desc(8192 + 2048 * s, 8192, 1024, 128)) for s in range(4)]
        return smem, desc, N, 1, A, B
    # no swizzle, both K-major: 8 x 16-byte core matrices; A's second 8
    # of k at LBO 128, its groups of 8 rows at SBO 256; B's (rows n) at
    # LBO 1024 and SBO 128
    K, N = 16, 64
    A = samples.bf16_round(rng.standard_normal((64, K)))
    B = samples.bf16_round(rng.standard_normal((K, N)))
    r, k = np.meshgrid(np.arange(64), np.arange(K), indexing="ij")
    _place(smem, r % 8 * 16 + r // 8 * 256 + k % 8 * 2 + k // 8 * 128,
           _bf16_bits(A))
    k, n = np.meshgrid(np.arange(K), np.arange(N), indexing="ij")
    _place(smem, 4096 + n % 8 * 16 + n // 8 * 128 + k % 8 * 2 + k // 8 * 1024,
           _bf16_bits(B))
    return smem, [(_desc(0, 128, 256, 16), _desc(4096, 1024, 128, 16))], \
        N, 0, A, B


@pytest.mark.parametrize("case,scale_d", [("swizzled", 1), ("plain", 0)])
def test_hopper_wgmma_twin(harness, case, scale_d):
    """wgmma m64nNk16 for a warpgroup: A and B read through descriptors
    (128-byte swizzle with A K-major and B MN-major through the
    transpose bit, as grouped_matmul.cu issues it; and no swizzle, both
    K-major), D = A B (+ C when scale_d) in the accumulator layout, and
    nothing written before wait_group retires the group."""
    rng = np.random.default_rng(4)
    smem, desc, N, trans_b, A, B = _wgmma_case(case, rng)
    c = rng.standard_normal((128, N // 2)).astype(np.float32)
    work = harness.workdir()
    smem.tofile(work / "smem.bin")
    np.array(desc, np.uint64).tofile(work / "desc.bin")
    np.array([N, scale_d, trans_b, len(desc)], np.int32).tofile(
        work / "args.bin")
    c.tofile(work / "c.bin")
    harness.raw("ptx", "wgmma", work)
    d = np.fromfile(work / "d.bin", np.float32).reshape(128, N // 2)
    before = np.fromfile(work / "before.bin", np.float32).reshape(128, N // 2)
    np.testing.assert_array_equal(before, c)
    rows, cols = _accumulator_cells(N)
    want = (A.astype(np.float64) @ B)[rows, cols] + (c if scale_d else 0)
    np.testing.assert_allclose(d, want, rtol=1e-5, atol=1e-4)


def _tma(harness, g, rows, cols, swizzle, coords):
    work = harness.workdir()
    g.tofile(work / "g.bin")
    E, R, Cc = g.shape
    np.array([E, R, Cc, rows, cols, swizzle, *coords, 1024],
             np.int32).tofile(work / "args.bin")
    harness.raw("ptx", "tma", work)
    return (np.fromfile(work / "log.bin", np.int32),
            np.fromfile(work / "dst.bin", np.uint8))


@pytest.mark.parametrize("swizzle,rows,coords", [
    (128, 16, (32, 60, 1)),     # past the columns and the rows of expert 1
    (128, 8, (0, 66, 2)),       # the last expert's last rows: zeros after
    (0, 8, (8, 3, 0)),          # inside, no swizzle
])
def test_hopper_tma_twin(harness, swizzle, rows, coords):
    """A 3-D box (64 columns x rows x 1 expert) of a bf16 (E, R, C)
    tensor into shared memory at a 1 KiB boundary: element (i1, i0) at
    byte (i1 * 64 + i0) * 2 of the box, then the 128-byte swizzle on the
    address bits; zeros wherever the box leaves the tensor (never the
    next expert's rows); the box's bytes complete the barrier's phase."""
    rng = np.random.default_rng(5)
    E, R, Cc = 3, 70, 72
    g = rng.integers(1, 1 << 16, (E, R, Cc), dtype=np.uint16)
    log, dst = _tma(harness, g, rows, 64, swizzle, coords)
    np.testing.assert_array_equal(log, [0, 0, 1])
    c0, c1, c2 = coords
    box = np.zeros((rows, 64), np.uint16)
    inner = g[c2, c1:c1 + rows, c0:c0 + 64]
    box[:inner.shape[0], :inner.shape[1]] = inner
    off = np.arange(rows * 64 * 2)
    want = np.empty(off.size, np.uint8)
    want[_swizzle(1024 + off, swizzle) - 1024] = box.view(np.uint8).ravel()
    np.testing.assert_array_equal(dst[:off.size], want)


@pytest.mark.parametrize("cols,box_cols,swizzle", [
    (70, 64, 128),      # a row of 140 bytes: not a multiple of 16
    (72, 72, 128),      # a box row of 144 bytes: wider than the swizzle
])
def test_hopper_tensor_map_limits(harness, cols, box_cols, swizzle):
    """The stand-in encoder refuses what cuTensorMapEncodeTiled does."""
    g = np.ones((2, 8, cols), np.uint16)
    log, _ = _tma(harness, g, 8, box_cols, swizzle, (0, 0, 0))
    np.testing.assert_array_equal(log, [1])


def test_hopper_mbarrier_twin(harness):
    """A phase completes when its arrivals and its transaction bytes are
    all in; try_wait.parity(p) is true once the phase of parity p is
    complete; waiters block until then, across threads."""
    work = harness.workdir()
    harness.raw("ptx", "mbarrier", work)
    log = np.fromfile(work / "log.bin", np.int32)
    # init 2: parity 0 open, parity 1 (the phase before) complete; one
    # arrival; arrive.expect_tx 96; 64 bytes; 32 bytes: phase 0 complete,
    # phase 1 open; two arrivals: phase 1 complete; then three waiters
    # still blocked after the arrival (bytes pending), all three through
    # after the bytes
    np.testing.assert_array_equal(log, [0, 1, 0, 0, 0, 1, 0, 1, 0, 0, 3])
