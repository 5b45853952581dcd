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
            outputs: dict) -> dict:
        work = Path(tmp_path_factory.mktemp(kernel))
        for name, t in inputs.items():
            arr = t.view(torch.int16) if t.element_size() == 2 else t
            arr.numpy().tofile(work / f"{name}.bin")
        r = subprocess.run([str(exe), kernel, TAG[dtype], str(work),
                            *map(str, args)], capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,D,with_residual", [
    (16, 512, False), (16, 512, True), (4, 1000, True), (2, 5120, True)])
def test_rmsnorm_kernel_code(harness, T, D, with_residual, dtype):
    a = samples.kernel_inputs("rmsnorm", 0, T=T, D=D,
                              with_residual=with_residual)
    x = torch.from_numpy(a["x"]).to(DTYPES[dtype])
    s = torch.from_numpy(a["scale"])
    r = torch.from_numpy(a["residual"]).to(DTYPES[dtype]) \
        if with_residual else None
    ins = {"x": x, "scale": s, **({"r": r} if with_residual else {})}
    got = harness("rmsnorm", x.dtype, ins,
                  (T, D, int(with_residual), 1e-6, TAG[x.dtype]),
                  {"y": (T, D), "res": (T, D)})
    y, res = rms.fused_rmsnorm_plain(x, s, r, bt=T)
    _close(got["y"], y, dtype)
    assert torch.equal(got["res"], res)


@pytest.mark.parametrize("xdt,rdt,sdt", [
    ("bfloat16", "float32", "float32"), ("float32", "bfloat16", "bfloat16"),
    ("float16", "float16", "float16"), ("float16", "float32", "bfloat16"),
    ("bfloat16", "float16", "float32")])
def test_rmsnorm_kernel_code_mixed_dtypes(harness, xdt, rdt, sdt):
    """x, the residual and scale each in their own dtype (ROADMAP C7):
    the kernel reads each in its dtype and writes both outputs in x's,
    as the plain version does."""
    T, D = 4, 1000
    a = samples.kernel_inputs("rmsnorm", 3, T=T, D=D, with_residual=True)
    x = torch.from_numpy(a["x"]).to(DTYPES[xdt])
    r = torch.from_numpy(a["residual"]).to(DTYPES[rdt])
    s = torch.from_numpy(a["scale"]).to(DTYPES[sdt])
    got = harness("rmsnorm", x.dtype, {"x": x, "r": r, "scale": s.float()},
                  (T, D, 1, 1e-6, TAG[r.dtype]),
                  {"y": (T, D), "res": (T, D)})
    y, res = rms.fused_rmsnorm_plain(x, s, r, bt=T)
    _close(got["y"], y, xdt)
    assert torch.equal(got["res"], res)


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


def _flash(harness, q, k, v, *, causal=True, window=0, group=1, nsplit=1):
    """The launcher's kernel for q's dtype on (BH, S, d) q and
    (BH / group, T, d) k/v, under the emulation."""
    BH, S, d = q.shape
    T = k.shape[1]
    scale = float(np.float32(d ** -0.5))
    return harness("flash", q.dtype, {"q": q, "k": k, "v": v},
                   (BH, S, T, d, int(causal), window, repr(scale), group,
                    nsplit, int(d % 8 == 0)), {"out": (BH, S, d)})["out"]


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
