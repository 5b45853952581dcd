"""The model kernels' CUDA code, run on the CPU against the plain versions.

There is no ``nvcc`` and no card here, so the CUDA kernels of
``src/repro_torch/kernels/*/csrc/*.cu`` cannot run as written.  Their
kernel halves (everything before the ``extern "C"`` launchers) build as
host C++ against ``tests/cuda_emu/``: a stand-in runtime that runs each
CUDA thread of a block as a ``std::thread``, with barriers for
``__syncthreads`` and the warp shuffles.  The kernels' own index
arithmetic, tiling, masking, reductions and roundings then run on the
CPU, at small shapes that cross their tiles' edges, and are held
against the plain versions with the reference's tolerance (rtol = atol
= 2e-5 in float32, 2e-2 in bfloat16).  What only the card can show
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
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-I", str(EMU),
                        "-I", str(out), str(EMU / "harness.cpp"), "-o",
                        str(exe)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]

    def run(kernel: str, dtype: torch.dtype, inputs: dict, args,
            outputs: dict) -> dict:
        work = Path(tmp_path_factory.mktemp(kernel))
        for name, t in inputs.items():
            arr = t.view(torch.int16) if t.dtype == BF16 else t
            arr.numpy().tofile(work / f"{name}.bin")
        r = subprocess.run([str(exe), kernel,
                            "bf16" if dtype == BF16 else "f32", str(work),
                            *map(str, args)], capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        res = {}
        for name, shape in outputs.items():
            raw = np.fromfile(work / f"{name}.bin",
                              np.int16 if dtype == BF16 else np.float32)
            t = torch.from_numpy(raw.reshape(shape))
            res[name] = t.view(BF16) if dtype == BF16 else t
        return res
    return run


DTYPES = {"float32": torch.float32, "bfloat16": BF16}


def _close(got, want, dtype: str) -> None:
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
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
    got = harness("rmsnorm", x.dtype, ins, (T, D, int(with_residual), 1e-6),
                  {"y": (T, D), "res": (T, D)})
    y, res = rms.fused_rmsnorm_plain(x, s, r, bt=T)
    _close(got["y"], y, dtype)
    assert torch.equal(got["res"], res)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F", [(2, 64, 64, 64), (3, 100, 72, 40),
                                     (1, 128, 48, 130)])
def test_grouped_matmul_kernel_code(harness, E, C, D, F, dtype):
    a = samples.kernel_inputs("grouped_matmul", 0, E=E, C=C, D=D, F=F)
    x = torch.from_numpy(a["x"]).to(DTYPES[dtype])
    w = torch.from_numpy(a["w"]).to(DTYPES[dtype])
    got = harness("gmm", x.dtype, {"x": x, "w": w}, (E, C, D, F),
                  {"out": (E, C, F)})["out"]
    _close(got, gmm.grouped_matmul_plain(x, w, bc=C, bf=F, bd=D), dtype)


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
    (1, 64, 64, 256, True, 16),
])
def test_flash_attention_kernel_code(harness, BH, S, T, d, causal, window,
                                     dtype):
    a = samples.kernel_inputs("flash_attention", 3, q_shape=(BH, S, d),
                              kv_shape=(BH, T, d))
    q, k, v = (torch.from_numpy(a[n]).to(DTYPES[dtype]) for n in "qkv")
    scale = float(np.float32(d ** -0.5))
    got = harness("flash", q.dtype, {"q": q, "k": k, "v": v},
                  (BH, S, T, d, int(causal), window, repr(scale)),
                  {"out": (BH, S, d)})["out"]
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                    bq=S, bk=T)
    _close(got, want, dtype)
    if causal and S > T:
        assert torch.equal(got[:, :S - T].float(),
                           torch.zeros(BH, S - T, d))
