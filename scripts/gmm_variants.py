#!/usr/bin/env python3
"""Time variants of the grouped matmul's wgmma kernel against each other.

    python3 scripts/gmm_variants.py

Needs a CUDA card and nvcc.  Prints ``nvcc -Xptxas -v``'s registers and
spills for the shipped ``gmm_wgmma_kernel``, then builds each variant
(the shipped source with one change, all built in parallel) and times
it at the two full-width grouped-matmul cells of ``chip_smoke.py``
(olmoe-1b-7b, llama4-scout-17b-a16e), beside the WMMA route and
``torch.bmm``, in two rounds (in order, then in reverse), each output
held to 2e-2 of ``torch.bmm``'s.  Times are CUDA events around 20
launches after one warm launch.  The record goes to
``chiprun_out/gmm_variants.json``, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

CELLS = {"olmoe-1b-7b": (64, 640, 2048, 1024),
         "llama4-scout-17b-a16e": (16, 640, 5120, 8192)}


def variants(src: str) -> dict:
    """The shipped source and one change each."""
    def sub(text, *pairs):
        for a, b in pairs:
            if a not in text:
                raise RuntimeError(f"variant anchor not found: {a!r}")
            text = text.replace(a, b)
        return text
    return {
        "shipped": src,
        "3 stages": sub(src, ("GK = 64, STAGES = 4;", "GK = 64, STAGES = 3;")),
        "tiles F fastest": sub(src, (
            "const int m0 = t % tm * GM, n0 = t / tm % tn * GN;",
            "const int m0 = t / tn % tm * GM, n0 = t % tn * GN;")),
        "no group in flight": sub(src, (
            "wgmma_wait<1>();\n                if (kb > 0 && lane == 0) "
            "mbar_arrive(&empty[prev]);",
            "wgmma_wait<0>();\n                if (lane == 0) "
            "mbar_arrive(&empty[s]);"), (
            "fence_acc(acc);\n            if (lane == 0) "
            "mbar_arrive(&empty[prev]);", "fence_acc(acc);")),
        "no setmaxnreg": sub(src, ("setmaxnreg_dec<40>();", ""),
                             ("setmaxnreg_inc<232>();", "")),
        "no L2 promotion": sub(src, (
            "CU_TENSOR_MAP_L2_PROMOTION_L2_256B,",
            "CU_TENSOR_MAP_L2_PROMOTION_NONE,")),
    }


def ptxas_report(source: str) -> list:
    """``nvcc -Xptxas -v``'s lines for the wgmma kernel."""
    from repro_torch.core.cudac import NVCC_FLAGS
    from repro_torch.device import nvcc_path

    out = os.path.join(ROOT, "build", "gmm_ptxas.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
                        source], capture_output=True, text=True, timeout=600)
    lines = r.stderr.splitlines()
    keep, take = [], 0
    for line in lines:
        if "entry function" in line:
            take = 4 if "gmm_wgmma_kernel" in line else 0
        if take or "warn" in line.lower():
            keep.append(line.strip())
            take = max(take - 1, 0)
    return keep


def main() -> int:
    import torch

    from repro_torch.core.cudac import compile_library
    from repro_torch.kernels.grouped_matmul import kernel as gmm

    if not torch.cuda.is_available():
        print("gmm_variants: torch sees no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    ptxas = ptxas_report(str(gmm.KERNEL.source))
    print("\n".join(ptxas))
    srcs = variants(gmm.KERNEL.source.read_text())
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(zip(srcs, pool.map(
            lambda kv: compile_library(kv[1], f"variant {kv[0]}"),
            srcs.items())))
    fns = {}
    for name, lib in libs.items():
        fn = lib.gmm_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def event_ms(call, reps: int = 20) -> float:
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    dev = torch.device("cuda", 0)
    record = {"device": smi, "ptxas": ptxas, "cells": {}}
    for cell, (E, C, D, F) in CELLS.items():
        g = torch.Generator(device=dev)
        g.manual_seed(1)
        x = torch.randn(E, C, D, generator=g, device=dev,
                        dtype=torch.bfloat16) * 0.1
        w = torch.randn(E, D, F, generator=g, device=dev,
                        dtype=torch.bfloat16) * 0.1
        want = torch.bmm(x, w)
        out = torch.empty_like(want)
        plan = gmm.gmm_plan(E, C, D, F, x.dtype, x.data_ptr(), w.data_ptr())
        stream = torch.cuda.current_stream().cuda_stream
        times = {}

        def launcher(fn, route, blocks):
            def call():
                err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D,
                         F, gmm.GMM_ROUTES[route], blocks, stream)
                if err:
                    raise RuntimeError(f"launch failed with CUDA error {err}")
            return call
        calls = {n: launcher(fn, "wgmma", plan["blocks"])
                 for n, fn in fns.items()}
        calls["WMMA route"] = launcher(
            fns["shipped"], "wmma", E * -(-C // 128) * -(-F // 128))
        calls["torch.bmm"] = lambda: torch.bmm(x, w)
        order = list(calls)
        for names in (order, order[::-1]):
            for n in names:
                ms = event_ms(calls[n], reps=5 if n == "WMMA route" else 20)
                if n != "torch.bmm" and not torch.allclose(
                        out.float(), want.float(), rtol=2e-2, atol=2e-2):
                    err = float((out.float() - want.float()).abs().amax())
                    raise RuntimeError(f"{cell} {n}: max abs err {err}")
                times.setdefault(n, []).append(ms)
        ops = 2 * E * C * D * F
        record["cells"][cell] = {"shape": [E, C, D, F], "plan": plan,
                                 "bound_ms": ops / 989e12 * 1e3,
                                 "ms": times}
        print(f"{cell} (bound {ops / 989e12 * 1e3:.4f} ms): " + "; ".join(
            f"{n} " + " / ".join(f"{t:.4f}" for t in ts)
            for n, ts in times.items()), flush=True)
        del x, w, want, out
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "gmm_variants.json"),
              "w") as f:
        json.dump(record, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
