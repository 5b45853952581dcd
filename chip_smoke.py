#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: the policy-decision main path on
one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device — the card, and ``nvidia-smi``'s name and power limit;
2. build — the CUDA policy kernel of every shipped policy, one ``nvcc``
   per source, all in parallel;
3. kernel against its plain version — for every shipped policy the
   kernel, the plain PyTorch version (on the card) and the interpreter
   agree bit for bit on seeded maps and ctx samples (ret, ctx, every map);
4. unsafe programs — the §5.2 suite is rejected at load, nothing built;
5. main path — a ``CollectiveDispatcher(tier="cuda")`` with the §5.3
   closed loop (adapt_profiler -> pinned adapt_map -> adapt_tuner, plus
   bucket_tuner / bucket_profiler) takes 10,000 ``decide()`` calls over 8
   ranks, 4 KiB - 1 GiB messages and an AllReduce / AllGather /
   ReduceScatter mix, with profiler feeds between them and a warm
   ``link.replace()`` at decision 5,000; the same stream on
   ``tier="interp"`` must give the identical decisions and map bytes;
   zero host fallbacks, zero warm uploads, kernel launches equal to the
   policy invocations;
6. timing — per-decision latency of cuda beside interp and the host
   floor (empty launch + 8-byte copy back); each main-path kernel's
   device time (launches queued behind a spin kernel, so they run back
   to back on the card) beside its bound, the device time of an empty
   launch timed the same way, and beside its plain version; the bridge
   call split into its host and device parts; a ``torch.profiler``
   trace of a window of decisions for device time by kernel and the
   device's busy share.

The last three lines are the kernel table, the card's name and power
limit, and the device record; the full record also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, os.path.join(ROOT, "tests"))   # torch_samples

N_DECISIONS = 10_000
N_SAMPLES = 8           # ctx samples per policy in the differential phase
N_TRACE = 200           # decisions in the profiler window
TIMING_REPS = 300       # launches per device-time measurement
SPIN_NS = 100_000_000   # the spin kernel's hold: far longer than queueing
MAIN_PATH = ("bucket_tuner", "adapt_tuner", "adapt_profiler",
             "bucket_profiler")
KERNEL_SOURCE = "src/repro_torch/core/csrc/policy_kernel.cuh"
REPLACES = "src/repro/core/pallasc.py:175"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def log(*args) -> None:
    print(*args, flush=True)


def pct(xs, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


# ---------------------------------------------------------------------------
# phase 3: kernel == plain version == interpreter, every shipped policy
# ---------------------------------------------------------------------------

def max_abs_diff(a, b) -> int:
    """Largest |a - b| over u64 words (0 iff bit-identical)."""
    import numpy as np
    x = np.asarray(a, dtype="<i8").view("<u8").astype(object).ravel()
    y = np.asarray(b, dtype="<i8").view("<u8").astype(object).ravel()
    return max((abs(int(p) - int(q)) for p, q in zip(x, y)), default=0)


def differential(kernel, device, seed: int) -> dict:
    """Run ``kernel`` (in place), torchc and the VM over seeded inputs;
    returns the worst disagreement per output."""
    import numpy as np
    import torch

    import torch_samples as samples
    from repro_torch.core import torchc
    from repro_torch.core.vm import VM

    prog = kernel.prog
    host = samples.make_maps(prog, np.random.default_rng(seed))
    vm = VM(prog.insns, host, subprogs=prog.subprogs)
    k_maps = {n: torchc.map_to_array(m, device) for n, m in host.items()}
    p_maps = {n: t.clone() for n, t in k_maps.items()}
    rng = np.random.default_rng(seed + 1)
    worst = 0
    for _ in range(N_SAMPLES):
        buf = samples.make_ctx(prog, rng)
        k_ctx = torchc.ctx_to_vec(buf, device)
        ret = torch.zeros(1, dtype=torch.int64, device=device)
        kernel.launch(k_ctx, ret, k_maps)
        p_ret, p_ctx, p_maps = torchc.run(prog, kernel.vinfo,
                                          torchc.ctx_to_vec(buf, device),
                                          p_maps)
        v_buf = bytearray(buf)
        v_ret = vm.run(v_buf) & ((1 << 64) - 1)
        if device.type == "cuda":
            torch.cuda.synchronize()
        k_ret = int(ret.cpu()[0]) & ((1 << 64) - 1)
        worst = max(worst, abs(k_ret - v_ret),
                    abs(k_ret - (int(p_ret.cpu()) & ((1 << 64) - 1))),
                    max_abs_diff(k_ctx.cpu().numpy(), p_ctx.cpu().numpy()),
                    max_abs_diff(k_ctx.cpu().numpy(),
                                 np.frombuffer(bytes(v_buf), "<i8")))
        for n, m in host.items():
            k = k_maps[n].cpu().numpy()
            worst = max(worst, max_abs_diff(k, p_maps[n].cpu().numpy()),
                        max_abs_diff(k, m.to_device().view("<i8")))
    return {"max_abs_err": worst, "samples": N_SAMPLES}


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------

def traffic(n: int, seed: int) -> list:
    """``n`` seeded ``(coll, size, axis, latency_ns)`` steps of the main
    path: 4 KiB - 1 GiB messages, an AllReduce / AllGather /
    ReduceScatter mix over three axes."""
    import numpy as np

    from repro_torch.core.context import CollType

    rng = np.random.default_rng(seed)
    colls = rng.choice([CollType.ALL_REDUCE, CollType.ALL_GATHER,
                        CollType.REDUCE_SCATTER], n)
    sizes = np.left_shift(1, rng.integers(12, 31, n))        # 4 KiB..1 GiB
    axes = rng.choice(["dp", "tp", "ep"], n)
    lats = rng.integers(2_000, 3_000_000, n)
    return [(int(c), int(s), str(a), int(t))
            for c, s, a, t in zip(colls, sizes, axes, lats)]


def feed(disp, d, latency_ns: int) -> None:
    """The profiler feed that follows a decision's collective."""
    disp.profiler_feed(d.comm_id, latency_ns, coll=d.coll,
                       msg_size=d.size_bytes, channels=d.channels,
                       algo=d.algo)


def closed_loop(tier: str, n: int, seed: int = 11) -> dict:
    """The §5.3 closed loop on ``tier``: ``n`` decisions with profiler
    feeds between them and a warm ``link.replace()`` half way."""
    from repro_torch.collectives import CollectiveDispatcher
    from repro_torch.core import PolicyRuntime
    from repro_torch.policies import (adapt_profiler, adapt_tuner,
                                      bucket_profiler, bucket_tuner)

    rt = PolicyRuntime(tier=tier)
    disp = CollectiveDispatcher(runtime=rt)
    tune = rt.attach(bucket_tuner.program, priority=0)
    rt.attach(adapt_tuner.program, priority=1)
    rt.attach(adapt_profiler.program)
    rt.attach(bucket_profiler.program)

    bridges = [l.fn for s in rt.sections() for l in rt.chain(s)]
    for b in bridges:                       # counts start at 0 here
        if hasattr(b, "kernel"):
            b.kernel.launches = 0
    decisions, times = [], []
    for i, (coll, size, axis, lat) in enumerate(traffic(n, seed)):
        if i == n // 2:
            tune.replace(bucket_tuner.program)
            bridges.append(tune.fn)
            if hasattr(tune.fn, "kernel"):
                tune.fn.kernel.launches = 0
        t0 = time.perf_counter_ns()
        d = disp.decide(coll, size, 8, axis_name=axis)
        times.append(time.perf_counter_ns() - t0)
        decisions.append(d)
        feed(disp, d, lat)
    rt.flush_bridges()
    maps = {name: rt.maps.get(name).to_device().tobytes()
            for name in sorted(rt.maps.names())}
    return {"rt": rt, "disp": disp, "decisions": decisions,
            "times_ns": times, "maps": maps, "bridges": bridges,
            "pinned": rt.maps.pinned_names()}


def warm_uploads(run: dict, n: int = 100) -> int:
    """Uploads made by ``n`` repeat decisions with no host mutation."""
    disp = run["disp"]
    live = [l.fn for l in run["rt"].chain("tuner")]
    before = sum(b.stats.map_uploads for b in live)
    for _ in range(n):
        disp.decide(0, 1 << 20, 8, axis_name="dp")
    return sum(b.stats.map_uploads for b in live) - before


# ---------------------------------------------------------------------------
# phase 6: timing
# ---------------------------------------------------------------------------

def timing_lib():
    """The empty and the spin kernel of ``csrc/timing.cu``, built with
    the policy kernels' flags."""
    import ctypes

    from repro_torch.core import cudac

    lib = cudac.compile_library((cudac.CSRC / "timing.cu").read_text())
    lib.bpf_empty_launch.argtypes = [ctypes.c_void_p]
    lib.bpf_spin_launch.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
    lib.bpf_empty_launch.restype = ctypes.c_int
    lib.bpf_spin_launch.restype = ctypes.c_int
    return lib


def device_ms(lib, launch, reps: int = TIMING_REPS) -> float:
    """Device time of one ``launch()`` (one kernel on the current
    stream).  ``reps`` launches are queued behind the spin kernel, so
    they run back to back on the card once it ends, and CUDA events
    around them read device time, not the host's issue rate.  Fails if
    the host had not queued them all before the spin ended."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(20):
        launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    check(lib.bpf_spin_launch(stream, SPIN_NS) == 0, "spin kernel launch")
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    queued = not start.query()
    end.synchronize()
    check(queued, "timing launches were still being queued when the "
          "spin kernel ended")
    return start.elapsed_time(end) / reps


def empty_device_ms(lib) -> float:
    """Device time of an empty <<<1,1>>> launch, timed as the policy
    kernels are: the launch-bound floor of a one-thread kernel."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        check(lib.bpf_empty_launch(stream) == 0, "empty kernel launch")
    return device_ms(lib, launch)


def host_floor_ms(lib, reps: int = 2000) -> float:
    """Median host time of an empty <<<1,1>>> launch plus an 8-byte
    device-to-host copy and a stream sync: the least a decision's device
    round trip can take."""
    import torch

    dev = torch.zeros(1, dtype=torch.int64, device="cuda")
    host = torch.zeros(1, dtype=torch.int64, pin_memory=True)
    stream = torch.cuda.current_stream()
    out = []
    for i in range(reps + 100):
        t0 = time.perf_counter_ns()
        check(lib.bpf_empty_launch(stream.cuda_stream) == 0,
              "empty kernel launch")
        host.copy_(dev, non_blocking=True)
        stream.synchronize()
        if i >= 100:
            out.append(time.perf_counter_ns() - t0)
    return pct(out, 50) / 1e6


def bridge_breakdown(bridge, reps: int = 500) -> dict:
    """Median host times (us) of one bridge call and of its parts: the
    enqueue of the device round trip (ctx up, the wrapper's checks and
    launch, ctx+ret back), the wait for it (stream sync), and the step
    writeback of the kernel-written maps."""
    import torch

    n = bridge.kernel.n_fields
    buf = bytearray(bridge._io_host[:n].numpy().tobytes())
    stream = torch.cuda.current_stream()
    parts = {"call": [], "enqueue": [], "wait": [], "writeback": []}
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        bridge(bytearray(buf))
        t1 = time.perf_counter_ns()
        bridge._io[:n].copy_(bridge._io_host[:n], non_blocking=True)
        bridge.kernel.launch(bridge._io[:n], bridge._io[n:], bridge._dev)
        bridge._io_host.copy_(bridge._io, non_blocking=True)
        t2 = time.perf_counter_ns()
        stream.synchronize()
        t3 = time.perf_counter_ns()
        bridge._writeback(bridge._written)
        t4 = time.perf_counter_ns()
        parts["call"].append(t1 - t0)
        parts["enqueue"].append(t2 - t1)
        parts["wait"].append(t3 - t2)
        parts["writeback"].append(t4 - t3)
    return {k: pct(v, 50) / 1e3 for k, v in parts.items()}


def kernel_timing(lib, bridge) -> dict:
    """Device time of the bridge's kernel on clones of its main-path
    state, the plain version's time on the same inputs, and their
    disagreement."""
    import torch

    from repro_torch.core import torchc

    k = bridge.kernel
    n = k.n_fields
    ctx0 = bridge._io[:n].clone()
    maps0 = {m: t.clone() for m, t in bridge._dev.items()}
    # one decision each on identical inputs: kernel vs plain version
    ctx, maps = ctx0.clone(), {m: t.clone() for m, t in maps0.items()}
    ret = torch.zeros(1, dtype=torch.int64, device=ctx.device)
    k.launch(ctx, ret, maps)
    p_ret, p_ctx, p_maps = torchc.run(k.prog, k.vinfo, ctx0, maps0)
    torch.cuda.synchronize()
    err = max([max_abs_diff(ret.cpu().numpy(), p_ret.reshape(1).cpu().numpy()),
               max_abs_diff(ctx.cpu().numpy(), p_ctx.cpu().numpy())]
              + [max_abs_diff(maps[m].cpu().numpy(), p_maps[m].cpu().numpy())
                 for m in maps])
    ms = device_ms(lib, lambda: k.launch(ctx, ret, maps))
    # plain version: host-driven, so host clock around a synchronised run
    plain = []
    for _ in range(5):
        t0 = time.perf_counter_ns()
        torchc.run(k.prog, k.vinfo, ctx0, maps0)
        torch.cuda.synchronize()
        plain.append(time.perf_counter_ns() - t0)
    return {"ms": ms, "plain_ms": pct(plain, 50) / 1e6, "max_abs_err": err}


def device_trace(disp, n: int = N_TRACE, seed: int = 12) -> dict:
    """A ``torch.profiler`` trace of ``n`` main-path decisions with their
    feeds: device time by kernel or copy name and the device's busy share
    of the window (host times inside it carry the profiler's cost)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    steps = traffic(n, seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        for coll, size, axis, lat in steps:
            feed(disp, disp.decide(coll, size, 8, axis_name=axis), lat)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter_ns() - t0) / 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = by_name.setdefault(e.name, [0, 0.0])
            t[0] += 1
            t[1] += e.time_range.elapsed_us()
    if not by_name:
        return {"not_measured": "the profiler recorded no device events"}
    busy_us = sum(t for _, t in by_name.values())
    return {"decisions": n, "wall_us": wall_us, "busy_us": busy_us,
            "busy_share": busy_us / wall_us,
            "by_name": {k: {"count": c, "us": t, "us_each": t / c}
                        for k, (c, t) in by_name.items()}}


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2

    from repro_torch.core import PolicyRuntime, VerifierError, cudac
    from repro_torch.device import have_nvcc
    from repro_torch.policies import ALL_POLICIES, UNSAFE_PROGRAMS

    # ---- 1. device ---------------------------------------------------------
    t_start = time.time()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    check(bool(smi), "nvidia-smi gave no name/power limit")
    log(f"[device] {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvcc {'yes' if have_nvcc() else 'NO'}")
    check(have_nvcc(), "no nvcc")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.time()
    kernels = cudac.build_all(cudac.PolicyKernel(p.program)
                              for p in ALL_POLICIES)
    build_s = time.time() - t0
    stats = cudac.cache_stats()
    log(f"[build] {len(kernels)} policy kernels in {build_s:.1f} s "
        f"(nvcc runs {stats['builds']}, cache hits {stats['cache_hits']})")

    # ---- 3. kernel vs plain version vs interpreter -------------------------
    diff = {}
    for i, k in enumerate(kernels):
        r = differential(k, dev, seed=100 + i)
        check(r["max_abs_err"] == 0,
              f"{k.name}: kernel disagrees (max abs err {r['max_abs_err']})")
        diff[k.name] = {"launches": k.launches, **r}
    log("[kernels] bit-exact vs torchc and the VM: " + " ".join(
        f"{n}={d['launches']}" for n, d in diff.items()))

    # ---- 4. unsafe programs ------------------------------------------------
    builds = cudac.cache_stats()["builds"]
    rt = PolicyRuntime(tier="cuda")
    for bug, (prog, frag) in UNSAFE_PROGRAMS.items():
        try:
            rt.load(prog)
        except VerifierError as e:
            check(frag in str(e), f"{bug}: unexpected rejection {e}")
        else:
            raise RuntimeError(f"chip smoke failed: {bug} loaded")
    check(cudac.cache_stats()["builds"] == builds,
          "a kernel was built for an unsafe program")
    log(f"[unsafe] {len(UNSAFE_PROGRAMS)} programs rejected at load, "
        "nothing built")

    # ---- 5. main path ------------------------------------------------------
    builds = cudac.cache_stats()["builds"]
    t0 = time.time()
    cuda_run = closed_loop("cuda", N_DECISIONS)
    cuda_s = time.time() - t0
    launches: dict = {}
    calls = fallbacks = 0
    for b in cuda_run["bridges"]:
        launches[b.kernel.name] = launches.get(b.kernel.name, 0) \
            + b.kernel.launches
        calls += b.stats.calls
        fallbacks += b.stats.host_fallbacks
        check(b.kernel.launches == b.stats.calls,
              f"{b.kernel.name}: {b.kernel.launches} launches for "
              f"{b.stats.calls} invocations")
    check(fallbacks == 0, f"{fallbacks} host fallbacks on the main path")
    check(cudac.cache_stats()["builds"] == builds,
          "the warm link.replace() rebuilt a kernel")
    for n in MAIN_PATH:
        check(launches.get(n, 0) > 0, f"kernel {n} never launched")
    t0 = time.time()
    interp_run = closed_loop("interp", N_DECISIONS)
    interp_s = time.time() - t0
    check(cuda_run["decisions"] == interp_run["decisions"],
          "cuda and interp decision sequences differ")
    check(cuda_run["maps"] == interp_run["maps"],
          "cuda and interp final map bytes differ")
    warm = warm_uploads(cuda_run)
    check(warm == 0, f"{warm} uploads on warm repeat decisions")
    n_policy = sum(d.from_policy for d in cuda_run["decisions"])
    log(f"[main] {N_DECISIONS} decisions: cuda {cuda_s:.1f} s, interp "
        f"{interp_s:.1f} s; identical decisions and maps "
        f"({', '.join(cuda_run['pinned'])} pinned); {n_policy} from "
        f"policy; launches {launches} = {calls} invocations; "
        f"host_fallbacks 0; warm uploads 0")

    # ---- 6. timing ---------------------------------------------------------
    lib = timing_lib()
    host_floor = host_floor_ms(lib)
    empty_ms = empty_device_ms(lib)
    lat = {t: {"p50_us": pct(r["times_ns"], 50) / 1e3,
               "p99_us": pct(r["times_ns"], 99) / 1e3}
           for t, r in (("cuda", cuda_run), ("interp", interp_run))}
    log(f"[latency] per decide(): cuda p50 {lat['cuda']['p50_us']:.1f} us "
        f"p99 {lat['cuda']['p99_us']:.1f} us; interp p50 "
        f"{lat['interp']['p50_us']:.1f} us p99 "
        f"{lat['interp']['p99_us']:.1f} us; host floor (empty launch + "
        f"8 B copy back + sync) {host_floor * 1e3:.2f} us; {smi}")
    live = {l.fn.kernel.name: l.fn for s in cuda_run["rt"].sections()
            for l in cuda_run["rt"].chain(s)}
    table = []
    for n in MAIN_PATH:
        t = kernel_timing(lib, live[n])
        check(t["max_abs_err"] == 0, f"{n}: kernel disagrees on the "
              f"main-path state (max abs err {t['max_abs_err']})")
        # the bound: an empty launch timed the same way; the bytes the
        # kernel must move (ctx, the return word, a few map rows) take
        # nanoseconds at 3.35 TB/s, so the launch bounds it
        table.append({"name": f"policy_kernel[{n}]", "route": "cuda",
                      "source": KERNEL_SOURCE, "replaces": REPLACES,
                      "launches": launches[n],
                      "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                      "plain_ms": t["plain_ms"], "bound_ms": empty_ms,
                      "bound_by": "launch", "library_ms": None})
    log("[kernel time] ms per launch, back to back on the card: " + "; ".join(
        f"{r['name']} {r['ms']:.6f}" for r in table)
        + f"; empty launch {empty_ms:.6f}")

    parts = {n: bridge_breakdown(live[n]) for n in MAIN_PATH}
    log("[breakdown] median us per bridge call (call = enqueue + wait + "
        "writeback + host work): " + "; ".join(
            f"{n} " + " ".join(f"{k} {v:.1f}" for k, v in p.items())
            for n, p in parts.items()))
    try:
        trace = device_trace(cuda_run["disp"])
    except Exception as e:     # a measurement, not a check of the path
        trace = {"not_measured": f"torch.profiler failed: {e}"}
    if "not_measured" in trace:
        log(f"[trace] device busy share not measured: "
            f"{trace['not_measured']}")
    else:
        log(f"[trace] {trace['decisions']} decisions under torch.profiler: "
            f"device busy {trace['busy_us']:.1f} of {trace['wall_us']:.1f} "
            f"us ({100 * trace['busy_share']:.2f}%); " + "; ".join(
                f"{k} x{v['count']} {v['us_each']:.2f} us each"
                for k, v in sorted(trace["by_name"].items())))

    record = {"device": name, "nvidia_smi": smi, "build_s": build_s,
              "differential": diff, "latency": lat,
              "host_floor_ms": host_floor, "empty_launch_ms": empty_ms,
              "breakdown_us": parts, "trace": trace,
              "main_path_s": {"cuda": cuda_s, "interp": interp_s},
              "kernels": table, "wall_s": time.time() - t_start}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=float)
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
