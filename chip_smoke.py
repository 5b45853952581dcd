#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: the policy-decision main path on
one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device — the card, and ``nvidia-smi``'s name and power limit;
2. build — the CUDA policy kernel of every shipped policy, one ``nvcc``
   per source, all in parallel, and beside them the same programs in the
   earlier design (the memory frame, ``<<<1,1>>>``) as one library; per
   program its frame routes and block, and per entry
   ``cudaFuncGetAttributes``' local bytes, registers and shared bytes,
   local bytes 0 on route ``regs`` checked;
3. kernel against its plain version — for every shipped policy the
   kernel, the plain PyTorch version (on the card) and the interpreter
   agree bit for bit on seeded maps and ctx samples (ret, ctx, every map);
   then every program's B1 timed on phase 3's state beside the earlier
   design on the same state (both bit-exact there), and the empty launch
   on one warp, the block of a program that scans a map;
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
   device's busy share (a trace that fails, or records no device event,
   fails the run);
7. pair-form kernel (B2) — for every shipped policy without an
   ``lru_hash`` map the pair-form kernel, its plain version (on the card)
   and the interpreter agree bit for bit on the seeded samples in pair
   layout; the ``lru_hash`` policies are rejected for ``cuda32`` with the
   reference's message and nothing is built for them; the pair-form
   golden programs of ``tests/torch_samples.py`` run through the kernel
   (built as bundles of programs) and equal the interpreter; every
   pair-form program's B2 timed on phase 7's state beside the earlier
   design;
8. in-graph closed loop — a ``CollectiveDispatcher(tier="cuda")`` with
   ``bucket_tuner`` attached, its map warmed by decisions and
   ``bucket_profiler`` feeds; ``make_ingraph`` with ``tier="cuda32"``,
   ``"cuda"`` and ``"torch"`` (the plain version on the CPU) each run 8
   shard states (one per rank) for 1,000 steps over seeded 4 KiB - 1 GiB
   messages: every ``(algo, channels)`` equal across the tiers, fault
   flags drained, the shard states merged into host maps that are
   byte-identical across the tiers, kernel launches equal to the
   ``decide`` calls; timing of the in-graph step (decide, host read,
   pick) and of the pair-form kernel beside its bound and plain version;
9. collectives — an 8-rank ``gloo`` group (kernels built before the
   spawn, so the ranks only load them): each rank keeps its policy state
   on ``cuda:0`` and runs ``sel.all_reduce`` (``make_ingraph(tier=
   "cuda32")``) and the dispatcher's ``all_reduce`` / ``reduce_scatter``
   / ``all_gather`` / ``all_to_all`` on host tensors over 32 seeded
   4 KiB - 16 MiB f32 messages, each output allclose to torch's own
   collective (rtol = atol = 1e-5 for SIMPLE, 2e-2 where a bf16 wire was
   chosen), at least two algorithms run; the rank states are gathered
   and merged.  Then a 1-rank NCCL group on the card runs the
   dispatcher's entry points on 256 MiB CUDA tensors.  A single H100
   cannot hold a multi-rank NCCL group (NCCL refuses two ranks on one
   device), so the multi-rank payloads travel over ``gloo``;
10. model kernels (B3-B5) — ``fused_rmsnorm``, ``grouped_matmul`` and
   ``flash_attention`` (built in phase 2, in parallel with the policy
   kernels): at the CPU tests' shapes, float32 and bfloat16, each CUDA
   kernel within rtol = atol = 2e-5 / 2e-2 of its plain version on the
   card, rows without keys exactly 0, the grouped matmul on both bf16
   routes (``wgmma`` fed by TMA, and WMMA where TMA cannot describe the
   operands) as ``gmm_plan`` states; then ten full-width bf16 cells
   from shipped configs (qwen3-1.7b, qwen2.5-32b, olmoe-1b-7b,
   llama4-scout-17b-a16e, llava-next-mistral-7b, recurrentgemma-9b,
   stablelm-12b) through the public ops with the launch counts set to 0
   before each and read after (one launch each, two for a split-KV
   attention call; the grouped matmul on the ``wgmma`` route), each
   output within 2e-2 of the plain version and, element by element,
   within two bf16 steps of it plus half a step at its RMS; each
   kernel's device time beside its bound (bytes at 3.35 TB/s or
   operations at 989 TFLOP/s), its plain version's time and one PyTorch
   call's (``F.rms_norm``, ``torch.bmm``, SDPA with the backend its
   dispatcher picks named), the grouped matmul's also beside the WMMA
   kernel's on the same inputs; fused RMSNorm's residual stream
   bit-exact, its route and grid, and it and ``F.rms_norm`` timed hot
   (one input set) and L2-cold (input sets in turn that exceed the
   L2), beside the smem route on one block a row (the kernel's earlier
   design); rows without keys exactly 0 at a model's width.  Then B5 for
   training at the two training cells' attention shapes (qwen3-1.7b B 4
   x 16 heads over 8 x S 2048 x 128; moonlight-16b-a3b B 2 x 16 x S 4096,
   q/k 192 and v 128): the models' ``_sdpa`` forward and backward timed
   first, then the forward with the log-sum-exp and the backward (three
   launches), each output and gradient within two bf16 steps of its plain
   version, the backward's bits repeated, each timed beside its bound
   (the open operations at 989 TFLOP/s), the plain versions' time and
   SDPA's forward and backward (the yardstick).  Before the
   cells, the operand dtypes the reference takes beyond one of float32
   or bfloat16 (mixed, and float16): at the test shapes each kernel
   within its output dtype's tolerance of its plain version, with the
   launches each call made and the route its plan names (RMSNorm a
   dtype code per operand; the grouped matmul and attention widened to
   float32 for their float32 kernels).  Nothing in the phase is caught;
11. host tiers and the observability plane — ``have_cc()``, the compiler
   it found and the tier ``auto`` resolves to; every shipped policy on
   ``jit``, ``native`` and ``auto`` identical to ``interp`` on phase 3's
   seeded maps and ctx samples (ret, ctx, every map byte), native as
   machine code wherever ``have_cc()`` holds; phase 5's closed loop on
   ``CollectiveDispatcher(tier="native")`` and ``(tier="jit")``, every
   decision and final map byte identical to interp's and cuda's, with
   every kernel's launch count set to 0 before and still 0 after; the
   host-clock ``decide()`` p50/p99 of native, jit, cuda and interp and
   the ``runtime.invoke`` p50/p99 of the Table 1 policies on jit and
   native, beside the host CPU's model (``lscpu``); a ``FlightRecorder``
   on phase 5's cuda runtime (the profiler suite attached) over 2,000
   more decisions, its ``Exporter`` lines valid by the exporter's own
   validator, its histogram counting every decision, and both equal to
   the same run's on interp.  Nothing in the phase is caught;
12. the model zoo and the serving engine — qwen3-1.7b at full width and
   depth (28 layers, D 2048, V 151,936, bf16; weights from the port's
   ``init_params`` seeded on the card, cast once to bf16 by the engine)
   served by ``ServeEngine`` (8 slots x 512 ctx, 16 requests of 16-64
   prompt tokens, 32 new tokens each) while the §5.3 loop runs on
   ``tier="cuda"`` as ``examples/serve_adaptive_torch.py`` attaches it:
   each tick's latency fed to ``adapt_profiler`` (one B1 launch per
   feed), then one ``adapt_tuner`` decision (one launch), launch counts
   set to 0 just before the run and read just after; every request done
   with 32 tokens in fewer ticks than serial, one prompt in two slots
   giving the same tokens, the latency stream replayed on ``interp``
   giving the same ``adapt_map`` bytes and ``Decision``, 0 host
   fallbacks, 0 uploads over 100 warm repeat decisions, 0 model-kernel
   launches (the models call none); a 64-token prompt's decode logits
   within 2^-2 rms of ``forward_logits`` per element and 2^-5 rms over
   all, with the greedy tokens equal wherever the top-2 margin exceeds
   the per-element limit, beside bf16's own distance from the f32
   forward; tick p50/p99, tokens/s, ``prefill`` at B 1 x S 2048 and the
   peak memory; the two policy kernels of the path timed beside their
   bound and plain version.  Nothing in the phase is caught;
13. the training path — tinyllama-1.1b at full width and depth (22
   layers, D 2048, H 32 / KV 4, F 5632, V 32,000; bf16 activations, f32
   master weights from the port's ``init_params`` seeded on the card,
   ``remat``) trained by ``Trainer`` for 12 steps of B 8 x S 2048 (lr
   3e-4, 3 warmup steps) while the §5.3 loop runs on ``tier="cuda"``
   (each step's latency fed to ``adapt_profiler``, one B1 launch per
   step, launch counts set to 0 just before the run and read just
   after); a checkpoint at step 6, then the tuner's link replaced warm
   (the trainer rebuilds its step once, no step lost); one
   ``adapt_tuner`` decision after the run.  Checks: every loss finite,
   step 1 within 0.15 of ln V + sigma^2/2 (sigma measured on step 1's
   logits), the last three losses below the first three; step 1 in bf16
   within 1e-3 (loss) and 2e-2 (``grad_norm``) of the same params' f32
   evaluation; a fresh ``Trainer`` restored from step 6 reaches the
   unbroken run's params and moments bit for bit (deterministic
   algorithms on); the feeds replayed on ``interp`` give the same
   ``adapt_map`` bytes and ``Decision``; 0 host fallbacks.  Printed: step
   p50/p99, tokens/s, model FLOP/s as a share of 989 TFLOP/s, peak
   memory, a ``torch.profiler`` step's busy share and top device ops, and
   B1 timed on the trainer's state (``@training`` rows).  Then a
   ``dp = 2`` leg: 2 ``gloo`` ranks at smoke width with FSDP on the bf16
   wire and ``size_aware`` on ``tier="cuda"`` (state on cuda:0, payloads
   on the host), gradient sync bucketed and not: params and moments
   within 2e-2 of a 1-rank run after 3 steps, B1 launches equal to the
   decisions the decision cache did not serve, every collective running
   the algorithm its decision named.  Nothing in the phase is caught;
14. the launch plane — (a) ``launch.dryrun.lower_combo`` for
   tinyllama-1.1b ``train_4k`` and qwen3-1.7b ``prefill_32k`` and
   ``decode_32k`` on the (16, 16) and (2, 16, 16) meshes, one child
   process per mesh holding a fake process group of its 256 or 512
   ranks, one rank's step traced on meta tensors with ``ring_mid_v2``
   deciding on ``tier="cuda"``: every combo ``ok``, B1's launches equal
   to the decisions the decision cache did not serve, each result line
   printed; (b) the dry run of phase 13's own step (full-width
   tinyllama-1.1b, B 8 x S 2048, remat, one rank) against phase 13's
   measurements: FLOPs within 0.5% of ``FlopCounterMode``'s count on
   phase 13's profiled step, the predicted working set within 15% of
   ``max_memory_allocated``, ``t_compute`` at or below the step p50;
   (c) ``make_serve_step`` serving qwen3-1.7b at full width in bf16,
   prefill at B 1 x S 2048 then 16 decode steps, logits, tokens and
   caches bit-equal to ``prefill`` / ``decode_step`` called directly,
   ms per prefill and per decode step; (d) ``quickstart_torch`` and
   ``policy_authoring_torch`` on the card (B1, and B2 for the in-graph
   tier) deciding as with ``--cpu``, every kernel they ran launched.
   B1 timed on a decision of the dry runs' traffic (``@dryrun`` row).
   Nothing in the phase is caught;
15. the sync-free in-graph step — (a) every shipped policy through
   ``torchc.compile_predicated`` on the card on phase 3's seeded maps and
   ctx samples, eagerly under ``set_sync_debug_mode("error")`` and as
   replays of one ``torch.cuda.CUDAGraph`` capture (each sample copied
   into the static inputs), bit-exact against B1 and the interpreter,
   with no host read (a ``TorchDispatchMode`` counts
   ``aten._local_scalar_dense``); per policy its ATen ops, eager host ms,
   device us per replay and B1's device us; (b) ``adaptive_ingraph``'s
   ``sel.all_reduce`` on ``tier="cuda"``, ``"cuda32"`` and ``"torchc"``
   over a 1-rank NCCL group and a 16 MiB f32 ``x`` on the card: the
   stream of ``tests/test_ingraph_dispatch.py`` then 1,000 seeded
   log-uniform latencies (1e3-1e7 ns), first eagerly, then as replays of
   one captured step (decision, the port's switch node over the four
   branches, ``y``'s error as a device running max, the algo logged at
   the write cursor, the state copied into the static state), each
   latency written by a device fill, every replay under sync-debug
   ``"error"``: algos equal to the eager run's and across the tiers, the
   reference stream 0 -> 2 -> 0, the final state bytes equal, the
   decision count 1,018, ``y == x``, ``host_syncs`` unchanged by the
   replays; each branch body run as often as its algo was decided, by a
   device counter each body bumps (on one rank ``y == x`` whichever body
   runs: NCCL launches nothing for an in-place 1-rank sum); in a
   ``torch.profiler`` window of replays the policy kernel and the switch
   once per replay; a capture over a gloo group refused.  (c) host us per replay (p50,
   p99; outside sync-debug, before any profiler), device us per replay,
   the window's busy share, beside phase 8's eager step parts and the
   same step captured without the all-reduce;
   ``@captured`` rows for B1 and B2 (the kernel's duration in a replay
   beside an empty kernel's in a graph).  (d) ``torchc`` selectors built
   with ``device=None``, ``"cuda"`` and ``"cuda:<current>"``, each one's
   ``all_reduce`` captured over the same group with the latency a tensor
   on the card and replayed over the first 64 latencies under
   sync-debug ``"error"``: every selector holds the card as its tensors
   report it, and each run gives ``device=None``'s algos and state bytes
   with 0 host reads.  Nothing in the phase is caught.

The last three lines are the kernel table, the card's name and power
limit, and the device record; the full record also goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(1, os.path.join(ROOT, "tests"))   # torch_samples
sys.path.insert(2, os.path.join(ROOT, "examples"))  # serve_adaptive_torch

N_DECISIONS = 10_000
N_SAMPLES = 8           # ctx samples per policy in the differential phase
N_TRACE = 200           # decisions in the profiler window
TIMING_REPS = 300       # launches per device-time measurement
SPIN_NS = 100_000_000   # the spin kernel's hold: far longer than queueing
MODEL_SPIN_NS = 20_000_000  # phase 10's hold: 100 launches' queueing at most
MODEL_REPS = 100        # launches per phase-10 window: a call may launch
                        # several kernels, and the card's launch queue is
                        # finite (a full queue blocks the host)
MAIN_PATH = ("bucket_tuner", "adapt_tuner", "adapt_profiler",
             "bucket_profiler")
KERNEL_SOURCE = "src/repro_torch/core/csrc/policy_kernel.cuh"
REPLACES = "src/repro/core/pallasc.py:175"
KERNEL32_SOURCE = "src/repro_torch/core/cudac.py"
REPLACES32 = "src/repro/core/pallasc.py:229"
N_SHARDS = 8            # shard states of the in-graph loop (one per rank)
N_STEPS = 1_000         # in-graph steps per shard state
N_WARM = 200            # decisions + feeds that warm the tuner's map
N_RANKS = 8             # ranks of the gloo group
N_COLL_STEPS = 32       # collective steps per rank
M64 = (1 << 64) - 1


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


def pair_words(t):
    """A pair-form tensor as its u64 words (int64), for max_abs_diff."""
    from repro_torch.core.pair import pairs_to_words
    return pairs_to_words(t.cpu()).numpy()


def differential(kernel, device, seed: int, pairs: bool = False) -> dict:
    """Run ``kernel`` (in place), its plain version and the VM over seeded
    inputs — u64 words, or with ``pairs`` the pair form (B2) — and return
    the worst disagreement over every output."""
    import numpy as np
    import torch

    import torch_samples as samples
    from repro_torch.core import pair, torchc
    from repro_torch.core.vm import VM

    if pairs:
        to_map, to_ctx = pair.map_to_array32, pair.ctx_to_vec32
        launch, plain = kernel.launch32, torchc.run32
        new_ret = lambda: torch.zeros(2, dtype=torch.int32,   # noqa: E731
                                      device=device)
        ret_int, words = pair.ret32_to_int, pair_words
    else:
        to_map, to_ctx = torchc.map_to_array, torchc.ctx_to_vec
        launch, plain = kernel.launch, torchc.run
        new_ret = lambda: torch.zeros(1, dtype=torch.int64,   # noqa: E731
                                      device=device)
        ret_int = lambda r: int(r.reshape(-1)[0]) & M64       # noqa: E731
        words = lambda t: t.cpu().numpy()                     # noqa: E731
    prog = kernel.prog
    host = samples.make_maps(prog, np.random.default_rng(seed))
    vm = VM(prog.insns, host, subprogs=prog.subprogs)
    k_maps = {n: to_map(m, device) for n, m in host.items()}
    p_maps = {n: t.clone() for n, t in k_maps.items()}
    rng = np.random.default_rng(seed + 1)
    worst = 0
    for _ in range(N_SAMPLES):
        buf = samples.make_ctx(prog, rng)
        k_ctx = to_ctx(buf, device)
        ret = new_ret()
        launch(k_ctx, ret, k_maps)
        p_ret, p_ctx, p_maps = plain(prog, kernel.vinfo, to_ctx(buf, device),
                                     p_maps)
        v_buf = bytearray(buf)
        v_ret = vm.run(v_buf) & M64
        torch.cuda.synchronize()
        k_ret = ret_int(ret)
        worst = max(worst, abs(k_ret - v_ret), abs(k_ret - ret_int(p_ret)),
                    max_abs_diff(words(k_ctx), words(p_ctx)),
                    max_abs_diff(words(k_ctx),
                                 np.frombuffer(bytes(v_buf), "<i8")))
        for n, m in host.items():
            k = words(k_maps[n])
            worst = max(worst, max_abs_diff(k, words(p_maps[n])),
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
    from repro_torch.policies import (adapt_profiler, adapt_tuner,
                                      bucket_profiler, bucket_tuner)

    disp = CollectiveDispatcher(tier=tier)
    rt = disp.runtime
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

    lib = cudac.compile_library((cudac.CSRC / "timing.cu").read_text(),
                                "core/csrc/timing.cu")
    lib.bpf_empty_launch.argtypes = [ctypes.c_void_p]
    lib.bpf_spin_launch.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
    lib.bpf_empty_launch.restype = ctypes.c_int
    lib.bpf_spin_launch.restype = ctypes.c_int
    lib.bpf_empty_warp_launch.argtypes = [ctypes.c_void_p]
    lib.bpf_empty_warp_launch.restype = ctypes.c_int
    return lib


def device_ms(lib, launch, reps: int = TIMING_REPS, warmup: int = 20,
              spin_ns: int = SPIN_NS) -> float:
    """Device time of one ``launch()`` (one kernel on the current
    stream).  ``reps`` launches are queued behind the spin kernel, so
    they run back to back on the card once it ends, and CUDA events
    around them read device time, not the host's issue rate.  A window
    counts only if the host had queued every launch before the spin
    ended; one it had not (the shared host stalled) is measured again
    behind a spin four times longer, and the third such window fails."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(warmup):
        launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        check(lib.bpf_spin_launch(stream, spin_ns) == 0, "spin kernel launch")
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        spin_ns *= 4
    check(False, f"timing launches were still being queued when the spin "
          f"kernel ended, three times (the last spin {spin_ns // 4} ns)")


def empty_device_ms(lib) -> float:
    """Device time of an empty <<<1,1>>> launch, timed as the policy
    kernels are: the launch-bound floor of a one-thread kernel."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        check(lib.bpf_empty_launch(stream) == 0, "empty kernel launch")
    return device_ms(lib, launch)


def empty_warp_ms(lib) -> float:
    """Device time of an empty launch on one warp, the block of a policy
    kernel whose program scans a map."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        check(lib.bpf_empty_warp_launch(stream) == 0,
              "empty kernel launch on one warp")
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
    """Median host times (us) of one bridge call and of its parts, read
    from the bridge's own spans (``repro_torch.obs.trace``) over ``reps``
    calls on the last call's ctx under a CPU-activity profiler session:
    the call, the upload of host-dirty maps, the enqueue of the device
    round trip (ctx up, the launch, ctx+ret back), the wait for it
    (stream sync), and the step writeback of the kernel-written maps."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace

    n = bridge.kernel.n_fields
    buf = bytearray(bridge._io_host[:n].numpy().tobytes())
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(reps):
            bridge(bytearray(buf))
    return {k: pct(trace.spans("bridge." + k)["dur_ns"], 50) / 1e3
            for k in ("call", "upload", "enqueue", "wait", "writeback")}


def kernel_timing(lib, kernel, ctx0, maps0, pairs: bool = False,
                  earlier=None, plain_reps: int = 5) -> dict:
    """Device time of ``kernel`` (its pair form with ``pairs``) on clones
    of inputs ``ctx0`` / ``maps0``, its plain version's time on the same
    inputs, and their disagreement; with ``earlier`` (the same program
    built in the earlier design) also that kernel's time and
    disagreement on its own clones, timed right after."""
    import torch

    from repro_torch.core import torchc

    plain = torchc.run32 if pairs else torchc.run
    words = pair_words if pairs else (lambda t: t.cpu().numpy())
    p_ret, p_ctx, p_maps = plain(kernel.prog, kernel.vinfo, ctx0, maps0)
    out = {}
    for tag, k in (("", kernel), ("earlier_", earlier)):
        if k is None:
            continue
        launch = k.launch32 if pairs else k.launch
        # one decision each on identical inputs: kernel vs plain version
        ctx, maps = ctx0.clone(), {m: t.clone() for m, t in maps0.items()}
        ret = torch.zeros(2, dtype=torch.int32, device=ctx.device) if pairs \
            else torch.zeros(1, dtype=torch.int64, device=ctx.device)
        launch(ctx, ret, maps)
        torch.cuda.synchronize()
        err = max([max_abs_diff(words(ret.reshape(-1, 2) if pairs else ret),
                                words(p_ret.reshape(-1, 2) if pairs
                                      else p_ret.reshape(1))),
                   max_abs_diff(words(ctx), words(p_ctx))]
                  + [max_abs_diff(words(maps[m]), words(p_maps[m]))
                     for m in maps])
        out[tag + "ms"] = device_ms(lib, lambda: launch(ctx, ret, maps))
        out[tag + "max_abs_err"] = err
    # plain version: host-driven, so host clock around a synchronised run
    times = []
    for _ in range(plain_reps):
        t0 = time.perf_counter_ns()
        plain(kernel.prog, kernel.vinfo, ctx0, maps0)
        torch.cuda.synchronize()
        times.append(time.perf_counter_ns() - t0)
    return {**out, "plain_ms": pct(times, 50) / 1e6}


def policy_row(name: str, k, launches: int, t: dict, empty_ms: float,
               report: dict, pairs: bool = False) -> dict:
    """A kernels-line row of B1 (B2 with ``pairs``).  The bound: an empty
    launch timed the same way; the bytes the kernel must move (ctx, the
    return word, a few map rows) take
    nanoseconds at 3.35 TB/s, so the launch bounds it."""
    entry = "kernel32" if pairs else "kernel"
    return {"name": name, "route": "cuda",
            "source": KERNEL32_SOURCE if pairs else KERNEL_SOURCE,
            "replaces": REPLACES32 if pairs else REPLACES,
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": empty_ms,
            "bound_by": "launch", "library_ms": None,
            "earlier_ms": t["earlier_ms"],
            "frame_routes": report["routes"], "threads": report["threads"],
            "shared_bytes": report["attrs"][entry]["shared_bytes"],
            "local_bytes": report["attrs"][entry]["local_bytes"],
            "registers": report["attrs"][entry]["registers"]}


# the kernel the port shipped before its Hopper redesign: the memory
# frame, one thread
EARLIER = {"route": "memory", "one_thread": True}


def earlier_kernels(kernels) -> dict:
    """Each kernel's program built in the earlier design (one library,
    each under its own prefix), by program name."""
    from repro_torch.core import cudac
    built = cudac.build_bundle(
        cudac.PolicyKernel(k.prog, k.vinfo, prefix=f"e{i}_", **EARLIER)
        for i, k in enumerate(kernels))
    return {k.name: k for k in built}


def phase3_state(kernel, dev, seed: int, pairs: bool = False) -> tuple:
    """Phase 3's (or, with ``pairs``, phase 7's) seeded maps and first
    ctx sample for ``kernel``'s program on the card."""
    import numpy as np

    import torch_samples as samples
    from repro_torch.core import pair, torchc

    to_map = pair.map_to_array32 if pairs else torchc.map_to_array
    to_ctx = pair.ctx_to_vec32 if pairs else torchc.ctx_to_vec
    prog = kernel.prog
    host = samples.make_maps(prog, np.random.default_rng(seed))
    buf = samples.make_ctx(prog, np.random.default_rng(seed + 1))
    return to_ctx(buf, dev), {n: to_map(m, dev) for n, m in host.items()}


def kernel_report(k) -> dict:
    """A kernel's frame routes, its block, and each entry's
    ``cudaFuncGetAttributes``; fails where a function on route ``regs``
    left anything in local memory."""
    src = k.source
    attrs = k.attributes()
    if "memory" not in src.routes:
        for entry, a in attrs.items():
            check(a["local_bytes"] == 0, f"{k.name}: {entry} on route regs "
                  f"uses {a['local_bytes']} bytes of local memory")
    return {"routes": list(src.routes), "threads": src.threads,
            "attrs": attrs}



def log_trace(tag: str, what: str, trace: dict) -> None:
    log(f"{tag} {trace['decisions']} {what} under torch.profiler: "
        f"device busy {trace['busy_us']:.1f} of {trace['wall_us']:.1f} "
        f"us ({100 * trace['busy_share']:.2f}%); " + "; ".join(
            f"{k} x{v['count']} {v['us_each']:.2f} us each"
            for k, v in sorted(trace["by_name"].items())))


def main_path_window(disp, n: int = N_TRACE, seed: int = 12):
    """``n`` main-path decisions with their feeds, for :func:`device_trace`."""
    steps = traffic(n, seed)

    def run():
        for coll, size, axis, lat in steps:
            feed(disp, disp.decide(coll, size, 8, axis_name=axis), lat)
    return run


def device_trace(run, n: int = N_TRACE) -> dict:
    """A ``torch.profiler`` trace of ``run()`` (a window of ``n``
    decisions or steps): device time by kernel or copy name and the
    device's busy share of the window (host times inside it carry the
    profiler's cost)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter_ns()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter_ns() - t0) / 1e3
    by_name: dict = {}
    memcpy_us = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t = by_name.setdefault(e.name, [0, 0.0])
            t[0] += 1
            t[1] += e.time_range.elapsed_us()
            if "memcpy" in e.name.lower():
                memcpy_us.append(e.time_range.elapsed_us())
    check(bool(by_name), "torch.profiler recorded no device events")
    busy_us = sum(t for _, t in by_name.values())
    return {"decisions": n, "wall_us": wall_us, "busy_us": busy_us,
            "busy_share": busy_us / wall_us, "memcpy_us": memcpy_us,
            "by_name": {k: {"count": c, "us": t, "us_each": t / c}
                        for k, (c, t) in by_name.items()}}


# ---------------------------------------------------------------------------
# phase 7: the pair-form kernel
# ---------------------------------------------------------------------------

def goldens32(device) -> dict:
    """The pair-form golden programs through the pair-form kernel (built
    as bundles: nvcc's fixed cost dominates programs this small), each
    against its plain version and the VM."""
    import numpy as np
    import torch

    import repro_torch.core as C
    import torch_samples as samples
    from repro_torch.core import cudac, pair, torchc
    from repro_torch.core.vm import VM

    gs = samples.pair_goldens()
    t0 = time.time()
    kernels = cudac.build_bundle(
        cudac.PolicyKernel(g.program(C), prefix=f"g{j}_")
        for j, g in enumerate(gs))
    build_s = time.time() - t0
    worst = 0
    for g, k in zip(gs, kernels):
        host = g.host_maps(C)
        maps = {n: pair.map_to_array32(m, device) for n, m in host.items()}
        buf = C.make_ctx("tuner", **samples.PAIR_CTX).buf
        ctx = pair.ctx_to_vec32(buf, device)
        ret = torch.zeros(2, dtype=torch.int32, device=device)
        k.launch32(ctx, ret, maps)
        p_ret, p_ctx, p_maps = torchc.run32(
            k.prog, k.vinfo, pair.ctx_to_vec32(buf, device),
            {n: pair.map_to_array32(m, device) for n, m in host.items()})
        v_buf = bytearray(buf)
        v_ret = VM(k.prog.insns, host).run(v_buf) & M64
        torch.cuda.synchronize()
        err = max(abs(pair.ret32_to_int(ret) - v_ret),
                  abs(pair.ret32_to_int(ret) - pair.ret32_to_int(p_ret)),
                  max_abs_diff(pair_words(ctx), pair_words(p_ctx)),
                  max_abs_diff(pair_words(ctx),
                               np.frombuffer(bytes(v_buf), "<i8")))
        for n, m in host.items():
            err = max(err, max_abs_diff(pair_words(maps[n]),
                                        pair_words(p_maps[n])),
                      max_abs_diff(pair_words(maps[n]),
                                   m.to_device().view("<i8")))
        check(err == 0, f"golden {g.id}: pair-form kernel disagrees "
              f"(max abs err {err})")
        check(k.launches32 == 1, f"golden {g.id}: kernel not launched")
        worst = max(worst, err)
    return {"goldens": len(gs), "build_s": build_s, "max_abs_err": worst}


# ---------------------------------------------------------------------------
# phase 8: the in-graph closed loop
# ---------------------------------------------------------------------------

def ingraph_steps(seed: int = 21):
    """``N_SHARDS x N_STEPS`` seeded ``(coll, size)`` steps: 4 KiB - 1 GiB
    messages (log2-uniform) over an AllReduce / AllGather /
    ReduceScatter mix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    colls = rng.choice([0, 1, 2], (N_SHARDS, N_STEPS))
    sizes = np.left_shift(1, rng.integers(12, 31, (N_SHARDS, N_STEPS)))
    return colls.tolist(), sizes.tolist()


def warmed_dispatcher(seed: int = 13):
    """``CollectiveDispatcher(tier="cuda")`` with bucket_tuner and
    bucket_profiler attached, the tuner's map warmed by decisions and
    the profiler's by feeds."""
    from repro_torch.collectives import CollectiveDispatcher
    from repro_torch.core import PolicyRuntime
    from repro_torch.policies import bucket_profiler, bucket_tuner

    rt = PolicyRuntime(tier="cuda")
    disp = CollectiveDispatcher(runtime=rt)
    rt.attach(bucket_tuner.program)
    rt.attach(bucket_profiler.program)
    for coll, size, axis, lat in traffic(N_WARM, seed):
        feed(disp, disp.decide(coll, size, 8, axis_name=axis), lat)
    rt.flush_bridges()
    return disp


def ingraph_loop(disp, tier: str, steps) -> dict:
    """``make_ingraph(tier)``: N_SHARDS shard states, N_STEPS each; per
    step the decision, its host read and the pick of the branch.  The
    kernel's launch count is zeroed just before the loop and read just
    after it; then the fault flags are drained and the shards merged into
    a copy of the runtime's maps."""
    import torch

    from repro_torch.collectives.ingraph import _BRANCHES
    from repro_torch.core.maps import MapRegistry

    colls, sizes = steps
    sel, base = disp.make_ingraph(tier=tier)
    states = [dict(base) for _ in range(N_SHARDS)]
    picks, times = [], []
    sel.kernel.launches = sel.kernel.launches32 = 0
    for i in range(N_STEPS):
        for s in range(N_SHARDS):
            t0 = time.perf_counter_ns()
            algo, ch, states[s] = sel.decide(states[s], coll=colls[s][i],
                                             msg_bytes=sizes[s][i], n=8)
            a, c = torch.stack([algo, ch]).tolist()     # one host read
            _BRANCHES[a]
            times.append(time.perf_counter_ns() - t0)
            picks.append((a, c))
    launches = sel.kernel.launches32 if tier == "cuda32" \
        else sel.kernel.launches
    faults = 0
    for s in range(N_SHARDS):
        n, states[s] = sel.drain_faults(states[s])
        faults += n
    reg = MapRegistry()
    for d in sel.program.maps:
        reg.create(d.name, d.kind, key_size=d.key_size,
                   value_size=d.value_size, max_entries=d.max_entries
                   ).from_device(disp.runtime.maps.get(d.name).to_device())
    merged = sel.merge_shard_states(reg, states, base)
    maps = {n: reg.get(n).to_device().tobytes() for n in sorted(reg.names())}
    return {"sel": sel, "states": states, "picks": picks, "times_ns": times,
            "launches": launches, "faults": faults, "merged": merged,
            "maps": maps}


def ingraph_breakdown(sel, state, reps: int = 500) -> dict:
    """Median host us of one in-graph step and of its parts, replayed as
    ``InGraphSelector.decide`` runs them: the ctx (host words, pinned
    upload), the copies of the written leaves, the kernel launch, the
    clamp and counter updates (these three only enqueue), and the host
    read of the decision, which waits for the device."""
    import torch

    from repro_torch.collectives.ingraph import _IDX, CURSOR_KEY, FAULT_KEY
    from repro_torch.core.pair import words_to_pairs

    fields = {"coll_type": 0, "msg_size": 1 << 20, "n_ranks": 8,
              "comm_id": 0, "max_channels": 32}
    names = ("step", "ctx", "copy", "launch", "clamp", "read")
    parts = {k: [] for k in names}
    for _ in range(reps):
        t = [time.perf_counter_ns()]
        algo, ch, _ = sel.decide(state, coll=0, msg_bytes=1 << 20, n=8)
        torch.stack([algo, ch]).tolist()
        t.append(time.perf_counter_ns())
        vec = sel._ctx_vec(fields)
        t.append(time.perf_counter_ns())
        leaves = {k: (v.clone() if k in sel.written_names else v)
                  for k, v in state.items()
                  if k not in (FAULT_KEY, CURSOR_KEY)}
        t.append(time.perf_counter_ns())
        if sel.word_width == 32:
            vec2 = words_to_pairs(vec)
            ret = torch.zeros(2, dtype=torch.int32, device=vec.device)
            sel.kernel.launch32(vec2, ret, leaves)
            raw_a, raw_c = vec2[_IDX["algorithm"], 0], \
                vec2[_IDX["n_channels"], 0]
        else:
            ret = torch.zeros(1, dtype=torch.int64, device=vec.device)
            sel.kernel.launch(vec, ret, leaves)
            raw_a = vec[_IDX["algorithm"]].to(torch.int32)
            raw_c = vec[_IDX["n_channels"]].to(torch.int32)
        t.append(time.perf_counter_ns())
        a, c = raw_a.clamp(0, 3), raw_c.clamp(0, 32)
        bad = ((raw_a != a) | (raw_c != c)).to(torch.int32)
        _ = (state[FAULT_KEY] + bad, state[CURSOR_KEY] + 1)
        t.append(time.perf_counter_ns())
        torch.stack([a, c]).tolist()
        t.append(time.perf_counter_ns())
        parts["step"].append(t[1] - t[0])
        for k, (u, v) in zip(names[1:], zip(t[1:], t[2:])):
            parts[k].append(v - u)
    return {k: pct(v, 50) / 1e3 for k, v in parts.items()}


def ingraph_window(sel, state, n: int = N_TRACE):
    """``n`` in-graph steps (decide + host read), for :func:`device_trace`."""
    import torch

    def run():
        st = state
        for i in range(n):
            algo, ch, st = sel.decide(st, coll=0, msg_bytes=1 << (12 + i % 19),
                                      n=8)
            torch.stack([algo, ch]).tolist()
    return run


# ---------------------------------------------------------------------------
# phase 9: collectives
# ---------------------------------------------------------------------------

def _coll_rank(rank: int, port: int, q) -> None:
    """One rank of the gloo group: the policy state on cuda:0, the
    payloads on the host."""
    try:
        q.put((rank, _coll_rank_body(rank, port)))
    except Exception:       # reported to the parent, which fails the run
        import traceback
        q.put((rank, {"error": traceback.format_exc()}))


def _coll_rank_body(rank: int, port: int) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.collectives import CollectiveDispatcher
    from repro_torch.collectives import algorithms as A
    from repro_torch.core import PolicyRuntime, Proto, cudac
    from repro_torch.core.maps import MapRegistry
    from repro_torch.policies import bucket_profiler, bucket_tuner

    import datetime
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=N_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    torch.cuda.set_device(0)
    rt = PolicyRuntime(tier="cuda")
    disp = CollectiveDispatcher(runtime=rt)
    rt.attach(bucket_tuner.program)
    rt.attach(bucket_profiler.program)
    sel, state = disp.make_ingraph(tier="cuda32")
    base = {k: v.clone() for k, v in state.items()}
    sel.kernel.launches32 = 0
    rng = np.random.default_rng(7)                # the same on every rank
    sizes = np.left_shift(1, rng.integers(12, 25, N_COLL_STEPS)).tolist()
    algos, worst, bad = set(), {"simple": 0.0, "bf16": 0.0}, []

    def cmp(got, want, proto):
        # recorded, not raised: a rank that stopped here would leave the
        # others waiting in the next collective
        key = "simple" if proto == Proto.SIMPLE else "bf16"
        tol = 1e-5 if key == "simple" else 2e-2
        same = got.shape == want.shape
        err = float((got - want).abs().max()) if same else float("inf")
        if not (same and torch.allclose(got, want, rtol=tol, atol=tol)):
            bad.append(f"step {step}: off by {err} (tolerance {tol})")
        worst[key] = max(worst[key], err)

    for step, size in enumerate(sizes):
        # small integers: a bf16 wire carries them, and their sums, exactly
        x = torch.from_numpy(np.random.default_rng(
            (rank, step)).integers(-8, 9, size // 4).astype(np.float32))
        y, algo, state = sel.all_reduce(x, "data", state)
        cmp(y, A.allreduce_native(x), Proto.SIMPLE)
        algos.add(int(algo))
        y = disp.all_reduce(x, "data")
        d = disp.decisions[-1]
        cmp(y, A.allreduce_native(x), d.proto)
        algos.add(d.algo)
        x2 = x.reshape(N_RANKS, -1)
        y = disp.reduce_scatter(x2, "data")
        d = disp.decisions[-1]
        cmp(y, A.reduce_scatter_native(x2), d.proto)
        algos.add(d.algo)
        y = disp.all_gather(x2[0], "data")
        d = disp.decisions[-1]
        cmp(y, A.all_gather_native(x2[0]), d.proto)
        algos.add(d.algo)
        y = disp.all_to_all(x2, "data")
        d = disp.decisions[-1]
        cmp(y, A.all_to_all_native(x2), d.proto)
        algos.add(d.algo)
    launches = sel.kernel.launches32
    shard = {k: v.cpu() for k, v in state.items()}
    gathered = [None] * N_RANKS if rank == 0 else None
    dist.gather_object(shard, gathered, dst=0)
    out = {"algos": sorted(algos), "worst": worst, "bad": bad,
           "launches32": launches,
           "host_syncs": sel.host_syncs, "builds": cudac.cache_stats()
           ["builds"], "decisions": len(disp.decisions)}
    if rank == 0:
        reg = MapRegistry()
        for d in sel.program.maps:
            reg.create(d.name, d.kind, key_size=d.key_size,
                       value_size=d.value_size, max_entries=d.max_entries
                       ).from_device(sel._host_u64(base[d.name]))
        before = sel._host_u64(base["bucket_tune_state"])
        out["merged"] = sel.merge_shard_states(reg, gathered, base)
        after = reg.get("bucket_tune_state").to_device()
        # counts (slot 0 of each used row) grew by one per decide per rank
        used = lambda a: a[:-1, 0][a[:-1, 3] != 0].sum()   # noqa: E731
        out["count_delta"] = int(used(after)) - int(used(before))
    dist.destroy_process_group()
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def gloo_collectives() -> dict:
    """Spawn the gloo group, collect every rank's record, stop them all."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_coll_rank, args=(r, port, q))
             for r in range(N_RANKS)]
    for p in procs:
        p.start()
    try:
        out = dict(q.get(timeout=600) for _ in range(N_RANKS))
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    for r, rec in sorted(out.items()):
        check("error" not in rec, f"rank {r} failed:\n{rec.get('error')}")
    return out


def nccl_one_rank(device) -> dict:
    """A 1-rank NCCL group on the card: the dispatcher's entry points on
    256 MiB CUDA tensors (a one-rank all-reduce is the identity and is
    short-circuited, as in the reference; the others decide and run)."""
    import torch
    import torch.distributed as dist

    from repro_torch.collectives import CollectiveDispatcher
    from repro_torch.collectives.dispatch import _algo_fn
    from repro_torch.core import PolicyRuntime
    from repro_torch.policies import bucket_tuner

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        rt = PolicyRuntime(tier="cuda")
        disp = CollectiveDispatcher(runtime=rt)
        rt.attach(bucket_tuner.program)
        x = torch.randn(64 << 20, device=device)        # 256 MiB of f32
        ran = {}
        for name in ("all_reduce", "reduce_scatter", "all_gather",
                     "all_to_all"):
            ran[name] = []
            for _ in range(2):        # first sighting, then the decision
                n_dec = len(disp.decisions)
                y = getattr(disp, name)(x, "data")
                torch.cuda.synchronize()
                check(torch.equal(y, x), f"1-rank {name} changed its input")
                if len(disp.decisions) > n_dec:
                    d = disp.decisions[-1]
                    ran[name].append(_algo_fn(d.coll, d.algo).__name__)
                else:
                    ran[name].append("identity (n == 1)")
        return {"backend": dist.get_backend(), "bytes": x.numel() * 4,
                "ran": ran}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# phase 10: the model kernels (B3-B5)
# ---------------------------------------------------------------------------

HBM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM data sheet (700 W)
BF16_OPS_PER_S = 989e12     # dense bf16, the same data sheet
L2_BYTES = 50 * 10 ** 6     # the H100's L2, the same data sheet
MODEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}
# The full-width cells are also held element by element to what a bf16
# output can differ by when the kernel and its plain version compute in
# f32 and differ only in summation order: two bf16 steps of the plain
# value (fused RMSNorm rounds y before the scale multiply, then rounds
# the product; one bf16 step is at most 2^-7 of the value) plus half a
# step at the output's RMS, for the f32 differences near 0.  A kernel
# off by 2% where the output is at least its RMS, or by 0.6% of the RMS
# where it is small (a dropped kv tile, a shifted window), fails it.
CELL_RTOL = 2.0 ** -6
CELL_ATOL_RMS = 2.0 ** -8
# full-width cells, bf16 (the configs' dtype), from configs the repo ships
MODEL_CELLS = (
    ("fused_rmsnorm", "qwen3-1.7b train_4k, residual",
     dict(T=4096, D=2048, residual=True)),
    ("fused_rmsnorm", "qwen3-1.7b train_4k",
     dict(T=4096, D=2048, residual=False)),
    ("fused_rmsnorm", "qwen2.5-32b, residual",
     dict(T=4096, D=5120, residual=True)),
    ("grouped_matmul", "olmoe-1b-7b, 4096 tokens",
     dict(E=64, C=640, D=2048, F=1024)),
    # the expert up-projection at 8192 tokens, top-1, capacity factor 1.25
    ("grouped_matmul", "llama4-scout-17b-a16e, 8192 tokens",
     dict(E=16, C=640, D=5120, F=8192)),
    ("flash_attention", "qwen3-1.7b prefill",
     dict(B=1, H=16, KV=8, S=4096, T=4096, d=128, causal=True, window=0)),
    ("flash_attention", "qwen3-1.7b decode",
     dict(B=8, H=16, KV=8, S=1, T=32768, d=128, causal=True, window=0)),
    ("flash_attention", "llava-next-mistral-7b, window 4096",
     dict(B=1, H=32, KV=8, S=8192, T=8192, d=128, causal=True,
          window=4096)),
    ("flash_attention", "recurrentgemma-9b, window 2048",
     dict(B=1, H=16, KV=1, S=4096, T=4096, d=256, causal=True,
          window=2048)),
    ("flash_attention", "stablelm-12b",
     dict(B=1, H=32, KV=8, S=4096, T=4096, d=160, causal=True, window=0)),
)
# the WMMA kernel's time at a grouped-matmul cell as PERF.md records it
# from before the wgmma route (NVIDIA H100 80GB HBM3, 700.00 W)
WMMA_RECORDED_MS = {"olmoe-1b-7b, 4096 tokens": 1.7356}
MODEL_SOURCES = {
    "fused_rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                      "src/repro/kernels/rmsnorm/kernel.py:31"),
    "grouped_matmul": ("src/repro_torch/kernels/grouped_matmul/csrc/"
                       "grouped_matmul.cu",
                       "src/repro/kernels/grouped_matmul/kernel.py:39"),
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:79"),
}


def model_kernels() -> dict:
    """The three model kernels' :class:`CudaKernel` objects, by op name."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.grouped_matmul import kernel as gmm
    from repro_torch.kernels.rmsnorm import kernel as rms
    return {"fused_rmsnorm": rms.KERNEL, "grouped_matmul": gmm.KERNEL,
            "flash_attention": fa.KERNEL}


def build_model_kernels() -> float:
    """Build the three model kernels (one nvcc each, in parallel);
    the seconds it took."""
    from repro_torch.core.cudac import build_all

    t0 = time.time()
    build_all(model_kernels().values())
    return time.time() - t0


def max_err(a, b) -> float:
    """Largest |a - b| over a tensor or a tuple of tensors, in f32."""
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"kernel {a.dtype}{list(a.shape)} against plain "
          f"{b.dtype}{list(b.shape)}")
    return float((a.float() - b.float()).abs().amax())


def kernel_matches_plain(name: str, dtype: str, got, want) -> float:
    """Fail unless ``got`` is allclose to ``want`` at the reference's
    tolerance for ``dtype``; the largest difference."""
    import torch

    tol = MODEL_TOL[dtype]
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        check(bool(torch.isfinite(a.float()).all()),
              f"{name}: non-finite output")
        check(torch.allclose(a.float(), b.float(), rtol=tol, atol=tol),
              f"{name}: kernel disagrees with its plain version (max abs "
              f"err {max_err(a, b)}, tolerance {tol})")
    return max_err(got, want)


def within_bf16_steps(name: str, got, want) -> dict:
    """Fail unless every element of ``got`` lies within ``CELL_RTOL *
    |want| + CELL_ATOL_RMS * rms(want)`` of ``want``; the plain output's
    RMS, the limit at the RMS and the worst ratio of error to limit."""
    import torch

    worst = {"rms": 0.0, "limit_at_rms": 0.0, "err_over_limit": 0.0}
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        a, b = a.float(), b.float()
        rms = float(b.square().mean().sqrt())
        limit = CELL_RTOL * b.abs() + CELL_ATOL_RMS * rms
        ratio = float(((a - b).abs() / limit.clamp_min(1e-30)).amax())
        check(ratio <= 1.0, f"{name}: kernel off its plain version by "
              f"{ratio:.3g}x the limit 2^-6 |plain| + 2^-8 rms (rms "
              f"{rms:.4g}, max abs err {max_err(a, b):.4g})")
        if ratio >= worst["err_over_limit"]:
            worst = {"rms": rms, "limit_at_rms":
                     (CELL_RTOL + CELL_ATOL_RMS) * rms,
                     "err_over_limit": ratio}
        del a, b, limit
    torch.cuda.empty_cache()
    return worst


def model_test_shapes(dev) -> dict:
    """Each kernel against its plain version at the CPU tests' shapes,
    float32 and bfloat16 (``tests/torch_samples.py`` inputs), including
    query rows that see no key; the largest error per kernel."""
    import torch

    import torch_samples as samples
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.grouped_matmul import kernel as gmm
    from repro_torch.kernels.rmsnorm import kernel as rms

    worst = {"fused_rmsnorm": 0.0, "grouped_matmul": 0.0,
             "flash_attention": 0.0}
    for dtype, tdt in (("float32", torch.float32),
                       ("bfloat16", torch.bfloat16)):
        on = lambda a: torch.from_numpy(a).to(dev).to(tdt)   # noqa: E731
        for res in (False, True):
            a = samples.kernel_inputs("rmsnorm", 0, T=256, D=512,
                                      with_residual=res)
            x, r = on(a["x"]), on(a["residual"]) if res else None
            s = torch.from_numpy(a["scale"]).to(dev)
            e = kernel_matches_plain(
                f"fused_rmsnorm {dtype}", dtype,
                rms.fused_rmsnorm_cuda(x, s, r, bt=128),
                rms.fused_rmsnorm_plain(x, s, r, bt=128))
            worst["fused_rmsnorm"] = max(worst["fused_rmsnorm"], e)
        # bf16: the first on wgmma, the second on WMMA (F % 8 != 0)
        for E, C, D, F, kw in ((4, 128, 256, 128, dict(bc=64, bf=64,
                                                       bd=128)),
                               (1, 128, 48, 130, dict(bc=128, bf=130,
                                                      bd=48))):
            a = samples.kernel_inputs("grouped_matmul", 0, E=E, C=C, D=D,
                                      F=F)
            x, w = on(a["x"]), on(a["w"])
            route = gmm.gmm_plan(E, C, D, F, tdt, x.data_ptr(),
                                 w.data_ptr())["route"]
            check(route == {"float32": "cuda cores"}.get(
                dtype, "wgmma" if F % 8 == 0 else "wmma"),
                f"grouped_matmul {dtype} {E, C, D, F}: route {route}")
            e = kernel_matches_plain(
                f"grouped_matmul {dtype} {route}", dtype,
                gmm.grouped_matmul_cuda(x, w, **kw),
                gmm.grouped_matmul_plain(x, w, **kw))
            worst["grouped_matmul"] = max(worst["grouped_matmul"], e)
        # the last: kv heads indexed in the kernel, split-KV in bf16
        for BH, g, S, T, d, kw in (
                (3, 1, 128, 256, 128, dict(bq=64, bk=128)),
                (3, 1, 256, 256, 64, dict(bq=128, bk=64, window=32)),
                (3, 1, 128, 64, 32, dict(bq=64, bk=64)),
                (4, 2, 1, 4096, 128, dict(bq=1, bk=4096))):
            a = samples.kernel_inputs("flash_attention", 0,
                                      q_shape=(BH, S, d),
                                      kv_shape=(BH // g, T, d))
            q, k, v = on(a["q"]), on(a["k"]), on(a["v"])
            got = fa.flash_attention_cuda(q, k, v, group=g, **kw)
            kx, vx = (t.repeat_interleave(g, dim=0) for t in (k, v))
            e = kernel_matches_plain(
                f"flash_attention {dtype} S={S} T={T} d={d} group={g}",
                dtype, got, fa.flash_attention_plain(q, kx, vx, **kw))
            worst["flash_attention"] = max(worst["flash_attention"], e)
            if S > T:
                check(bool((got[:, :S - T] == 0).all()),
                      "flash_attention: a row without keys is not 0")
    torch.cuda.synchronize()
    return worst


# operand dtypes the reference's kernels take besides one of float32 or
# bfloat16 throughout (ROADMAP C7): x (q) in the first, the other
# operands in the second
OPERAND_MIXES = (("bfloat16", "float32"), ("float32", "bfloat16"),
                 ("float16", "float16"), ("float16", "bfloat16"))


def model_operand_dtypes(dev) -> dict:
    """Each CUDA kernel against its plain version on mixed and float16
    operands at the CPU tests' shapes, at the output dtype's tolerance,
    with the launches each call made and the route its plan names:
    RMSNorm reads each operand in its own dtype, the grouped matmul and
    attention widen to float32 for their float32 kernels."""
    import torch

    import torch_samples as samples
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.grouped_matmul import kernel as gmm
    from repro_torch.kernels.rmsnorm import kernel as rms

    DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}

    def on(a, dt):
        return torch.from_numpy(a).to(dev).to(DT[dt])

    def launched(kernel, n, call):
        before = kernel.launches
        out = call()
        torch.cuda.synchronize()
        check(kernel.launches - before == n, f"{kernel.name}: "
              f"{kernel.launches - before} launches, the plan says {n}")
        return out

    worst = {"fused_rmsnorm": 0.0, "grouped_matmul": 0.0,
             "flash_attention": 0.0}
    routes = {}
    for xdt, odt in OPERAND_MIXES:
        tag = f"{xdt} x {odt}"
        a = samples.kernel_inputs("rmsnorm", 0, T=256, D=512,
                                  with_residual=True)
        x, r, sc = on(a["x"], xdt), on(a["residual"], odt), \
            on(a["scale"], odt)
        e = kernel_matches_plain(
            f"fused_rmsnorm {tag}", xdt,
            launched(rms.KERNEL, 1,
                     lambda: rms.fused_rmsnorm_cuda(x, sc, r, bt=128)),
            rms.fused_rmsnorm_plain(x, sc, r, bt=128))
        worst["fused_rmsnorm"] = max(worst["fused_rmsnorm"], e)
        routes[f"fused_rmsnorm {tag}"] = "dtype code per operand"

        E, C, D, F = 4, 128, 256, 128
        a = samples.kernel_inputs("grouped_matmul", 0, E=E, C=C, D=D, F=F)
        x, w = on(a["x"], xdt), on(a["w"], odt)
        plan = gmm.gmm_plan(E, C, D, F, x.dtype, x.data_ptr(), w.data_ptr(),
                            w_dtype=w.dtype)
        check(plan["route"] == "cuda cores" and plan["upcast"],
              f"grouped_matmul {tag}: route {plan['route']}")
        kw = dict(bc=64, bf=64, bd=128)
        e = kernel_matches_plain(
            f"grouped_matmul {tag}", xdt,
            launched(gmm.KERNEL, 1,
                     lambda: gmm.grouped_matmul_cuda(x, w, **kw)),
            gmm.grouped_matmul_plain(x, w, **kw))
        worst["grouped_matmul"] = max(worst["grouped_matmul"], e)
        routes[f"grouped_matmul {tag}"] = "float32 (widened), cuda cores"

        for BH, g, S, T, d, kw in (
                (3, 1, 128, 256, 128, dict(bq=64, bk=128)),
                (4, 2, 96, 160, 64, dict(bq=96, bk=160, window=40))):
            a = samples.kernel_inputs("flash_attention", 0,
                                      q_shape=(BH, S, d),
                                      kv_shape=(BH // g, T, d))
            q, k, v = on(a["q"], xdt), on(a["k"], odt), on(a["v"], odt)
            plan = fa.attention_plan(BH, S, T, d, g, q.dtype, k.dtype,
                                     v.dtype)
            check(plan["kernel"] == "cuda cores" and plan["upcast"],
                  f"flash_attention {tag}: kernel {plan['kernel']}")
            got = launched(fa.KERNEL, plan["launches"],
                           lambda: fa.flash_attention_cuda(q, k, v, group=g,
                                                           **kw))
            kx, vx = (t.repeat_interleave(g, dim=0) for t in (k, v))
            e = kernel_matches_plain(
                f"flash_attention {tag} S={S} T={T} d={d} group={g}", xdt,
                got, fa.flash_attention_plain(q, kx, vx, **kw))
            worst["flash_attention"] = max(worst["flash_attention"], e)
        routes[f"flash_attention {tag}"] = "float32 (widened), cuda cores"
    # bfloat16 alone keeps its tensor-core routes
    check(gmm.gmm_plan(4, 128, 256, 128, torch.bfloat16)["route"] == "wgmma"
          and fa.attention_plan(3, 128, 256, 128, 1, torch.bfloat16)[
              "kernel"] == "tensor cores", "bf16 left its tensor-core route")
    return {"max_abs_err": worst, "routes": routes}


def cell_inputs(kind: str, p: dict, seed: int, dev) -> dict:
    """Seeded bf16 inputs of one full-width cell, made on the card."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev,   # noqa: E731
                                 dtype=bf)
    if kind == "fused_rmsnorm":
        out = {"x": rnd(1, p["T"], p["D"]),
               "scale": torch.rand(p["D"], generator=g, device=dev) + 0.5}
        if p["residual"]:
            out["residual"] = rnd(1, p["T"], p["D"])
        return out
    if kind == "grouped_matmul":
        return {"x": rnd(p["E"], p["C"], p["D"]) * 0.1,
                "w": rnd(p["E"], p["D"], p["F"]) * 0.1}
    return {"q": rnd(p["B"], p["H"], p["S"], p["d"]),
            "k": rnd(p["B"], p["KV"], p["T"], p["d"]),
            "v": rnd(p["B"], p["KV"], p["T"], p["d"])}


def run_op(kind: str, inp: dict, p: dict, backend: str = "cuda"):
    """One call of the public op, as a user makes it."""
    from repro_torch import kernels as K

    if kind == "fused_rmsnorm":
        return K.fused_rmsnorm(inp["x"], inp["scale"], inp.get("residual"),
                               backend=backend)
    if kind == "grouped_matmul":
        return K.grouped_matmul(inp["x"], inp["w"], backend=backend)
    return K.flash_attention(inp["q"], inp["k"], inp["v"],
                             causal=p["causal"], window=p["window"],
                             backend=backend)


def kernel_call(kind: str, inp: dict, p: dict):
    """The kernel's own wrapper on the op's operands (rows flattened; kv
    heads as they come, with their ``group``), for timing; with its
    inputs."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.grouped_matmul import kernel as gmm
    from repro_torch.kernels.rmsnorm import kernel as rms

    if kind == "fused_rmsnorm":
        x = inp["x"].reshape(-1, p["D"])
        r = inp["residual"].reshape(-1, p["D"]) if p["residual"] else None
        ins = [x, inp["scale"]] + ([r] if r is not None else [])
        return (lambda: rms.fused_rmsnorm_cuda(x, inp["scale"], r)), ins
    if kind == "grouped_matmul":
        return (lambda: gmm.grouped_matmul_cuda(inp["x"], inp["w"])), \
            [inp["x"], inp["w"]]
    q = inp["q"].reshape(p["B"] * p["H"], p["S"], p["d"])
    k, v = (inp[n].reshape(p["B"] * p["KV"], p["T"], p["d"]) for n in "kv")
    return (lambda: fa.flash_attention_cuda(
        q, k, v, group=p["H"] // p["KV"], causal=p["causal"],
        window=p["window"])), [q, k, v]


def wmma_call(inp: dict):
    """The grouped matmul's WMMA kernel (the bf16 route before the wgmma
    one) on a cell's operands, launched past ``gmm_plan`` for a
    comparison within this run; its launches are not the main path's."""
    import torch

    from repro_torch.kernels.grouped_matmul import kernel as gmm

    x, w = inp["x"], inp["w"]
    (E, C, D), F = x.shape, w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    blocks = E * -(-C // 128) * -(-F // 128)

    def call():
        gmm.KERNEL.launch("gmm_launch", x.data_ptr(), w.data_ptr(),
                          out.data_ptr(), E, C, D, F,
                          gmm.GMM_ROUTES["wmma"], blocks)
        return out
    return call


def l2_cold(calls: list):
    """A call that runs ``calls`` in turn, one each time: calls over
    input sets that together exceed the L2, so none is found there.
    Each call's outputs live until its next turn, so a call that
    allocates them writes where the others' did not just write."""
    turn, outs = [0], [None] * len(calls)

    def call():
        i = turn[0] % len(calls)
        turn[0] += 1
        outs[i] = calls[i]()
        return outs[i]
    return call


def earlier_rms_call(inp: dict, p: dict):
    """Fused RMSNorm's smem route on one block a row, which is the
    kernel's design before its vector route, on a cell's operands,
    launched past ``rms_plan`` for a comparison within this run (its
    launches are not the main path's)."""
    import torch

    from repro_torch.kernels._build import DTYPE_CODE
    from repro_torch.kernels.rmsnorm import kernel as rms

    x = inp["x"].reshape(-1, p["D"])
    r = inp["residual"].reshape(-1, p["D"]) if p["residual"] else None
    scale = inp["scale"].float()
    y = torch.empty_like(x)
    res = torch.empty_like(x) if r is not None else None
    code = DTYPE_CODE[x.dtype]

    def call():
        rms.KERNEL.launch(
            "rmsnorm_launch", x.data_ptr(),
            r.data_ptr() if r is not None else None, scale.data_ptr(),
            y.data_ptr(), res.data_ptr() if res is not None else None,
            p["T"], p["D"], 1e-6, rms.RMS_ROUTES["smem"], 8, 1, p["T"],
            code, code)
        return y, (res if res is not None else x)
    return call


def window_mask(p: dict, dev):
    """The (S, T) boolean mask of _attn_kernel: queries at the end."""
    import torch

    q_pos = torch.arange(p["S"], device=dev)[:, None] + (p["T"] - p["S"])
    k_pos = torch.arange(p["T"], device=dev)[None, :]
    mask = torch.ones((p["S"], p["T"]), dtype=torch.bool, device=dev)
    if p["causal"]:
        mask &= k_pos <= q_pos
    if p["window"] > 0:
        mask &= k_pos > q_pos - p["window"]
    return mask


def _sdpa_args(p: dict, dev) -> tuple:
    """SDPA's mask arguments for a cell, and their description."""
    if p["window"] == 0 and p["S"] == p["T"]:
        return {"is_causal": True}, "is_causal"
    if p["window"] == 0 and p["S"] == 1:
        return {}, "no mask"
    return {"attn_mask": window_mask(p, dev)}, "bool mask"


def library_call(kind: str, ins: list, p: dict):
    """One PyTorch call computing the kernel's function on the kernel's
    operands (timed for the table, used nowhere in the port), and its
    description.  Attention: SDPA on k and v expanded to every query
    head outside the timed call, so the rows compare with the earlier
    kernel's, which took expanded operands."""
    import torch
    import torch.nn.functional as F

    if kind == "fused_rmsnorm":
        x, scale = ins[0], ins[1].to(ins[0].dtype)
        if p["residual"]:
            r = ins[2]
            return (lambda: F.rms_norm(x + r, (p["D"],), scale, 1e-6)), \
                "F.rms_norm(x + r)"
        # without a residual the stream is x itself: y is all there is
        return (lambda: F.rms_norm(x, (p["D"],), scale, 1e-6)), \
            "F.rms_norm (the same function: res is x)"
    if kind == "grouped_matmul":
        return (lambda: torch.bmm(ins[0], ins[1])), "torch.bmm"
    from torch.nn.attention import SDPBackend

    q = ins[0].reshape(p["B"], p["H"], p["S"], p["d"])
    k, v = (torch.repeat_interleave(
        t.reshape(p["B"], p["KV"], p["T"], p["d"]), p["H"] // p["KV"],
        dim=1) for t in ins[1:])
    kw, what = _sdpa_args(p, q.device)
    # the backend SDPA's own dispatcher picks for these arguments
    backend = SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name
    return (lambda: F.scaled_dot_product_attention(q, k, v, **kw)), \
        f"sdpa({what}) [{backend}]"


def library_gqa_call(ins: list, p: dict):
    """SDPA with ``enable_gqa=True`` on the unexpanded k and v, and its
    description, where ``torch._fused_sdp_choice`` picks a fused backend
    for it; else (None, the reason)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    q = ins[0].reshape(p["B"], p["H"], p["S"], p["d"])
    k, v = (t.reshape(p["B"], p["KV"], p["T"], p["d"]) for t in ins[1:])
    kw, what = _sdpa_args(p, q.device)
    kw["enable_gqa"] = True
    backend = SDPBackend(torch._fused_sdp_choice(q, k, v, **kw))
    name = f"sdpa({what}, enable_gqa) [{backend.name}]"
    if backend == SDPBackend.MATH:
        return None, name + ": no fused backend"
    return (lambda: F.scaled_dot_product_attention(q, k, v, **kw)), name


def attention_pairs(p: dict) -> int:
    """Query-key pairs the masks leave open, per head."""
    import numpy as np

    q_pos = np.arange(p["S"], dtype=np.int64) + (p["T"] - p["S"])
    hi = np.minimum(q_pos, p["T"] - 1) if p["causal"] \
        else np.full_like(q_pos, p["T"] - 1)
    lo = np.maximum(q_pos - p["window"] + 1, 0) if p["window"] > 0 \
        else np.zeros_like(q_pos)
    return int(np.maximum(hi - lo + 1, 0).sum())


def model_bound(kind: str, p: dict, ins: list, out) -> dict:
    """The least time the card could take: the kernel's inputs read
    once and outputs written once at the HBM rate, against its
    operations at the dense bf16 rate; the larger bounds it.  An output
    that shares storage with an input (fused RMSNorm's residual stream
    without a residual, which is x) moves no byte of its own."""
    outs = out if isinstance(out, tuple) else (out,)
    storages, nbytes = set(), 0
    for t in list(ins) + list(outs):
        key = t.untyped_storage().data_ptr()
        if key not in storages:
            storages.add(key)
            nbytes += t.numel() * t.element_size()
    if kind == "fused_rmsnorm":
        ops = p["T"] * p["D"] * (5 if p["residual"] else 4)
    elif kind == "grouped_matmul":
        ops = 2 * p["E"] * p["C"] * p["D"] * p["F"]
    else:
        ops = 4 * p["d"] * attention_pairs(p) * p["B"] * p["H"]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    # attention: k and v as the op takes them, once per kv head
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def timed_ms(lib, launch) -> tuple:
    """Device time of one ``launch()`` at full width: windows of up to
    ``MODEL_REPS`` launches back to back behind the spin kernel (as many
    as make about a second of device time and as the host queues in
    under half the spin), and as many windows as make about a second in
    all (at most 20); the median window's time per launch, the launches
    per window and the windows.  A call that waits for the device
    (it does not return while the spin holds the stream) cannot be
    queued: it is timed by events around its launches (windows 0)."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    launch()
    torch.cuda.synchronize()
    check(lib.bpf_spin_launch(stream, MODEL_SPIN_NS) == 0,
          "spin kernel launch")
    t0 = time.perf_counter()
    launch()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    waits = host_ms >= MODEL_SPIN_NS / 1e6 / 2
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    end.synchronize()
    once = max(start.elapsed_time(end), 1e-3)
    if waits:
        reps = int(max(3, min(MODEL_REPS, 1000.0 / once)))
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps, reps, 0
    queue_ms = MODEL_SPIN_NS / 1e6 / 2
    reps = int(max(3, min(MODEL_REPS, 1000.0 / once, queue_ms / host_ms)))
    windows = int(min(20, max(1, round(1000.0 / (reps * once)))))
    ms = [device_ms(lib, launch, reps=reps, warmup=1, spin_ns=MODEL_SPIN_NS)
          for _ in range(windows)]
    return pct(ms, 50), reps, windows


def plain_ms(call, n: int = 3) -> float:
    """Median host time of a synchronised run of the plain version."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        call()
        torch.cuda.synchronize()
        times.append(time.perf_counter_ns() - t0)
    return pct(times, 50) / 1e6


def model_main_path(dev, lib) -> tuple:
    """Every full-width cell through the public op (``backend="cuda"``)
    with the launch counts set to 0 just before it and read just after;
    each output held against the plain version (``backend="torch"``) on
    the same inputs; then each kernel timed beside its bound, its plain
    version and the library call.  The kernels-line rows and a log."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.grouped_matmul import kernel as gmm
    from repro_torch.kernels.rmsnorm import kernel as rms

    kernels = model_kernels()
    rows, cells = [], []
    for i, (kind, cell, p) in enumerate(MODEL_CELLS):
        inp = cell_inputs(kind, p, seed=1000 + i, dev=dev)
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        out = run_op(kind, inp, p)
        counts = {n: k.launches for n, k in kernels.items()}
        # one launch, or two for a split-KV attention call; the grouped
        # matmul on the wgmma route
        plan = {}
        if kind == "flash_attention":
            plan = fa.attention_plan(
                p["B"] * p["H"], p["S"], p["T"], p["d"], p["H"] // p["KV"],
                torch.bfloat16)
        elif kind == "grouped_matmul":
            plan = gmm.gmm_plan(p["E"], p["C"], p["D"], p["F"],
                                torch.bfloat16, inp["x"].data_ptr(),
                                inp["w"].data_ptr())
            check(plan["route"] == "wgmma", f"{kind} [{cell}]: route "
                  f"{plan['route']} ({plan['why']}), the design states "
                  "wgmma")
        else:
            plan = rms.rms_plan(
                p["T"], p["D"], torch.bfloat16,
                torch.bfloat16 if p["residual"] else None,
                [t.data_ptr() for n, t in inp.items() if n != "scale"])
            check(plan["route"] == "vector", f"{kind} [{cell}]: route "
                  f"{plan['route']} ({plan['why']}), the design states "
                  "vector")
        want = plan.get("launches", 1)
        check(counts[kind] == want and sum(counts.values()) == want,
              f"{kind} [{cell}]: launches {counts} on one op call, the "
              f"design states {want}")
        plain_out = run_op(kind, inp, p, backend="torch")
        err = kernel_matches_plain(f"{kind} [{cell}]", "bfloat16", out,
                                   plain_out)
        steps = within_bf16_steps(f"{kind} [{cell}]", out, plain_out)
        if kind == "fused_rmsnorm":
            check(torch.equal(out[1], plain_out[1]), f"{kind} [{cell}]: "
                  "the residual stream is not bit-exact with the plain "
                  "version's")
        del plain_out
        launch, ins = kernel_call(kind, inp, p)
        ms, reps, windows = timed_ms(lib, launch)
        lib_call, lib_name = library_call(kind, ins, p)
        k_out = launch()
        k_out = k_out[0] if isinstance(k_out, tuple) else k_out
        lib_err = max_err(lib_call().reshape(k_out.shape), k_out)
        check(lib_err < 0.1, f"{kind} [{cell}]: the library call "
              f"{lib_name} computes another function (err {lib_err})")
        lib_ms, _, lib_windows = timed_ms(lib, lib_call)
        # fused RMSNorm's cells fit the L2 in part (50 MB against 34-168
        # MB a call), so a call repeated on one input set reads some of
        # it from there (hot, as the other cells and earlier runs are
        # timed); it and the library call are also timed L2-cold, taking
        # turns over input sets that together exceed the L2
        cold_ms = lib_cold_ms = earlier_ms = None
        if kind == "fused_rmsnorm":
            sets = [inp] + [cell_inputs(kind, p, seed=1000 + i + 100 * j,
                                        dev=dev)
                            for j in range(1, 1 + -(-L2_BYTES // model_bound(
                                kind, p, ins, out)["bytes"]))]
            cold_ms = timed_ms(lib, l2_cold(
                [launch] + [kernel_call(kind, q, p)[0] for q in sets[1:]]))[0]
            lib_cold_ms = timed_ms(lib, l2_cold(
                [lib_call] + [library_call(kind, kernel_call(kind, q, p)[1],
                                           p)[0] for q in sets[1:]]))[0]
            del sets
            earlier = earlier_rms_call(inp, p)
            got = earlier()
            check(torch.equal(got[1], out[1].reshape(got[1].shape))
                  and torch.allclose(got[0].float(), k_out.float(),
                                     rtol=2e-2, atol=2e-2),
                  f"{kind} [{cell}]: the smem route on a block a row "
                  "disagrees with the main path's kernel")
            earlier_ms = timed_ms(lib, earlier)[0]
            del got, earlier
        gqa_ms, gqa_name, gqa_err = None, None, None
        if kind == "flash_attention" and p["H"] > p["KV"]:
            gqa_call, gqa_name = library_gqa_call(ins, p)
            if gqa_call is not None:
                gqa_err = max_err(gqa_call().reshape(k_out.shape), k_out)
                check(gqa_err < 0.1, f"{kind} [{cell}]: {gqa_name} "
                      f"computes another function (err {gqa_err})")
                gqa_ms = timed_ms(lib, gqa_call)[0]
            del gqa_call
        wmma_ms = None
        if kind == "grouped_matmul":
            wmma = wmma_call(inp)
            check(torch.allclose(wmma().float(), out.float(), rtol=2e-2,
                                 atol=2e-2), f"{kind} [{cell}]: the WMMA "
                  "kernel disagrees with the wgmma kernel")
            wmma_ms = timed_ms(lib, wmma)[0]
            del wmma
        p_ms = plain_ms(lambda: run_op(kind, inp, p, backend="torch"))
        bound = model_bound(kind, p, ins, out)
        rows.append({"name": f"{kind}[{cell}]", "route": "cuda",
                     "source": MODEL_SOURCES[kind][0],
                     "replaces": MODEL_SOURCES[kind][1],
                     "launches": counts[kind], "max_abs_err": err,
                     "ms": ms, "plain_ms": p_ms,
                     "bound_ms": bound["bound_ms"],
                     "bound_by": bound["bound_by"], "library_ms": lib_ms})
        cells.append({"kind": kind, "cell": cell, "shape": p, "reps": reps,
                      "windows": windows, **steps, "plan": plan,
                      "library": lib_name,
                      "library_waits_for_device": lib_windows == 0,
                      "library_err": lib_err, "library_gqa": gqa_name,
                      "library_gqa_ms": gqa_ms, "library_gqa_err": gqa_err,
                      "wmma_ms": wmma_ms, "ms_l2_cold": cold_ms,
                      "library_ms_l2_cold": lib_cold_ms,
                      "earlier_design_ms": earlier_ms, **bound})
        if kind == "flash_attention":
            how = (f" (tiles {plan['rows_per_block']} rows x "
                   f"{plan['keys_per_tile']} keys, d padded to "
                   f"{plan['head_dim_padded']}, {plan['splits']} kv splits)")
        elif kind == "grouped_matmul":
            how = (f" (route {plan['route']}, tiles {plan['tile'][0]} x "
                   f"{plan['tile'][1]} x {plan['tile'][2]}, "
                   f"{plan['tiles']} tiles on {plan['blocks']} blocks, "
                   f"{plan['waves']:.2f} waves)")
        else:
            how = (f" (route {plan['route']}, {plan['warps']} warps x "
                   f"{plan['nv']} units of {plan['unit']} a row, "
                   f"{plan['rows_per_block']} rows a block of "
                   f"{plan['threads']} threads, grid {plan['blocks']} blocks "
                   + ("(persistent)" if plan["persistent"]
                      else "(one a row group)") + f" for {p['T']} rows"
                   + ("" if plan["writes_res"] else "; res is x, not written")
                   + ")")
        log(f"[model] {kind} [{cell}] {p}: launches {counts[kind]}" + how
            + f", max abs err {err:.3g} against the plain version (plain "
            f"rms {steps['rms']:.4g}, limit there "
            f"{steps['limit_at_rms']:.3g}, worst err/limit "
            f"{steps['err_over_limit']:.3g}); kernel {ms:.4f} ms, bound "
            f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
            f"{100 * bound['bound_ms'] / ms:.1f}%), plain {p_ms:.3f} ms, "
            f"{lib_name} {lib_ms:.4f} ms"
            + (f", {gqa_name} " + (f"{gqa_ms:.4f} ms" if gqa_ms else
                                   "not timed") if gqa_name else "")
            + (f"; the WMMA kernel {wmma_ms:.4f} ms in this run"
               + (f" (PERF.md, before the wgmma route: "
                  f"{WMMA_RECORDED_MS[cell]} ms)"
                  if cell in WMMA_RECORDED_MS else "")
               if wmma_ms else "")
            + (f"; kernel / library {ms / lib_ms:.3f} hot; L2-cold: kernel "
               f"{cold_ms:.4f} ms ({100 * bound['bound_ms'] / cold_ms:.1f}%),"
               f" {lib_name} {lib_cold_ms:.4f} ms, kernel / library "
               f"{cold_ms / lib_cold_ms:.3f}; the smem route on a block a "
               f"row (the earlier design) {earlier_ms:.4f} ms hot"
               if cold_ms else ""))
        del inp, out, ins, launch, lib_call
        torch.cuda.empty_cache()
    return rows, cells


def zero_rows_at_width(dev) -> int:
    """Query rows that see no key (S > T under causal) are exactly 0 on
    the card at a model's width; the number of such rows checked."""
    import torch

    from repro_torch import kernels as K

    p = dict(B=1, H=16, KV=8, S=4096, T=1024, d=128)
    inp = cell_inputs("flash_attention", dict(p, causal=True, window=0),
                      seed=999, dev=dev)
    out = K.flash_attention(inp["q"], inp["k"], inp["v"], causal=True)
    torch.cuda.synchronize()
    rows = out[:, :, :p["S"] - p["T"]]
    check(bool((rows == 0).all()), "flash_attention: rows without keys "
          "are not 0 at width")
    check(bool((out[:, :, p["S"] - p["T"]:].abs().amax(dim=-1) > 0).all()),
          "flash_attention: a row with keys is 0")
    return p["B"] * p["H"] * (p["S"] - p["T"])


# the training cells' attention (portbench mixes), through B5's forward
# with the log-sum-exp and its backward
TRAIN_ATTENTION_CELLS = (
    ("qwen3-1.7b train", dict(B=4, H=16, KV=8, S=2048, d=128, dv=128)),
    ("moonlight-16b-a3b train", dict(B=2, H=16, KV=16, S=4096, d=192,
                                     dv=128)),
)


def attention_train_ops(p: dict) -> tuple:
    """(forward, backward) operations the causal mask leaves open: 2 (d +
    dv) a query-key pair forward; the backward's five products, S again,
    dP, dV, dQ and dK, 2 (3 d + 2 dv)."""
    pairs = p["B"] * p["H"] * p["S"] * (p["S"] + 1) // 2
    return (2 * (p["d"] + p["dv"]) * pairs,
            2 * (3 * p["d"] + 2 * p["dv"]) * pairs)


def attention_train_main_path(dev, lib) -> tuple:
    """At each training cell's attention shape: the models' ``_sdpa``
    forward and backward (the path training took before B5 had a
    backward) timed first; then B5's forward with the log-sum-exp and its
    backward, each held element by element to its plain version and
    timed beside its bound (the open operations at the dense bf16 rate),
    the plain versions' host time and SDPA's forward and backward (the
    library yardstick; the port never calls it).  Table rows and a log
    record a cell."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.models import attention as att

    rows, cells = [], []
    for i, (cell, p) in enumerate(TRAIN_ATTENTION_CELLS):
        B, H, KV, S, d, dv = (p[k] for k in ("B", "H", "KV", "S", "d", "dv"))
        g = torch.Generator(device=dev)
        g.manual_seed(2000 + i)
        bf = torch.bfloat16

        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=dev, dtype=bf)
        # the models' layout (B, S, heads, width)
        q, k, v, do = rnd(B, S, H, d), rnd(B, S, KV, d), rnd(B, S, KV, dv), \
            rnd(B, S, H, dv)
        pos = torch.arange(S, device=dev)[None]
        mask = att.causal_mask(S, pos, pos)
        kv_map = torch.arange(H, device=dev) // (H // KV)
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

        def sdpa_step():
            out = att._sdpa(*leaves, mask, scale=d ** -0.5, kv_map=kv_map)
            out.backward(do)
        sdpa_ms = timed_ms(lib, sdpa_step)[0]
        for t in leaves:
            t.grad = None
        torch.cuda.empty_cache()
        # B5's operands: heads flattened, kv heads unexpanded
        bq, bk, bv, bdo = (t.transpose(1, 2).reshape(-1, S, t.shape[-1])
                           .contiguous() for t in (q, k, v, do))
        G = H // KV
        fa.KERNEL.launches = 0
        o, lse = fa.flash_attention_cuda(bq, bk, bv, group=G, with_lse=True)
        grads = fa.flash_attention_bwd_cuda(bq, bk, bv, o, bdo, lse, group=G)
        torch.cuda.synchronize()
        launches = fa.KERNEL.launches
        check(launches == 3, f"attention [{cell}]: {launches} launches for "
              "a forward and a backward, the design states 1 + 2")
        kx, vx = (t.repeat_interleave(G, dim=0) for t in (bk, bv))
        want_o, want_lse = fa.flash_attention_plain(bq, kx, vx,
                                                    with_lse=True)
        steps = {"out": within_bf16_steps(f"attention [{cell}] out", o,
                                          want_o)}
        errs = {"out": max_err(o, want_o)}
        lse_err = float((lse - want_lse).abs().amax())
        check(lse_err < 1e-3, f"attention [{cell}]: lse off the plain "
              f"version's by {lse_err}")
        del want_o, kx, vx
        want = fa.flash_attention_bwd_plain(bq, bk, bv, o, bdo, lse, group=G)
        for name, a, b in zip(("dq", "dk", "dv"), grads, want):
            steps[name] = within_bf16_steps(f"attention [{cell}] {name}",
                                            a, b)
            errs[name] = max_err(a, b)
        again = fa.flash_attention_bwd_cuda(bq, bk, bv, o, bdo, lse, group=G)
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"attention [{cell}]: the backward's bits differ between two "
              "runs on the same inputs")
        del want, again
        fwd_ms = timed_ms(lib, lambda: fa.flash_attention_cuda(
            bq, bk, bv, group=G, with_lse=True))[0]
        bwd_ms = timed_ms(lib, lambda: fa.flash_attention_bwd_cuda(
            bq, bk, bv, o, bdo, lse, group=G))[0]

        def plain_step():
            kx, vx = (t.repeat_interleave(G, dim=0) for t in (bk, bv))
            po, plse = fa.flash_attention_plain(bq, kx, vx, with_lse=True)
            fa.flash_attention_bwd_plain(bq, bk, bv, po, bdo, plse, group=G)
        p_ms = plain_ms(plain_step)
        # SDPA on (B, H, S, d), kv heads unexpanded (enable_gqa)
        lq, lk, lv = (t.transpose(1, 2).detach().clone().requires_grad_()
                      for t in (q, k, v))
        ldo = do.transpose(1, 2)

        def lib_step():
            out = F.scaled_dot_product_attention(
                lq, lk, lv, is_causal=True, enable_gqa=G > 1)
            out.backward(ldo)
        lib_ms = timed_ms(lib, lib_step)[0]
        f_ops, b_ops = attention_train_ops(p)
        fwd_bound = f_ops / BF16_OPS_PER_S * 1e3
        bwd_bound = b_ops / BF16_OPS_PER_S * 1e3
        for what, ms, bound in (("forward with lse", fwd_ms, fwd_bound),
                                ("backward", bwd_ms, bwd_bound)):
            rows.append({"name": f"flash_attention {what}[{cell}]",
                         "route": "cuda",
                         "source": MODEL_SOURCES["flash_attention"][0],
                         "replaces": MODEL_SOURCES["flash_attention"][1]
                         if what != "backward" else "none",
                         "launches": 1 if what != "backward" else 2,
                         "max_abs_err": errs["out"] if what != "backward"
                         else max(errs[n] for n in ("dq", "dk", "dv")),
                         "ms": ms, "plain_ms": p_ms, "bound_ms": bound,
                         "bound_by": "operations", "library_ms": lib_ms})
        cells.append({"cell": cell, "shape": p, "sdpa_fwd_bwd_ms": sdpa_ms,
                      "fwd_lse_ms": fwd_ms, "bwd_ms": bwd_ms,
                      "fwd_bound_ms": fwd_bound, "bwd_bound_ms": bwd_bound,
                      "plain_fwd_bwd_ms": p_ms, "sdpa_library_ms": lib_ms,
                      "lse_max_abs_err": lse_err, "steps": steps,
                      "max_abs_err": errs,
                      "launches": launches})
        log(f"[train attention] {cell} {p}: _sdpa forward + backward "
            f"{sdpa_ms:.4f} ms (before); B5 forward with lse {fwd_ms:.4f} ms "
            f"(bound {fwd_bound:.4f}, {100 * fwd_bound / fwd_ms:.1f}%), "
            f"backward {bwd_ms:.4f} ms (bound {bwd_bound:.4f}, "
            f"{100 * bwd_bound / bwd_ms:.1f}%), 3 launches; plain forward + "
            f"backward {p_ms:.3f} ms; sdpa(is_causal, enable_gqa) forward + "
            f"backward {lib_ms:.4f} ms (yardstick); worst err/limit "
            + ", ".join(f"{n} {v['err_over_limit']:.3g}"
                        for n, v in steps.items())
            + f"; lse max abs err {lse_err:.3g}; the backward's bits repeat")
        del q, k, v, do, bq, bk, bv, bdo, o, lse, grads, leaves, lq, lk, lv
        torch.cuda.empty_cache()
    return rows, cells


# ---------------------------------------------------------------------------
# phase 11: the host tiers and the observability plane
# ---------------------------------------------------------------------------

# the Table 1 policies, as benchmarks/table1_overhead.py runs them
TABLE1 = ("noop", "static_override", "size_aware", "adaptive_channels",
          "latency_feedback", "bandwidth_probe", "slo_enforcer")
INVOKE_CHUNK = 1_000    # runtime.invoke calls per timed chunk
INVOKE_CHUNKS = 40      # chunks per (policy, tier): p50/p99 over them
N_RECORDED = 2_000      # decisions the flight recorder watches


def host_cpu() -> str:
    """The host CPU's model name, vendor, family and model numbers and
    CPU count as ``lscpu`` gives them, with ``/proc/cpuinfo``'s model
    name beside them (a sandboxed host may report the name as
    "unknown"; the family and model numbers still name the part)."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=60).stdout
    fields = dict(line.split(":", 1) for line in out.splitlines()
                  if ":" in line)
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    check("Model name" in fields, "lscpu gave no model name")
    with open("/proc/cpuinfo") as f:
        proc = sorted({line.split(":", 1)[1].strip() for line in f
                       if line.startswith("model name")})
    return (f"lscpu: {fields['Model name']} ({fields.get('Vendor ID', '?')}"
            f" family {fields.get('CPU family', '?')} model "
            f"{fields.get('Model', '?')}, {fields.get('CPU(s)', '?')} CPUs); "
            f"/proc/cpuinfo: {', '.join(proc) or 'no model name'}")


def host_tier_identity(prog, seed: int) -> dict:
    """``prog`` on ``jit``, ``native`` and ``auto`` against ``interp``,
    each runtime on its own maps seeded as phase 3 seeds them, over phase
    3's ctx samples: ret, ctx bytes and every map byte after every
    sample.  Native must be machine code wherever ``have_cc()`` holds."""
    import numpy as np

    import torch_samples as samples
    from repro_torch.core import PolicyRuntime
    from repro_torch.core.cc import get_meta, have_cc

    legs = {}
    for tier in ("interp", "jit", "native", "auto"):
        rt = PolicyRuntime(tier=tier)
        fn = rt.load(prog).fn
        rng = np.random.default_rng(seed)       # as samples.make_maps
        for d in prog.maps:
            samples.fill_map(rt.maps.get(d.name), rng)
        legs[tier] = (fn, rt)
    codegen = {t: get_meta(fn).get("codegen") or fn.__bpf_codegen__
               for t, (fn, _) in legs.items() if t != "interp"}
    check(codegen["jit"] == "v2", f"{prog.name}: jit ran {codegen['jit']}")
    if have_cc():
        for t in ("native", "auto"):
            check(codegen[t] == "native",
                  f"{prog.name}: {t} ran {codegen[t]}, not machine code")
    rng = np.random.default_rng(seed + 1)
    for i in range(N_SAMPLES):
        buf = samples.make_ctx(prog, rng)
        got = {}
        for tier, (fn, rt) in legs.items():
            b = bytearray(buf)
            ret = fn(b)
            got[tier] = (ret, bytes(b), {
                d.name: rt.maps.get(d.name).to_device().tobytes()
                for d in prog.maps})
        for tier, g in got.items():
            check(g == got["interp"], f"{prog.name}: {tier} differs from "
                  f"interp at sample {i}")
    return codegen


def invoke_ns(fn, reps: int = INVOKE_CHUNKS, chunk: int = INVOKE_CHUNK):
    """p50 and p99 over ``reps`` chunks of ``chunk`` calls of ``fn()``,
    ns per call on the host clock."""
    for _ in range(chunk):
        fn()
    per = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        for _ in range(chunk):
            fn()
        per.append((time.perf_counter_ns() - t0) / chunk)
    return pct(per, 50), pct(per, 99)


def table1_latency(tiers) -> dict:
    """Per-decision host time of each Table 1 policy on each of
    ``tiers``: ``runtime.invoke`` (chain, stats, guards) p50/p99 and the
    loaded program alone p50, maps seeded as the reference's benchmark
    seeds them."""
    from repro_torch.core import PolicyRuntime, make_ctx
    from repro_torch.policies import table1 as T

    out = {}
    for name in TABLE1:
        for tier in tiers:
            rt = PolicyRuntime(tier=tier)
            fn = rt.load(getattr(T, name).program).fn
            for m in map(rt.maps.get, rt.maps.names()):
                m.update_u64(0, 1_000, slot=0)
                if m.value_size >= 16:
                    m.update_u64(0, 8, slot=1)
            ctx = make_ctx("tuner", msg_size=8 << 20, comm_id=0, n_ranks=8,
                           max_channels=32)
            p50, p99 = invoke_ns(lambda: rt.invoke("tuner", ctx))
            fn_p50, _ = invoke_ns(lambda: fn(ctx.buf))
            out[f"{name} {tier}"] = {"invoke_p50_ns": p50,
                                     "invoke_p99_ns": p99,
                                     "fn_p50_ns": fn_p50}
    return out


def recorder_run(run: dict, n: int = N_RECORDED) -> dict:
    """A :class:`FlightRecorder` on a closed-loop run's runtime, with the
    profiler suite (latency histogram, straggler trap) attached beside
    its profilers; ``n`` more decisions of the main path's traffic, each
    followed by its profiler feed, exported as JSON lines every 500.
    The export must pass the exporter's validator and the histogram must
    count every decision."""
    import io

    from repro_torch.obs import Exporter, FlightRecorder
    from repro_torch.obs.exporter import validate_export
    from repro_torch.policies import profiler as prof

    rt, disp = run["rt"], run["disp"]
    for i, p in enumerate(prof.PROFILER_POLICIES):
        rt.attach(p.program, priority=10 + i)
    rec = FlightRecorder(rt, capacity=256)
    buf = io.StringIO()
    ex = Exporter(rec, stream=buf)
    for i, (coll, size, axis, lat) in enumerate(traffic(n, seed=11)):
        d = disp.decide(coll, size, 8, axis_name=axis)
        feed(disp, d, lat)
        if (i + 1) % 500 == 0:
            ex.snapshot()
    ex.snapshot()
    lines = buf.getvalue().splitlines()
    bad = validate_export(lines)
    check(not bad, f"the exporter's lines fail its validator: {bad[:3]}")
    recs = [json.loads(line) for line in lines]
    hist = [r for r in recs if r["kind"] == "histogram"]
    check(hist and hist[-1]["total"] == n and sum(rec.histogram()) == n,
          f"the recorder counted {hist[-1]['total'] if hist else None} "
          f"decisions of {n}")
    stragglers = [r for r in recs if r["kind"] == "straggler"]
    check(len(stragglers) == rec.events_seen > 0,
          f"{len(stragglers)} straggler lines for {rec.events_seen} events")
    return {"lines": len(lines), "histogram": rec.histogram(),
            "stragglers": stragglers, "counters": rec.counters()}


# ---------------------------------------------------------------------------
# phase 12: the model zoo and the serving engine
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen3-1.7b"   # full width and depth: 28 layers, D 2048,
                            # H 16 / KV 8, hd 128, F 6144, V 151,936, bf16
SERVE_SLOTS = 8
SERVE_CTX = 512
SERVE_REQUESTS = 16
SERVE_NEW = 32
SERVE_PROMPTS = (16, 64)    # prompt lengths, drawn from this range
PREFILL_TOKENS = 2048       # prefill timed at B 1 x S 2048
CHECK_TOKENS = 64           # the decode-against-forward prompt
CHECK_SEED = 23
# Decode against forward, both in bf16: the two paths round every matmul,
# norm and residual add to bf16, in other summation orders (one token
# against 64 at once), so each carries bf16's own error against f32.
# Per element |decode - forward| <= 2^-2 rms(forward), and over all
# elements rms(decode - forward) <= 2^-5 rms(forward).  On the CPU at 28
# layers, a decode that hides its newest key misses both by 25x or more,
# one that scales each attention output by 0.98 misses the second.
DECODE_LIMIT = 2.0 ** -2
DECODE_RMS_LIMIT = 2.0 ** -5
N_WARM_DECIDE = 100         # repeat decisions that must upload nothing


def serve_axes():
    from repro_torch.models.layers import MeshAxes
    return MeshAxes(tp=1, dp=1, fsdp=False)


def serving_prompts(vocab: int, n: int, lo: int, hi: int, seed: int) -> list:
    """``n`` seeded prompts of ``lo``-``hi`` tokens; the second repeats the
    first, so the two run in two slots from the same tick."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).tolist()
               for _ in range(n)]
    prompts[1] = list(prompts[0])
    return prompts


def serve_with_loop(cfg, params, dev, tier: str, *, slots: int, ctx: int,
                    n_requests: int, max_new: int, prompt_lens: tuple,
                    seed: int = 17) -> dict:
    """The slice's main path: a ``ServeEngine`` serving ``n_requests``
    while the §5.3 loop runs on ``tier``, attached as
    ``examples/serve_adaptive_torch.py`` attaches it (each tick's latency
    fed to ``adapt_profiler``, then one ``adapt_tuner`` decision).  Every
    policy kernel's launch count is set to 0 just before and read just
    after; then ``N_WARM_DECIDE`` repeat decisions count map uploads."""
    import serve_adaptive_torch as ex

    from repro_torch.serve import ServeConfig, ServeEngine

    rt, disp = ex.attach_loop(tier)
    bridges = [l.fn for s in rt.sections() for l in rt.chain(s)
               if hasattr(l.fn, "kernel")]
    eng = ServeEngine(cfg, params, serve_axes(),
                      ServeConfig(batch_slots=slots, max_ctx=ctx),
                      device=dev)
    prompts = serving_prompts(cfg.vocab, n_requests, *prompt_lens, seed)
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    for b in bridges:
        b.kernel.launches = 0
    t0 = time.perf_counter()
    lat = ex.serve(eng, disp)
    d = ex.decide(disp)
    wall = time.perf_counter() - t0
    launches = {b.kernel.name: b.kernel.launches for b in bridges}
    stats = {b.kernel.name: {"calls": b.stats.calls,
                             "host_fallbacks": b.stats.host_fallbacks}
             for b in bridges}
    rt.flush_bridges()
    amap = rt.maps.get("adapt_map").to_device().tobytes()
    samples = ex.samples(rt)
    live = [l.fn for l in rt.chain("tuner")]
    before = sum(b.stats.map_uploads for b in live)
    for _ in range(N_WARM_DECIDE):
        ex.decide(disp)
    warm = sum(b.stats.map_uploads for b in live) - before
    return {"engine": eng, "disp": disp, "reqs": reqs, "prompts": prompts,
            "lat_ns": lat,
            "wall_s": wall, "decision": d, "adapt_map": amap,
            "samples": samples, "launches": launches, "stats": stats,
            "warm_uploads": warm, "bridges": bridges}


def replay_loop(lat_ns: list) -> dict:
    """The same latency stream fed to a fresh loop on ``interp``, then the
    same decision: its ``adapt_map`` bytes and ``Decision``."""
    import serve_adaptive_torch as ex

    rt, disp = ex.attach_loop("interp")
    for t in lat_ns:
        ex.feed(disp, t)
    d = ex.decide(disp)
    rt.flush_bridges()
    return {"decision": d,
            "adapt_map": rt.maps.get("adapt_map").to_device().tobytes()}


def check_serving(run: dict, replay: dict, vocab: int, max_new: int) -> dict:
    """Fail unless every request finished with ``max_new`` in-vocabulary
    tokens in fewer ticks than serial, the repeated prompt gave the same
    tokens in both slots, and the loop equals its replay (map bytes and
    decision); the loop's counts."""
    reqs = run["reqs"]
    ticks = len(run["lat_ns"])
    serial = sum(len(p) + max_new for p in run["prompts"])
    check(all(r.done and len(r.out) == max_new for r in reqs),
          f"requests unfinished: {[(r.rid, len(r.out)) for r in reqs]}")
    check(all(0 <= t < vocab for r in reqs for t in r.out),
          "a token outside the vocabulary")
    check(ticks == run["engine"].steps and ticks < serial,
          f"{ticks} ticks, serial {serial}")
    check(reqs[0].out == reqs[1].out,
          f"one prompt in two slots gave {reqs[0].out} and {reqs[1].out}")
    check(run["adapt_map"] == replay["adapt_map"],
          "adapt_map differs from the replay's")
    check(run["decision"] == replay["decision"],
          f"decision {run['decision']} against the replay's "
          f"{replay['decision']}")
    check(run["samples"] == ticks,
          f"{run['samples']} profiler samples for {ticks} ticks")
    return {"ticks": ticks, "serial": serial,
            "tokens": sum(len(r.out) for r in reqs),
            "prompt_tokens": sum(len(p) for p in run["prompts"])}


def decode_against_forward(cfg, params, dev, n_tokens: int = CHECK_TOKENS,
                           ctx: int = SERVE_CTX) -> dict:
    """One ``n_tokens`` prompt through the decode path (one token per
    step from empty caches) and through ``forward_logits``: fail unless
    the logits meet ``DECODE_LIMIT`` per element and ``DECODE_RMS_LIMIT``
    over all, and the greedy tokens agree wherever the forward pass's
    top-2 margin exceeds the per-element limit."""
    import torch

    from repro_torch.models import forward_logits
    from repro_torch.models.transformer import _decode_logits, init_caches

    ax = serve_axes()
    g = torch.Generator().manual_seed(CHECK_SEED)
    tok = torch.randint(0, cfg.vocab, (1, n_tokens), generator=g).to(dev)
    with torch.no_grad():
        fwd = forward_logits(params, {"tokens": tok}, cfg, ax)[0][0].float()
        caches = init_caches(params, cfg, 1, ctx, ax)
        dec = []
        for i in range(n_tokens):
            pos = torch.full((1,), i, dtype=torch.int32, device=dev)
            lg, caches = _decode_logits(params, tok[:, i:i + 1], caches, pos,
                                        cfg, ax)
            dec.append(lg[0, 0].float())
        dec = torch.stack(dec)
    check(bool(torch.isfinite(dec).all() and torch.isfinite(fwd).all()),
          "non-finite logits")
    rms = float(fwd.square().mean().sqrt())
    diff = dec - fwd
    err, err_rms = float(diff.abs().amax()), float(diff.square().mean().sqrt())
    limit = DECODE_LIMIT * rms
    top2 = torch.topk(fwd, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > limit
    same = dec.argmax(-1) == fwd.argmax(-1)
    out = {"rms": rms, "max_err": err, "rms_err": err_rms, "limit": limit,
           "err_over_limit": err / limit,
           "rms_err_over_limit": err_rms / (DECODE_RMS_LIMIT * rms),
           "positions": n_tokens, "sure_positions": int(sure.sum()),
           "tokens_equal": int(same.sum())}
    check(err <= limit, f"decode off forward by {err:.4g} > {limit:.4g} "
          f"(2^-2 rms {rms:.4g})")
    check(err_rms <= DECODE_RMS_LIMIT * rms,
          f"decode off forward by rms {err_rms:.4g} > 2^-5 rms {rms:.4g}")
    check(bool(same[sure].all()), f"greedy tokens differ where the margin "
          f"exceeds the limit: {out}")
    return out


def bf16_floor(cfg, params32, params, dev,
               n_tokens: int = CHECK_TOKENS) -> dict:
    """bf16 ``forward_logits`` (on ``params``, the serving copy) against
    the f32 forward on the f32 master weights (TF32 off): the size of
    bf16's own error, beside which the decode limit is set."""
    import torch

    from repro_torch.models import forward_logits

    ax = serve_axes()
    g = torch.Generator().manual_seed(CHECK_SEED)
    tok = torch.randint(0, cfg.vocab, (1, n_tokens), generator=g).to(dev)
    with torch.no_grad():
        f32 = forward_logits(params32, {"tokens": tok},
                             cfg.with_overrides(dtype="float32"), ax)[0][0]
        bf = forward_logits(params, {"tokens": tok}, cfg, ax)[0][0].float()
    rms = float(f32.square().mean().sqrt())
    return {"max_over_rms": float((bf - f32).abs().amax()) / rms,
            "rms_over_rms": float((bf - f32).square().mean().sqrt()) / rms}


def serving_trace(eng, disp, n_ticks: int = 10, seed: int = 31) -> dict:
    """A ``torch.profiler`` trace of ``n_ticks`` engine ticks (with their
    profiler feeds) on a refilled engine: the device's busy share, the
    device events per tick and the six largest kernels by device time."""
    import serve_adaptive_torch as ex

    for p in serving_prompts(eng.cfg.vocab, eng.scfg.batch_slots, 16, 16,
                             seed):
        eng.submit(p, max_new=n_ticks)

    def run():
        for _ in range(n_ticks):
            t0 = time.perf_counter_ns()
            eng.step()
            ex.feed(disp, time.perf_counter_ns() - t0)
    trace = device_trace(run, n_ticks)
    eng.run_until_drained()
    top = sorted(trace["by_name"].items(), key=lambda kv: -kv[1]["us"])[:6]
    return {"ticks": n_ticks, "busy_share": trace["busy_share"],
            "wall_us_per_tick": trace["wall_us"] / n_ticks,
            "busy_us_per_tick": trace["busy_us"] / n_ticks,
            "events_per_tick": sum(v["count"] for v in
                                   trace["by_name"].values()) / n_ticks,
            "top": {k: v["us"] / n_ticks for k, v in top}}


def prefill_ms(cfg, params, dev, n_tokens: int = PREFILL_TOKENS) -> float:
    """Device time of one ``prefill`` at B 1 x S ``n_tokens`` (CUDA
    events around 5 calls after a warm-up)."""
    import torch

    from repro_torch.models import prefill

    g = torch.Generator().manual_seed(29)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, n_tokens),
                                     generator=g).to(dev)}
    with torch.no_grad():
        out = prefill(params, batch, cfg, serve_axes())
        check(tuple(out.shape) == (1, 1, cfg.vocab)
              and bool(torch.isfinite(out.float()).all()),
              f"prefill gave {tuple(out.shape)}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            prefill(params, batch, cfg, serve_axes())
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 5


def serving_main_path(dev, lib, empty_ms: float, smi: str) -> tuple:
    """Phase 12 on the card: full-width ``SERVE_ARCH`` served with the
    §5.3 loop on ``tier="cuda"`` (launch counts set to 0 just before the
    serving run and read just after), held to its interp replay; decode
    against forward; prefill time and peak memory; each policy kernel of
    the path timed beside its bound and plain version.  The kernels-line
    rows and the phase's record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import tree_map

    t0 = time.time()
    # bf16 GEMMs accumulate in f32 and round once, as the reference's
    # einsums do (no reduced-precision reductions inside cuBLAS), and the
    # f32 forward stays f32 (no TF32)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    serve_cfg = get_config(SERVE_ARCH)
    params32, _ = init_params(12, serve_cfg, serve_axes(), device=dev)
    n_params = []
    tree_map(lambda a: n_params.append(a.numel()), params32)
    model_k = list(model_kernels().values())
    for k in model_k:
        k.launches = 0
    serving = serve_with_loop(serve_cfg, params32, dev, "cuda",
                              slots=SERVE_SLOTS, ctx=SERVE_CTX,
                              n_requests=SERVE_REQUESTS, max_new=SERVE_NEW,
                              prompt_lens=SERVE_PROMPTS)
    model_launches = sum(k.launches for k in model_k)
    check(model_launches == 0, f"{model_launches} model-kernel launches on "
          "the serving path (the models call none, ROADMAP C6)")
    replay = replay_loop(serving["lat_ns"])
    counts = check_serving(serving, replay, serve_cfg.vocab, SERVE_NEW)
    ticks = counts["ticks"]
    check(serving["launches"] == {"adapt_tuner": 1, "adapt_profiler": ticks},
          f"policy kernel launches {serving['launches']} for {ticks} feeds "
          "and 1 decision")
    for n, st in serving["stats"].items():
        check(st["calls"] == serving["launches"][n]
              and st["host_fallbacks"] == 0,
              f"{n}: bridge stats {st}, launches {serving['launches'][n]}")
    check(serving["warm_uploads"] == 0,
          f"{serving['warm_uploads']} uploads on warm repeat decisions")
    serve_params = serving["engine"].params
    dvf = decode_against_forward(serve_cfg, serve_params, dev)
    floor = bf16_floor(serve_cfg, params32, serve_params, dev)
    pf_ms = prefill_ms(serve_cfg, serve_params, dev)
    peak = torch.cuda.max_memory_allocated()
    trace = serving_trace(serving["engine"], serving["disp"])
    tick = {"p50_ms": pct(serving["lat_ns"], 50) / 1e6,
            "p99_ms": pct(serving["lat_ns"], 99) / 1e6}
    tok_s = counts["tokens"] / serving["wall_s"]
    rows = []
    for b in serving["bridges"]:
        n = b.kernel.name
        t = kernel_timing(lib, b.kernel, b._io[:b.kernel.n_fields].clone(),
                          {m: v.clone() for m, v in b._dev.items()})
        check(t["max_abs_err"] == 0, f"{n}: kernel disagrees on the "
              f"serving-path state (max abs err {t['max_abs_err']})")
        rows.append({"name": f"policy_kernel[{n}]@serving", "route": "cuda",
                     "source": KERNEL_SOURCE, "replaces": REPLACES,
                     "launches": serving["launches"][n],
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": empty_ms,
                     "bound_by": "launch", "library_ms": None})
    serve_s = time.time() - t0
    d = serving["decision"]
    log(f"[serve] {SERVE_ARCH} at full width ({serve_cfg.n_layers} layers, "
        f"D {serve_cfg.d_model}, {sum(n_params) / 1e9:.3f} B params, "
        f"bf16), ServeEngine {SERVE_SLOTS} slots x {SERVE_CTX} ctx: "
        f"{SERVE_REQUESTS} requests of {counts['prompt_tokens']} prompt "
        f"tokens, {counts['tokens']} generated in {ticks} ticks (serial "
        f"{counts['serial']}); the repeated prompt gave the same tokens in "
        f"two slots; tick p50 {tick['p50_ms']:.3f} ms p99 "
        f"{tick['p99_ms']:.3f} ms; {tok_s:.1f} generated tokens/s; prefill "
        f"B 1 x S {PREFILL_TOKENS} {pf_ms:.3f} ms; peak memory "
        f"{peak / 2**30:.2f} GiB; model-kernel launches 0; {smi}")
    log(f"[serve loop] tier cuda: B1 launches adapt_profiler "
        f"{serving['launches']['adapt_profiler']} (one per tick's feed), "
        f"adapt_tuner {serving['launches']['adapt_tuner']} (one decision: "
        f"algo {d.algo} proto {d.proto} channels {d.channels} from "
        f"{serving['samples']} samples); host fallbacks 0; warm uploads 0 "
        f"over {N_WARM_DECIDE} repeat decisions; adapt_map bytes and the "
        f"Decision identical to the interp replay")
    log(f"[serve decode] {CHECK_TOKENS}-token prompt, decode against "
        f"forward_logits: max |diff| {dvf['max_err']:.4g} "
        f"({dvf['err_over_limit']:.3f} of 2^-2 rms, rms {dvf['rms']:.4g}), "
        f"rms diff {dvf['rms_err']:.4g} ({dvf['rms_err_over_limit']:.3f} "
        f"of 2^-5 rms); greedy tokens equal at {dvf['tokens_equal']}/"
        f"{dvf['positions']} positions, all {dvf['sure_positions']} with a "
        f"top-2 margin over the limit; bf16 forward against the f32 "
        f"forward: max {floor['max_over_rms']:.4f} rms, rms "
        f"{floor['rms_over_rms']:.4f} rms ({serve_s:.1f} s for the phase)")
    log(f"[serve trace] {trace['ticks']} ticks of 8 busy slots under "
        f"torch.profiler: {trace['wall_us_per_tick']:.0f} us per tick, the "
        f"device busy {trace['busy_us_per_tick']:.0f} us of it "
        f"({100 * trace['busy_share']:.2f}%), "
        f"{trace['events_per_tick']:.0f} device events per tick; largest "
        f"us per tick: " + "; ".join(f"{k[:60]} {v:.1f}"
                                     for k, v in trace["top"].items()))
    record = {"arch": SERVE_ARCH, "params": sum(n_params), "counts": counts,
              "tick_ms": tick, "tokens_per_s": tok_s, "prefill_ms": pf_ms,
              "prefill_tokens": PREFILL_TOKENS, "peak_bytes": peak,
              "launches": serving["launches"],
              "decision": dataclasses.asdict(d),
              "decode_against_forward": dvf, "bf16_floor": floor,
              "trace": trace, "seconds": serve_s}
    return rows, record


# ---------------------------------------------------------------------------
# phase 13: the training path
# ---------------------------------------------------------------------------

TRAIN_ARCH = "tinyllama-1.1b"   # full width and depth: 22 layers, D 2048,
                                # H 32 / KV 4, hd 64, F 5632, V 32,000
TRAIN_SEQ = 2048
TRAIN_BATCH = 8                 # 16,384 tokens per step
TRAIN_STEPS = 12
TRAIN_WARMUP = 3
TRAIN_LR = 3e-4
RESUME_AT = 6                   # save here; the tuner's link is replaced
# step 1's loss against ln V + sigma^2 / 2 (logits of spread sigma that
# carry no information about the label)
LOSS_WINDOW = 0.15
# the first step in bf16 against the same params' f32 evaluation on the
# same batch: bf16 rounds every activation to 8 significant bits, which
# moves a mean over 16,384 tokens far less than one token's loss (the
# CPU at 4 layers, D 512, V 32,000: 4.3e-5 relative for both)
BF16_LOSS_RTOL = 1e-3
BF16_GNORM_RTOL = 2e-2
PEAK_BF16_FLOPS = 989e12        # NVIDIA H100 SXM data sheet (700 W)
# the resume checkpoint (13 GB: f32 params, m and v) in the checkout's
# ignored build directory, removed when the phase ends
TRAIN_CKPT = os.path.join(ROOT, "build", "train_ckpt")
# the dp = 2 leg gathers on the bf16 wire: params and moments within 2e-2
# of the 1-rank run, per leaf in norm (tests/test_torch_train_mesh.py)
DP2_TOL = 2e-2


def train_configs():
    """(model config with remat, trainer config) of the phase's run."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.train import AdamWConfig, TrainerConfig, TrainStepConfig

    cfg = get_config(TRAIN_ARCH).with_overrides(remat=True)
    tcfg = TrainerConfig(
        steps=TRAIN_STEPS, log_every=10 ** 9, seed=13,
        ckpt_dir=TRAIN_CKPT,
        data=DataConfig(seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH),
        step=TrainStepConfig(opt=AdamWConfig(lr=TRAIN_LR),
                             total_steps=TRAIN_STEPS,
                             warmup_steps=TRAIN_WARMUP))
    return cfg, tcfg


class FeedLog:
    """Records every ``profiler_feed`` the trainer makes on ``disp``, for
    the replay."""

    def __init__(self, disp):
        self.calls: list = []
        feed_fn = disp.profiler_feed

        def recorded(comm_id, latency_ns, **kw):
            self.calls.append((comm_id, latency_ns, kw))
            feed_fn(comm_id, latency_ns, **kw)
        disp.profiler_feed = recorded


def first_step_eval(tr, batch) -> dict:
    """Step 1's inputs evaluated apart from the trainer: the bf16 loss and
    ``grad_norm`` of the initial params (the step's own config), the same
    params' f32 evaluation, and the spread of the bf16 logits."""
    import torch

    from repro_torch.models import forward_logits
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.step import local_batch, loss_and_grads

    b = local_batch(batch, tr.cfg, tr.ax, tr.device)
    out = {}
    for name, cfg in (("bf16", tr.cfg),
                      ("f32", tr.cfg.with_overrides(dtype="float32"))):
        loss, g = loss_and_grads(tr.params, b, cfg, tr.ax, tr.param_specs)
        out[name] = {"loss": float(loss), "grad_norm": float(global_norm(g))}
        del g
    with torch.no_grad():
        lg = forward_logits(tr.params, {"tokens": b["tokens"][:1]}, tr.cfg,
                            tr.ax)[0].float()
        l32 = forward_logits(tr.params, {"tokens": b["tokens"][:1]},
                             tr.cfg.with_overrides(dtype="float32"),
                             tr.ax)[0]
        rms = float(l32.square().mean().sqrt())
        out["sigma"] = float(lg.std())
        out["logits_rms_over_rms"] = float(
            (lg - l32).square().mean().sqrt()) / rms
    torch.cuda.empty_cache()
    return out


def host_state(tr) -> list:
    """The trainer's params, m and v, copied to the host, in tree order."""
    from repro_torch.models.transformer import tree_leaves
    return [t.detach().cpu() for t in tree_leaves(
        {"p": tr.params, "m": tr.opt_state["m"], "v": tr.opt_state["v"]})]


def train_with_loop(dev, tier: str) -> dict:
    """The slice's main path: full-width ``TRAIN_ARCH`` trained by
    ``Trainer`` for ``TRAIN_STEPS`` while the §5.3 loop runs on ``tier``
    (attached as ``examples/serve_adaptive_torch.py`` attaches it: each
    step's latency fed to ``adapt_profiler``); a checkpoint at
    ``RESUME_AT``, then the tuner's link replaced warm; one
    ``adapt_tuner`` decision after the run.  Every policy kernel's launch
    count is set to 0 just before the run and read just after."""
    import torch

    import serve_adaptive_torch as ex

    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models.transformer import tree_map
    from repro_torch.policies import adapt_tuner
    from repro_torch.train import Trainer

    cfg, tcfg = train_configs()
    rt, disp = ex.attach_loop(tier)
    feeds = FeedLog(disp)
    bridges = [l.fn for s in rt.sections() for l in rt.chain(s)
               if hasattr(l.fn, "kernel")]
    tr = Trainer(cfg, serve_axes(), None, tcfg, device=dev)
    n_params = []
    tree_map(lambda a: n_params.append(a.numel()), tr.params)
    first = first_step_eval(tr, SyntheticLMDataset(cfg, tcfg.data).batch(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for b in bridges:
        b.kernel.launches = 0
    t0 = time.perf_counter()
    tr.run(steps=RESUME_AT)
    t_save = time.perf_counter()
    tr.save()
    save_s = time.perf_counter() - t_save
    link = rt.chain("tuner")[0]
    link.replace(adapt_tuner.program)
    bridges.append(link.fn)             # the new link's bridge, counted
    link.fn.kernel.launches = 0         # from 0 as the others were
    tr.run(steps=TRAIN_STEPS - RESUME_AT)
    d = ex.decide(disp)
    wall = time.perf_counter() - t0 - save_s
    launches, stats = {}, {}
    for k in {id(b.kernel): b.kernel for b in bridges}.values():
        launches[k.name] = launches.get(k.name, 0) + k.launches
    for b in bridges:
        st = stats.setdefault(b.kernel.name,
                              {"calls": 0, "host_fallbacks": 0})
        st["calls"] += b.stats.calls
        st["host_fallbacks"] += b.stats.host_fallbacks
    peak = torch.cuda.max_memory_allocated()
    rt.flush_bridges()
    amap = rt.maps.get("adapt_map").to_device().tobytes()
    samples = rt.maps.get("adapt_map").lookup_u64(0, 2)
    live = {l.fn.kernel.name: l.fn for s in rt.sections()
            for l in rt.chain(s)}
    return {"trainer": tr, "cfg": cfg, "tcfg": tcfg, "rt": rt, "disp": disp,
            "feeds": list(feeds.calls), "decision": d, "adapt_map": amap,
            "samples": samples, "launches": launches, "stats": stats,
            "peak": peak, "wall_s": wall, "save_s": save_s,
            "first": first, "n_params": sum(n_params), "live": live}


def replay_training_loop(feeds: list) -> dict:
    """The trainer's feeds, replayed on a fresh ``interp`` loop with the
    tuner's link replaced at the same point, then the same decision."""
    import serve_adaptive_torch as ex

    from repro_torch.policies import adapt_tuner

    rt, disp = ex.attach_loop("interp")
    for i, (comm_id, lat, kw) in enumerate(feeds):
        if i == RESUME_AT:
            rt.chain("tuner")[0].replace(adapt_tuner.program)
        disp.profiler_feed(comm_id, lat, **kw)
    d = ex.decide(disp)
    rt.flush_bridges()
    return {"decision": d,
            "adapt_map": rt.maps.get("adapt_map").to_device().tobytes()}


def resume_check(run: dict, dev) -> dict:
    """A fresh ``Trainer`` restored from the ``RESUME_AT`` checkpoint runs
    the remaining steps: its params and moments against the unbroken
    run's, bit for bit."""
    import torch

    from repro_torch.train import Trainer

    tr = run["trainer"]
    want = host_state(tr)
    losses = [m["loss"] for m in tr.metrics_log]
    run["trainer"] = None
    del tr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr2 = Trainer(run["cfg"], serve_axes(), None, run["tcfg"], device=dev)
    check(tr2.maybe_restore() and tr2.step_idx == RESUME_AT,
          f"restore gave step {tr2.step_idx}")
    load_s = time.perf_counter() - t0
    tr2.run(steps=TRAIN_STEPS - RESUME_AT)
    got = host_state(tr2)
    differ = sum(not torch.equal(a, b) for a, b in zip(want, got))
    worst = max(float((a - b).abs().max()) for a, b in zip(want, got))
    tail = [m["loss"] for m in tr2.metrics_log]
    check(differ == 0, f"resumed run differs from the unbroken one in "
          f"{differ} of {len(want)} leaves (max abs {worst:.3g})")
    check(tail == losses[RESUME_AT:],
          f"resumed losses {tail} against {losses[RESUME_AT:]}")
    return {"trainer": tr2, "leaves": len(want), "differ": differ,
            "load_s": load_s}


def training_trace(tr) -> dict:
    """A ``torch.profiler`` trace of one more training step: the device's
    busy share and the eight largest device ops; the same step's FLOPs
    counted by ``FlopCounterMode`` (phase 14 holds the dry run's
    prediction to them; the counter's host cost lands in the trace's
    wall time); B5's launches in the step (``FlashAttention.launches`` set
    to 0 just before it and read just after), held to a forward and its
    remat recompute, then the backward's two launches, a layer."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention.kernel import kv_splits
    from repro_torch.kernels.flash_attention.ops import FlashAttention

    cfg = tr.cfg
    counter = FlopCounterMode(display=False)
    group = cfg.n_heads // cfg.n_kv_heads
    forward = 1 + (kv_splits(TRAIN_BATCH * cfg.n_heads, TRAIN_SEQ,
                             TRAIN_SEQ, cfg.hd, group) > 1)
    want = (2 * forward + 2) * cfg.n_layers

    def step():
        with counter:
            tr.run(steps=1)
    FlashAttention.launches = 0
    trace = device_trace(step, 1)
    launches = FlashAttention.launches
    check(launches == want, f"{launches} B5 launches in a training step, "
          f"not {want} ({cfg.n_layers} layers of a forward of {forward} "
          f"launches, its recompute and the backward's 2)")
    top = sorted(trace["by_name"].items(), key=lambda kv: -kv[1]["us"])[:8]
    return {"busy_share": trace["busy_share"], "wall_ms": trace["wall_us"]
            / 1e3, "busy_ms": trace["busy_us"] / 1e3,
            "events": sum(v["count"] for v in trace["by_name"].values()),
            "top_ms": {k: v["us"] / 1e3 for k, v in top},
            "flops_counted": counter.get_total_flops(),
            "attention_launches": launches}


def model_flops_per_step(cfg, n_params: int, tokens: int) -> float:
    """6 N T for the weights (the input embedding is a lookup, not a
    product: N leaves it out) plus 12 L H hd S T for the attention
    scores and their product with v (every key, as ``_sdpa`` computes
    them and B5's FLOP formula counts them; B5 skips the tiles the
    causal mask closes)."""
    n = n_params - cfg.padded_vocab(1) * cfg.d_model
    return 6.0 * n * tokens + 12.0 * cfg.n_layers * cfg.n_heads * cfg.hd \
        * TRAIN_SEQ * tokens


def dp2_leg() -> dict:
    """2 ``gloo`` ranks, each with its policy state on cuda:0 and the
    payloads on the host: smoke-width ``TRAIN_ARCH`` at ``MeshAxes(dp=2,
    fsdp=True, gather_bf16=True)`` with ``size_aware`` on ``tier="cuda"``,
    gradient sync bucketed and not, 3 steps each (the shared half of
    ``tests/test_torch_train_mesh.py``), against a 1-rank run of the same
    global batches on the host."""
    import multiprocessing as mp

    import torch_train_check as chk

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import tree_map

    cfg = get_smoke_config(TRAIN_ARCH).with_overrides(dtype="float32")
    params, _ = init_params(5, cfg, serve_axes(), device="cpu")
    w0 = tree_map(lambda t: t.numpy(), params)
    jobs = [dict(name=f"dp2_bucketed{int(b)}", kind="train", dp=2, tp=1,
                 fsdp=True, bf16=True, bucketed=b, clip=1.0, tier="cuda",
                 policy="size_aware") for b in (False, True)]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=chk.rank_main, args=(r, 2, port, q, jobs, w0))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    for r, rec in got.items():
        check("error" not in rec, f"dp2 rank {r}:\n{rec.get('error')}")
    one = chk.run_job(dict(name="one", kind="train", dp=1, tp=1, fsdp=False,
                           clip=1.0, tier="torch"), w0)
    out = {}
    for job in jobs:
        n = job["name"]
        worst, algos = 0.0, set()
        for r in range(2):
            rec = got[r][n]
            for part in ("params", "m", "v"):
                for path, want in one[part].items():
                    a = rec[part][path].astype("float64")
                    w = want.astype("float64")
                    worst = max(worst, float(((a - w) ** 2).sum() ** 0.5
                                             / max((w ** 2).sum() ** 0.5,
                                                   1e-30)))
            # size_aware reads a map, so the dispatcher keeps no cache
            # for it (hits 0): every decision is computed, by B1 on cuda
            hits, _ = rec["cache"]
            computed = len(rec["decisions"]) - hits
            check(computed > 0 and rec["launches"] == computed,
                  f"{n} rank {r}: {rec['launches']} B1 launches for "
                  f"{computed} decisions not served by the decision cache")
            check(rec["host_fallbacks"] == 0,
                  f"{n} rank {r}: {rec['host_fallbacks']} host fallbacks")
            check(rec["ran"] == rec["named"] and rec["ran"],
                  f"{n} rank {r}: the collectives ran {rec['ran'][:6]}, "
                  f"the decisions named {rec['named'][:6]}")
            algos.update(rec["ran"])
        check(worst <= DP2_TOL, f"{n}: params/moments {worst:.3g} "
              "from the 1-rank run (relative, per leaf)")
        out[n] = {"worst_rel": worst, "launches": got[0][n]["launches"],
                  "cache": got[0][n]["cache"],
                  "decisions": len(got[0][n]["decisions"]),
                  "collectives": len(got[0][n]["ran"]),
                  "algos": sorted(algos),
                  "loss": [m["loss"] for m in got[0][n]["metrics"]]}
    return out


def training_main_path(dev, lib, empty_ms: float, smi: str) -> tuple:
    """Phase 13 on the card: full-width ``TRAIN_ARCH`` trained with the
    §5.3 loop on ``tier="cuda"`` (launch counts set to 0 just before the
    run and read just after), held to its interp replay; loss checks,
    bf16 against f32, a bit-exact resume, a profiled step, the policy
    kernels timed on the trainer's state; then the ``dp = 2`` leg.  The
    kernels-line rows and the phase's record."""
    import torch

    t0 = time.time()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.cuda.empty_cache()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    try:
        run = train_with_loop(dev, "cuda")
        cfg = run["cfg"]
        log_ = run["trainer"].metrics_log
        losses = [m["loss"] for m in log_]
        check(len(log_) == TRAIN_STEPS and run["trainer"].step_idx
              == TRAIN_STEPS, f"{len(log_)} steps logged, step_idx "
              f"{run['trainer'].step_idx}: steps lost across the reload")
        check(run["trainer"].rebuilds == 1,
              f"the trainer rebuilt its step {run['trainer'].rebuilds} "
              "times for one replace")
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        first = run["first"]
        expect = math.log(cfg.vocab) + first["sigma"] ** 2 / 2
        check(abs(losses[0] - expect) <= LOSS_WINDOW,
              f"step 1 loss {losses[0]:.4f}, ln V + sigma^2/2 {expect:.4f}")
        check(losses[0] == first["bf16"]["loss"],
              f"step 1 loss {losses[0]} against its evaluation "
              f"{first['bf16']['loss']}")
        check(sum(losses[-3:]) < sum(losses[:3]),
              f"loss did not fall: {losses}")
        d_loss = abs(first["bf16"]["loss"] - first["f32"]["loss"]) \
            / first["f32"]["loss"]
        d_gn = abs(first["bf16"]["grad_norm"] - first["f32"]["grad_norm"]) \
            / first["f32"]["grad_norm"]
        check(d_loss <= BF16_LOSS_RTOL and d_gn <= BF16_GNORM_RTOL,
              f"bf16 against f32: loss {d_loss:.3g}, grad_norm {d_gn:.3g}")
        replay = replay_training_loop(run["feeds"])
        check(run["adapt_map"] == replay["adapt_map"],
              "adapt_map differs from the replay's")
        check(run["decision"] == replay["decision"],
              f"decision {run['decision']} against the replay's "
              f"{replay['decision']}")
        check(run["launches"] == {"adapt_tuner": 1,
                                  "adapt_profiler": TRAIN_STEPS},
              f"policy kernel launches {run['launches']} for "
              f"{TRAIN_STEPS} steps and 1 decision")
        for n, st in run["stats"].items():
            check(st["calls"] == run["launches"][n]
                  and st["host_fallbacks"] == 0,
                  f"{n}: bridge stats {st}, launches {run['launches'][n]}")
        check(run["samples"] == TRAIN_STEPS,
              f"{run['samples']} profiler samples for {TRAIN_STEPS} steps")
        rows = []
        for n in ("adapt_profiler", "adapt_tuner"):
            b = run["live"][n]
            t = kernel_timing(lib, b.kernel,
                              b._io[:b.kernel.n_fields].clone(),
                              {m: v.clone() for m, v in b._dev.items()})
            check(t["max_abs_err"] == 0, f"{n}: kernel disagrees on the "
                  f"training-path state (max abs err {t['max_abs_err']})")
            rows.append({"name": f"policy_kernel[{n}]@training",
                         "route": "cuda", "source": KERNEL_SOURCE,
                         "replaces": REPLACES,
                         "launches": run["launches"][n],
                         "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                         "plain_ms": t["plain_ms"], "bound_ms": empty_ms,
                         "bound_by": "launch", "library_ms": None})
        steps_s = [m["step_time_s"] for m in log_]
        resume = resume_check(run, dev)
        trace = training_trace(resume["trainer"])
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    del resume["trainer"]
    torch.cuda.empty_cache()
    tokens = TRAIN_SEQ * TRAIN_BATCH
    p50 = pct(steps_s, 50)
    flops = model_flops_per_step(cfg, run["n_params"], tokens)
    step = {"p50_ms": p50 * 1e3, "p99_ms": pct(steps_s, 99) * 1e3,
            "tokens_per_s": tokens / p50,
            "model_flops_share": flops / p50 / PEAK_BF16_FLOPS}
    t1 = time.time()
    dp2 = dp2_leg()
    dp2_s = time.time() - t1
    d = run["decision"]
    log(f"[train] {TRAIN_ARCH} at full width ({cfg.n_layers} layers, "
        f"D {cfg.d_model}, {run['n_params'] / 1e9:.3f} B params, bf16 "
        f"activations, f32 master, remat) on 1 card, B {TRAIN_BATCH} x S "
        f"{TRAIN_SEQ} ({tokens} tokens/step), {TRAIN_STEPS} steps: step "
        f"p50 {step['p50_ms']:.1f} ms p99 {step['p99_ms']:.1f} ms; "
        f"{step['tokens_per_s']:.0f} tokens/s; model FLOP/s "
        f"{flops / p50 / 1e12:.1f} T ({100 * step['model_flops_share']:.2f}"
        f"% of 989 TFLOP/s; 6 N T + attention, {flops / 1e12:.1f} TFLOP "
        f"per step); peak memory {run['peak'] / 2**30:.2f} GiB; {smi}")
    log(f"[train loss] " + " ".join(f"{x:.4f}" for x in losses)
        + f"; step 1 {losses[0]:.4f} against ln V + sigma^2/2 "
        f"{expect:.4f} (sigma {first['sigma']:.4f}); first three mean "
        f"{sum(losses[:3]) / 3:.4f}, last three {sum(losses[-3:]) / 3:.4f}"
        f"; step 1 in bf16 against f32 on the same params and batch: "
        f"loss {first['bf16']['loss']:.6f} / {first['f32']['loss']:.6f} "
        f"({d_loss:.3g} rel, limit {BF16_LOSS_RTOL:g}), grad_norm "
        f"{first['bf16']['grad_norm']:.5f} / {first['f32']['grad_norm']:.5f}"
        f" ({d_gn:.3g} rel, limit {BF16_GNORM_RTOL:g}); bf16 logits "
        f"against f32 (one sequence): rms {first['logits_rms_over_rms']:.4f}"
        f" of the rms")
    log(f"[train resume] saved at step {RESUME_AT} ({run['save_s']:.1f} s), "
        f"restored into a fresh Trainer ({resume['load_s']:.1f} s with its "
        f"init) and run to step {TRAIN_STEPS}: all {resume['leaves']} "
        f"params / m / v leaves bit-equal to the unbroken run's "
        f"(deterministic algorithms on)")
    log(f"[train loop] tier cuda: B1 launches adapt_profiler "
        f"{run['launches']['adapt_profiler']} (one per step), adapt_tuner "
        f"{run['launches']['adapt_tuner']} (one decision: algo {d.algo} "
        f"proto {d.proto} channels {d.channels}); the tuner's link "
        f"replaced warm after step {RESUME_AT}, the trainer rebuilt its "
        f"step once, 0 lost steps; host fallbacks 0; {run['samples']} "
        f"samples; adapt_map bytes and the Decision identical to the "
        f"interp replay")
    log(f"[train trace] one step under torch.profiler: {trace['wall_ms']:.1f}"
        f" ms, the device busy {trace['busy_ms']:.1f} ms of it "
        f"({100 * trace['busy_share']:.2f}%), {trace['events']} device "
        f"events, {trace['attention_launches']} of them B5's (a forward, "
        f"its recompute and the backward's 2 a layer); largest ms: "
        + "; ".join(
            f"{k[:60]} {v:.1f}" for k, v in trace["top_ms"].items()))
    log(f"[train dp2] 2 gloo ranks, smoke width, dp=2 FSDP on the bf16 "
        f"wire, size_aware on tier cuda ({dp2_s:.1f} s): " + "; ".join(
            f"{n}: params/moments within {v['worst_rel']:.3g} of the "
            f"1-rank run (limit {DP2_TOL:g}), B1 launches "
            f"{v['launches']} = {v['decisions']} decisions less "
            f"{v['cache'][0]} decision-cache hits (size_aware reads a map: "
            f"no cache), {v['collectives']} collectives each ran its "
            f"decided algorithm ({', '.join(v['algos'])})"
            for n, v in dp2.items()))
    record = {"arch": TRAIN_ARCH, "params": run["n_params"],
              "losses": losses, "step": step, "flops_per_step": flops,
              "peak_bytes": run["peak"], "first_step": first,
              "launches": run["launches"], "decision":
              dataclasses.asdict(d), "save_s": run["save_s"],
              "resume": {k: v for k, v in resume.items()
                         if k != "trainer"},
              "trace": trace, "dp2": dp2, "seconds": time.time() - t0}
    return rows, record


# ---------------------------------------------------------------------------
# phase 14: the launch plane
# ---------------------------------------------------------------------------

# the dry run on the production meshes: (arch, shape), each on pod and 2pod
LAUNCH_COMBOS = (("tinyllama-1.1b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
                 ("qwen3-1.7b", "decode_32k"))
LAUNCH_POLICY = "ring_mid_v2"
LAUNCH_MESHES = (("pod", 256), ("2pod", 512))
# the dry run of phase 13's step against phase 13's measurements: the
# matmul FLOPs are the same ATen ops on meta and on the card, and
# attention the same two B5 operators, counted by their FLOP formula
# (meta tensors take B5's route, as the card does; 0.5% leaves room for
# nothing but rounding); the working set misses what a CUDA kernel
# allocates inside itself, which no dispatch mode sees (B5's backward:
# its (B H, S) f32 row sums)
PRED_FLOPS_RTOL = 0.005
PRED_MEM_RTOL = 0.15
# make_serve_step at full width: qwen3-1.7b, prefill B 1 x S 2048, then
# 16 decode steps, against prefill / decode_step called directly
SERVE_STEP_DECODES = 16


def launch_dry_runs() -> dict:
    """(a) ``lower_combo`` for every ``LAUNCH_COMBOS`` entry on each mesh,
    one child process per mesh holding a fake group of its 256 or 512
    ranks, with ``LAUNCH_POLICY`` deciding on ``tier="cuda"`` (B1, its
    launch count set to 0 in the child just before the step and read just
    after)."""
    from repro_torch.launch import dryrun

    out = {}
    for mesh, world in LAUNCH_MESHES:
        jobs = [dict(arch=a, shape_name=s, multi_pod=mesh == "2pod",
                     policy=LAUNCH_POLICY, tier="cuda")
                for a, s in LAUNCH_COMBOS]
        for r in dryrun.run_mesh(world, jobs, timeout=600):
            key = f"{r['arch']}|{r['shape']}|{mesh}"
            check(r["status"] == "ok",
                  f"dry run {key}: {r.get('traceback', r)}")
            d = r["decisions"]
            computed = d["made"] - d["cache_hits"]
            check(r["n_devices"] == world and computed > 0
                  and d["policy_launches"] == computed,
                  f"dry run {key}: {d['policy_launches']} B1 launches for "
                  f"{computed} decisions not served by the decision cache "
                  f"({d})")
            out[key] = r
    return out


def launch_predictions(training: dict) -> dict:
    """(b) The dry run of phase 13's own step (its config, B x S, remat,
    one rank) against what phase 13 measured on the card: FLOPs against
    ``FlopCounterMode`` on the profiled step, the working set against
    ``max_memory_allocated``, ``t_compute`` against the step p50."""
    from repro_torch.launch import dryrun

    cfg, _ = train_configs()
    (r,) = dryrun.run_mesh(1, [dict(
        arch=TRAIN_ARCH, shape_name="train_4k", multi_pod=False,
        mesh_shape=(1, 1), cfg=cfg, global_batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, tier="cuda")], timeout=600)
    check(r["status"] == "ok", f"dry run of phase 13's step: "
          f"{r.get('traceback', r)}")
    flops = training["trace"]["flops_counted"]
    work = sum(r["memory_analysis"].values())
    peak = training["peak_bytes"]
    p50_s = training["step"]["p50_ms"] / 1e3
    out = {"flops": {"predicted": r["trace_flops_per_dev"],
                     "counted": flops,
                     "rel": r["trace_flops_per_dev"] / flops - 1},
           "working_set": {"predicted": work, "measured": peak,
                           "rel": work / peak - 1,
                           **r["memory_analysis"]},
           "t_compute_s": r["t_compute_s"], "t_memory_s": r["t_memory_s"],
           "step_p50_s": p50_s, "dominant": r["dominant"],
           "lower_s": r["lower_s"]}
    check(abs(out["flops"]["rel"]) <= PRED_FLOPS_RTOL,
          f"dry-run FLOPs {r['trace_flops_per_dev']:.6g} against "
          f"{flops:.6g} counted on the card")
    check(abs(out["working_set"]["rel"]) <= PRED_MEM_RTOL,
          f"dry-run working set {work / 2**30:.2f} GiB against the "
          f"card's peak {peak / 2**30:.2f} GiB")
    check(r["t_compute_s"] <= p50_s, f"t_compute {r['t_compute_s']:.4f} s "
          f"above the measured step p50 {p50_s:.4f} s")
    return out


def serve_step_at_width(dev) -> dict:
    """(c) ``make_serve_step`` serving ``SERVE_ARCH`` at full width in
    bf16 (weights cast once, as the engine casts them): prefill at B 1 x
    S ``PREFILL_TOKENS``, then ``SERVE_STEP_DECODES`` greedy decode steps,
    each bit-equal to ``prefill`` / ``decode_step`` called directly on the
    same inputs; ms per prefill and per decode step (CUDA events)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models.convert import compute_params
    from repro_torch.models.transformer import init_caches, tree_leaves
    from repro_torch.train.step import make_serve_step

    cfg = get_config(SERVE_ARCH)
    ax = serve_axes()
    params32, specs = init_params(12, cfg, ax, device=dev)
    params = compute_params(params32, cfg)
    del params32
    torch.cuda.empty_cache()
    ctx = PREFILL_TOKENS + SERVE_STEP_DECODES
    g = torch.Generator().manual_seed(41)
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_TOKENS),
                           generator=g).to(dev)
    pre = make_serve_step(cfg, ax, None, specs, None, mode="prefill")
    dec = make_serve_step(cfg, ax, None, specs, None, mode="decode")

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    pre(params, {"tokens": tokens})                          # warm-up
    logits, prefill_ms_ = timed(lambda: pre(params, {"tokens": tokens}))
    with torch.no_grad():
        direct = prefill(params, {"tokens": tokens}, cfg, ax)
    check(tuple(logits.shape) == (1, 1, cfg.vocab)
          and bool(torch.isfinite(logits.float()).all()),
          f"make_serve_step prefill gave {tuple(logits.shape)}")
    check(torch.equal(logits, direct), "make_serve_step's prefill logits "
          "differ from prefill's")
    caches = init_caches(params, cfg, 1, ctx, ax)
    mine = init_caches(params, cfg, 1, ctx, ax)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    ref_tok, decode_ms, toks = tok.clone(), [], []
    for i in range(SERVE_STEP_DECODES):
        pos = torch.full((1,), PREFILL_TOKENS + i, dtype=torch.int32,
                         device=dev)
        (tok, mine), ms = timed(lambda: dec(params, tok, mine, pos))
        decode_ms.append(ms)
        with torch.no_grad():
            ref_tok, caches = decode_step(params, ref_tok, caches, pos, cfg,
                                          ax)
        check(torch.equal(tok, ref_tok), f"decode step {i}: token "
              f"{tok.tolist()} against decode_step's {ref_tok.tolist()}")
        toks.append(int(tok))
    differ = sum(not torch.equal(a, b) for a, b in
                 zip(tree_leaves(mine), tree_leaves(caches)))
    check(differ == 0, f"{differ} cache leaves differ from decode_step's")
    out = {"prefill_ms": prefill_ms_, "decode_p50_ms": pct(decode_ms, 50),
           "decode_ms": decode_ms, "tokens": toks,
           "cache_leaves": len(tree_leaves(mine))}
    del params, caches, mine
    torch.cuda.empty_cache()
    return out


def examples_on_the_card() -> dict:
    """(d) ``quickstart_torch`` and ``policy_authoring_torch`` on the card
    (B1, and B2 for the in-graph tier) and with ``--cpu``: the same
    decision lines; every kernel the card runs launched."""
    import contextlib
    import io
    import re

    import policy_authoring_torch
    import quickstart_torch

    out = {}
    for name, mod in (("quickstart", quickstart_torch),
                      ("policy_authoring", policy_authoring_torch)):
        runs = {}
        for flag in ([], ["--cpu"]):
            with contextlib.redirect_stdout(io.StringIO()):
                runs[bool(flag)] = mod.main(flag)
        card, cpu = runs[False], runs[True]
        same = [re.sub(r"in-graph \([^)]*\)", "in-graph", ln)
                for ln in card["lines"]] == \
            [re.sub(r"in-graph \([^)]*\)", "in-graph", ln)
             for ln in cpu["lines"]]
        check(same, f"{name}: the card's decisions {card['lines']} against "
              f"the CPU's {cpu['lines']}")
        launches = {k.name: k.launches + k.launches32
                    for k in card["kernels"]}
        check(launches and all(v > 0 for v in launches.values())
              and not cpu["kernels"],
              f"{name}: kernel launches {launches} on the card, "
              f"{len(cpu['kernels'])} kernels with --cpu")
        out[name] = {"lines": card["lines"], "launches": launches}
    return out


def launch_main_path(dev, lib, empty_ms: float, training: dict,
                     smi: str) -> tuple:
    """Phase 14 on the card: (a) the dry runs on the production meshes,
    (b) phase 13's step predicted and held to its measurements, (c)
    ``make_serve_step`` at full width, (d) the examples.  The kernels-line
    row of the dry runs' B1 and the phase's record."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    import policy_authoring_torch
    import quickstart_torch
    import repro_torch.policies as pol
    from repro_torch.core import PolicyRuntime, cudac, make_ctx
    from repro_torch.core.context import AxisKind, CollType

    t0 = time.time()
    # the examples' own policies build while the dry runs trace
    with ThreadPoolExecutor(max_workers=1) as pool:
        built = pool.submit(cudac.build_all, [
            cudac.PolicyKernel(quickstart_torch.my_tuner.program),
            cudac.PolicyKernel(policy_authoring_torch.bucketizer.program)])
        dry = launch_dry_runs()
        built.result()
    dry_s = time.time() - t0
    for key, r in dry.items():
        log("[dryrun] " + json.dumps({k: v for k, v in r.items()
                                      if k != "collectives_by_op"}))
    launches = sum(r["decisions"]["policy_launches"] for r in dry.values())
    t1 = time.time()
    pred = launch_predictions(training)
    pred_s = time.time() - t1
    f, w = pred["flops"], pred["working_set"]
    log(f"[dryrun vs card] phase 13's step ({TRAIN_ARCH}, B {TRAIN_BATCH} x "
        f"S {TRAIN_SEQ}, remat, one rank) traced on meta tensors in "
        f"{pred['lower_s']} s: FLOPs {f['predicted']:.6e} predicted, "
        f"{f['counted']:.6e} counted on the card ({100 * f['rel']:+.4f}%, "
        f"limit {100 * PRED_FLOPS_RTOL:g}%); working set "
        f"{w['predicted'] / 2**30:.2f} GiB (arguments "
        f"{w['argument_size_in_bytes'] / 2**30:.2f}, temps "
        f"{w['temp_size_in_bytes'] / 2**30:.2f}) against "
        f"max_memory_allocated {w['measured'] / 2**30:.2f} GiB "
        f"({100 * w['rel']:+.2f}%, limit {100 * PRED_MEM_RTOL:g}%); "
        f"t_compute {pred['t_compute_s'] * 1e3:.1f} ms and t_memory "
        f"{pred['t_memory_s'] * 1e3:.1f} ms (H100 SXM datasheet: 989 "
        f"TFLOP/s, 3.35 TB/s) against the step p50 "
        f"{pred['step_p50_s'] * 1e3:.1f} ms; {smi}")
    t1 = time.time()
    serve = serve_step_at_width(dev)
    serve_s = time.time() - t1
    log(f"[serve step] make_serve_step, {SERVE_ARCH} at full width in bf16: "
        f"prefill B 1 x S {PREFILL_TOKENS} {serve['prefill_ms']:.2f} ms, "
        f"{SERVE_STEP_DECODES} decode steps p50 {serve['decode_p50_ms']:.2f}"
        f" ms; logits, tokens and all {serve['cache_leaves']} cache leaves "
        f"bit-equal to prefill / decode_step called directly; {smi}")
    t1 = time.time()
    ex = examples_on_the_card()
    ex_s = time.time() - t1
    log(f"[examples] quickstart_torch and policy_authoring_torch on the card "
        f"decide as with --cpu: " + "; ".join(
            f"{n}: {len(v['lines'])} decision lines, launches {v['launches']}"
            for n, v in ex.items()))
    # the dry runs' policy kernel, timed on a decision of their traffic
    rt = PolicyRuntime(tier="cuda")
    rt.load(getattr(pol, LAUNCH_POLICY).program)
    ctx = make_ctx("tuner", coll_type=CollType.ALL_REDUCE,
                   msg_size=8 << 20, n_ranks=16, comm_id=1,
                   axis_kind=AxisKind.MODEL, dtype_bytes=2, max_channels=32)
    rt.invoke("tuner", ctx)
    b = rt.chain("tuner")[0].fn
    t = kernel_timing(lib, b.kernel, b._io[:b.kernel.n_fields].clone(),
                      {m: v.clone() for m, v in b._dev.items()})
    check(t["max_abs_err"] == 0, f"{LAUNCH_POLICY}: kernel disagrees "
          f"(max abs err {t['max_abs_err']})")
    row = {"name": f"policy_kernel[{LAUNCH_POLICY}]@dryrun", "route": "cuda",
           "source": KERNEL_SOURCE, "replaces": REPLACES,
           "launches": launches, "max_abs_err": t["max_abs_err"],
           "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": empty_ms,
           "bound_by": "launch", "library_ms": None}
    seconds = time.time() - t0
    log(f"[launch] phase 14 in {seconds:.1f} s (dry runs {dry_s:.1f}, "
        f"prediction {pred_s:.1f}, serve step {serve_s:.1f}, examples "
        f"{ex_s:.1f}); B1 ({LAUNCH_POLICY}) {launches} launches in the "
        f"dry runs' children, {t['ms']:.6f} ms per launch; {smi}")
    torch.cuda.empty_cache()
    record = {"dry": dry, "predictions": pred, "serve_step": serve,
              "examples": ex, "seconds": seconds,
              "seconds_by_part": {"dry": dry_s, "prediction": pred_s,
                                  "serve_step": serve_s, "examples": ex_s}}
    return [row], record


# ---------------------------------------------------------------------------
# phase 15: the sync-free in-graph step
# ---------------------------------------------------------------------------

# the stream of tests/test_ingraph_dispatch.py (fast, slow, recovered)
REF_STREAM = [1_000] * 4 + [5_000_000] * 6 + [1_000] * 8
N_LOG_UNIFORM = 1_000       # seeded log-uniform latencies, 1e3-1e7 ns
X_BYTES = 16 << 20          # the captured step's all-reduce payload
N_DEVICE_REPLAYS = 64       # (d): replays per spelling of the card


def op_probe():
    """A ``TorchDispatchMode`` counting ATen ops (``.ops``) and host
    reads (``.reads``: ``aten._local_scalar_dense``, which ``.item()``
    and ``bool()`` reach) in its ``with`` block."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Probe(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0
            self.reads = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            if func is torch.ops.aten._local_scalar_dense.default:
                self.reads += 1
            return func(*args, **(kwargs or {}))
    return Probe()


class sync_errors:
    """``torch.cuda.set_sync_debug_mode("error")`` for a ``with`` block:
    any synchronising call inside it raises."""

    def __enter__(self):
        import torch
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        import torch
        torch.cuda.set_sync_debug_mode(0)


def _snap(ret, ctx, maps) -> tuple:
    return ret.reshape(-1).clone(), ctx.clone(), \
        {n: t.clone() for n, t in maps.items()}


def _snap_err(a: tuple, b: tuple) -> int:
    """Largest u64 disagreement between two snapshots (0 iff equal)."""
    worst = max(max_abs_diff(a[0].cpu().numpy(), b[0].cpu().numpy()),
                max_abs_diff(a[1].cpu().numpy(), b[1].cpu().numpy()))
    for n in a[2]:
        worst = max(worst, max_abs_diff(a[2][n].cpu().numpy(),
                                        b[2][n].cpu().numpy()))
    return worst


def predicated_on_card(kernels, dev, lib) -> dict:
    """(a) For every shipped policy, on phase 3's seeded maps and ctx
    samples: ``torchc.compile_predicated`` run eagerly on the card under
    sync-debug ``"error"``, then captured once in a CUDA graph and
    replayed on every sample copied into its static inputs (the maps
    carried from sample to sample on every side), each held bit for bit
    to B1 and the interpreter.  Per policy: ATen ops per decision, eager
    host ms (ending in a synchronise), device us per replay and B1's
    device us on the same inputs."""
    import numpy as np
    import torch

    import torch_samples as samples
    from repro_torch.core import torchc
    from repro_torch.core.vm import VM

    out = {}
    for i, k in enumerate(kernels):
        prog = k.prog
        torchc.check_supported(prog)
        fn, names = torchc.compile_predicated(prog, k.vinfo)
        seed = 100 + i                              # phase 3's seeds
        host = samples.make_maps(prog, np.random.default_rng(seed))
        vm = VM(prog.insns, host, subprogs=prog.subprogs)
        start = {n: torchc.map_to_array(m, dev) for n, m in host.items()}
        rng = np.random.default_rng(seed + 1)
        bufs = [samples.make_ctx(prog, rng) for _ in range(N_SAMPLES)]
        ctxs = [torchc.ctx_to_vec(b, dev) for b in bufs]
        k_maps = {n: t.clone() for n, t in start.items()}
        p_maps = {n: t.clone() for n, t in start.items()}
        kern, eager = [], []
        torch.cuda.synchronize()
        with sync_errors():
            for c in ctxs:
                kc = c.clone()
                kr = torch.zeros(1, dtype=torch.int64, device=dev)
                k.launch(kc, kr, k_maps)
                kern.append(_snap(kr, kc, k_maps))
                r, pc, p_maps = fn(c, p_maps)
                eager.append(_snap(r, pc, p_maps))
        s_ctx = ctxs[0].clone()
        s_maps = {n: t.clone() for n, t in start.items()}
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            g_ret, g_ctx, g_maps = fn(s_ctx, s_maps)
        captured = []
        with sync_errors():
            for c in ctxs:
                s_ctx.copy_(c)
                g.replay()
                captured.append(_snap(g_ret, g_ctx, g_maps))
                for n in names:
                    s_maps[n].copy_(g_maps[n])
        torch.cuda.synchronize()
        worst = 0
        for j, buf in enumerate(bufs):
            v_buf = bytearray(buf)
            v_ret = vm.run(v_buf) & M64
            v = (torch.tensor([torchc._s64(v_ret)]),
                 torch.from_numpy(np.frombuffer(bytes(v_buf), "<i8").copy()),
                 {n: torch.from_numpy(m.to_device().view("<i8").copy())
                  for n, m in host.items()})
            worst = max(worst, _snap_err(kern[j], v), _snap_err(eager[j], v),
                        _snap_err(captured[j], v))
        check(worst == 0, f"{prog.name}: the predicated lowering disagrees "
              f"with B1 or the interpreter (max abs err {worst})")
        probe = op_probe()
        with probe:
            fn(ctxs[0], start)
        check(probe.reads == 0, f"{prog.name}: {probe.reads} host reads in "
              "the predicated lowering")
        times = []
        for _ in range(3):
            t0 = time.perf_counter_ns()
            fn(ctxs[0], start)
            torch.cuda.synchronize()
            times.append(time.perf_counter_ns() - t0)
        replay_ms = device_ms(lib, g.replay, reps=10 if probe.ops > 4000
                              else 50, warmup=2)
        kc, kr = ctxs[0].clone(), torch.zeros(1, dtype=torch.int64,
                                               device=dev)
        km = {n: t.clone() for n, t in start.items()}
        b1_ms = device_ms(lib, lambda: k.launch(kc, kr, km), reps=100)
        out[prog.name] = {"max_abs_err": worst, "samples": N_SAMPLES,
                          "aten_ops": probe.ops,
                          "eager_host_ms": pct(times, 50) / 1e6,
                          "replay_device_us": replay_ms * 1e3,
                          "b1_device_us": b1_ms * 1e3}
        del g
    return out


def adaptive_ingraph_program():
    """``adaptive_ingraph`` of ``tests/test_ingraph_dispatch.py``, built
    with the port's frontend: EMA the latency in ``lat_map``; tree (2)
    when slow, default (0) when fast; ``lat_map[0][1]`` counts the
    decisions."""
    import repro_torch.core as core

    lat_map = core.map_decl("lat_map", kind="array", value_size=16,
                            max_entries=4)

    @core.policy(section="tuner", maps=[lat_map])
    def adaptive_ingraph(ctx):
        st = lat_map.lookup(0)
        if st is None:
            ctx.algorithm = 0
            return 0
        if st[0] == 0:
            st[0] = ctx.dtype_bytes
        else:
            st[0] = (st[0] * 3 + ctx.dtype_bytes) // 4
        st[1] = st[1] + 1
        if st[0] > 1000000:
            ctx.algorithm = 2          # tree: latency-optimized
            ctx.n_channels = 2
        else:
            ctx.algorithm = 0          # default
            ctx.n_channels = 8
        return 0

    return adaptive_ingraph.program


def replay_latencies(seed: int = 41) -> list:
    """The reference test's stream, then ``N_LOG_UNIFORM`` seeded
    log-uniform latencies of 1e3-1e7 ns (whole ns)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tail = np.rint(10.0 ** rng.uniform(3, 7, N_LOG_UNIFORM)).astype(np.int64)
    return REF_STREAM + tail.tolist()


def captured_loop(prog, tier: str, dev, nccl, gloo, lats, lib) -> dict:
    """(b) ``sel.all_reduce`` on ``tier`` over a 1-rank NCCL group and a
    16 MiB f32 ``x`` on the card: first ``lats`` eagerly (the branch
    picked on the host), then the same stream as replays of one captured
    step (the decision, the switch node over the branches, ``y``'s error
    folded into a device running max, the algo written into a device log
    at the write cursor, the state copied into the static state), every
    replay under sync-debug ``"error"`` and its latency written by a
    device fill.  Then a profiled window of replays, the device time of
    a replay, and a capture over a gloo group, which must raise.  The
    times are taken before the profiled window, outside sync-debug."""
    import torch

    from repro_torch.collectives import ingraph
    from repro_torch.collectives.ingraph import (CURSOR_KEY, FAULT_KEY,
                                                 InGraphSelector)
    from repro_torch.core import graphs
    from repro_torch.core.pair import pairs_to_words

    sel = InGraphSelector(prog, tier=tier)
    gen = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn(X_BYTES // 4, device=dev, generator=gen)
    lat = torch.zeros((), dtype=torch.int64, device=dev)
    state = sel.init_state()
    eager = []
    t0 = time.perf_counter_ns()
    for v in lats:
        lat.fill_(v)
        y, algo, state = sel.all_reduce(x, "data", state, group=nccl,
                                        latency_ns=lat)
        eager.append(int(algo))
    eager_ns = time.perf_counter_ns() - t0
    check(torch.equal(y, x), f"{tier}: an eager 1-rank all-reduce changed x")
    eager_state = {k: v.cpu().numpy().tobytes() for k, v in state.items()}
    syncs = sel.host_syncs
    check(syncs == len(lats), f"{tier}: {syncs} host reads for "
          f"{len(lats)} eager steps")

    static = sel.init_state()
    log = torch.full((len(lats),), -1, dtype=torch.int32, device=dev)
    err = torch.zeros((), dtype=torch.float32, device=dev)
    captures = graphs.captures
    # each branch body also bumps its own device counter: which body
    # each replay ran, read on the card (y == x on one rank whichever
    # body runs, or if none does)
    ran = torch.zeros(len(ingraph._BRANCHES), dtype=torch.int64,
                      device=dev)
    branches = ingraph._BRANCHES
    ingraph._BRANCHES = [
        (name, lambda v, grp, f=f, i=i: (ran[i:i + 1].add_(1),
                                         f(v, grp))[1])
        for i, (name, f) in enumerate(branches)]
    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g):
            cur = static[CURSOR_KEY].to(torch.int64) % len(lats)
            y, algo, new = sel.all_reduce(x, "data", static, group=nccl,
                                          latency_ns=lat)
            log.index_copy_(0, cur, algo.reshape(1))
            err.copy_(torch.maximum(err, (y - x).abs().max()))
            for k in static:
                static[k].copy_(new[k])
    finally:
        ingraph._BRANCHES = branches
    check(graphs.captures == captures + 1,
          f"{tier}: the captured step holds no switch node")
    # the main path's launches: the eager run's and the capture's
    launches = sel.kernel.launches32 if tier == "cuda32" \
        else sel.kernel.launches
    replays = [0]

    def replay():
        g.replay()
        replays[0] += 1

    debug_ns = []
    torch.cuda.synchronize()
    with sync_errors():
        for v in lats:
            t0 = time.perf_counter_ns()
            lat.fill_(v)
            replay()
            debug_ns.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    got = log.cpu().tolist()
    check(sel.host_syncs == syncs, f"{tier}: the replays read the host "
          f"{sel.host_syncs - syncs} times")
    check(got == eager, f"{tier}: captured algos differ from the eager "
          f"run's at {[i for i, (a, b) in enumerate(zip(got, eager)) if a != b][:5]}")
    bodies = ran.cpu().tolist()
    check(bodies == [got.count(i) for i in range(len(bodies))],
          f"{tier}: the bodies ran {bodies} times for algos "
          f"{[got.count(i) for i in range(len(bodies))]}")
    first = got[:len(REF_STREAM)]
    check(first[0] == 0 and 2 in first and first[-1] == 0,
          f"{tier}: the reference stream gave {first}")
    for k in (*sel.map_names, FAULT_KEY, CURSOR_KEY):
        check(static[k].cpu().numpy().tobytes() == eager_state[k],
              f"{tier}: captured {k} differs from the eager run's")
    lat_map = static["lat_map"].cpu()
    count = int(pairs_to_words(lat_map)[0, 1]) if sel.word_width == 32 \
        else int(lat_map[0, 1])
    check(count == len(lats), f"{tier}: lat_map counted {count} decisions "
          f"for {len(lats)} replays")
    check(float(err) == 0.0, f"{tier}: y != x on a replay (max |y - x| "
          f"{float(err)})")

    # times, before any profiler session: host us per replay (outside
    # sync-debug, which checks every call), device us per replay, and
    # the same step without the all-reduce
    host_ns = []
    for v in lats[len(REF_STREAM):][:TIMING_REPS]:
        t0 = time.perf_counter_ns()
        lat.fill_(v)
        replay()
        host_ns.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    replay_ms, blocked_ms = replay_timing(lib, replay)
    # the same step without the all-reduce (no switch node): what the
    # switch node and its bodies add to a replay's launch
    scratch = sel.init_state()
    g2 = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g2):
        _, _, new = sel.decide(scratch, coll=0, msg_bytes=X_BYTES, n=1,
                               latency_ns=lat)
        for k in scratch:
            scratch[k].copy_(new[k])
    decide_ns = []
    for _ in range(N_TRACE):
        t0 = time.perf_counter_ns()
        g2.replay()
        decide_ns.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    decide_ms, decide_blocked_ms = replay_timing(lib, g2.replay)

    # a profiled window, checked by the device's own counts (ROADMAP
    # C12: torch.profiler drops records of replays, whole replays on
    # torchc): each replay ran one body, advanced the write cursor and
    # counted one decision in lat_map.  The trace gives the times; its
    # record counts are printed, not checked
    window = lats[:N_TRACE]

    def device_counts() -> dict:
        torch.cuda.synchronize()
        lat_map = static["lat_map"].cpu()
        return {"bodies": ran.cpu().tolist(),
                "cursor": int(static[CURSOR_KEY].cpu().numpy().view(
                    "<u4")[0]),
                "decisions": int(pairs_to_words(lat_map)[0, 1])
                if sel.word_width == 32 else int(lat_map[0, 1])}

    def run():
        for v in window:
            lat.fill_(v)
            replay()
    before = device_counts()
    trace = device_trace(run, n=len(window))
    after = device_counts()
    written = log.cpu().tolist()
    algos = [written[(before["cursor"] + i) % len(lats)]
             for i in range(len(window))]
    kname = {"cuda": "bpf_kernel", "cuda32": "bpf_kernel32"}.get(tier)
    seen = {"kernel": trace["by_name"].get(kname, {}).get("count", 0)
            if kname else None,
            "switch": sum(v["count"] for n, v in trace["by_name"].items()
                          if n.startswith("bpf_switch_set")),
            "copies": len(trace["memcpy_us"]),
            "nccl": sum(v["count"] for n, v in trace["by_name"].items()
                        if "nccl" in n.lower())}
    failed, counted = window_failures(before, after, algos, seen)
    check(not failed, f"{tier}: the profiled window of {len(window)} "
          "replays: " + "; ".join(failed))
    scratch = sel.init_state()
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            sel.all_reduce(x, "data", scratch, group=gloo, latency_ns=lat)
    except RuntimeError as e:
        refused = str(e)
    else:
        refused = ""
    check("'gloo'" in refused, f"{tier}: a capture over a gloo group was "
          f"not refused ({refused!r})")
    return {"algos": got, "eager_algos": eager, "host_syncs": syncs,
            "launches": launches, "replays": replays[0],
            "eager_step_us": eager_ns / len(lats) / 1e3,
            "replay_host_p50_us": pct(host_ns, 50) / 1e3,
            "replay_host_p99_us": pct(host_ns, 99) / 1e3,
            "replay_host_debug_p50_us": pct(debug_ns, 50) / 1e3,
            "replay_device_us": replay_ms * 1e3,
            "replay_behind_spin_host_ms": blocked_ms, "trace": trace,
            "decide_only": {"host_p50_us": pct(decide_ns, 50) / 1e3,
                            "device_us": decide_ms * 1e3,
                            "behind_spin_host_ms": decide_blocked_ms},
            "window": {"replays": len(window),
                       "default": algos.count(0), "counted": counted,
                       "before": before, "after": after, "seen": seen},
            "bodies": bodies,
            "gloo_refused": refused, "sel": sel, "static": static}


def window_failures(before: dict, after: dict, algos: list,
                    seen: dict) -> tuple:
    """Phase 15 (b)'s check of a profiled window of ``len(algos)``
    replays, by the device's counts read before and after it
    (``bodies``: each branch body's run counter; ``cursor``: the write
    cursor, a uint32 that wraps; ``decisions``: ``lat_map``'s decision
    count).  Each replay runs exactly one body, the one of its algo,
    advances the cursor and counts one decision, so each count moves by
    the window: a switch that ran no body or two, or a replay that did
    not run, fails.  ``seen`` (the trace's record counts: policy kernel,
    switch setters, copies, NCCL kernels) is printed, never checked:
    ``torch.profiler`` drops records of replays (ROADMAP C12).  The
    failed checks, and a line for the log."""
    n = len(algos)
    ran = [a - b for a, b in zip(after["bodies"], before["bodies"])]
    want = [algos.count(i) for i in range(len(ran))]
    cursor = (after["cursor"] - before["cursor"]) % (1 << 32)
    decisions = after["decisions"] - before["decisions"]
    failed = []
    if sum(ran) != n:
        failed.append(f"the bodies ran {sum(ran)} times in {n} replays")
    if ran != want:
        failed.append(f"the bodies ran {ran} times, the window's algos "
                      f"say {want}")
    if cursor != n:
        failed.append(f"the write cursor advanced by {cursor} in {n} "
                      "replays")
    if decisions != n:
        failed.append(f"lat_map counted {decisions} decisions in {n} "
                      "replays")
    line = (f"bodies +{ran} for algos {want}, cursor +{cursor}, lat_map "
            f"+{decisions}; seen in trace: " + ", ".join(
                f"{k} {v}" for k, v in seen.items() if v is not None))
    return failed, line


def captured_device_spellings(prog, dev, nccl, lats) -> dict:
    """(d) ROADMAP C10: ``torchc`` selectors built with ``device=None``,
    ``"cuda"`` and ``"cuda:<current>"``; each one's ``all_reduce``
    captured as in (b), over the same 1-rank NCCL group with a latency
    tensor on the card, and replayed over ``lats`` under sync-debug
    ``"error"``.  Per spelling: the device the selector holds, the
    algorithm log, the state bytes, its host reads and max |y - x|."""
    import torch

    from repro_torch.collectives.ingraph import CURSOR_KEY, InGraphSelector
    from repro_torch.core import graphs

    gen = torch.Generator(device=dev).manual_seed(15)
    x = torch.randn(X_BYTES // 4, device=dev, generator=gen)
    lat = torch.zeros((), dtype=torch.int64, device=dev)
    out = {}
    for spelling in (None, "cuda", f"cuda:{torch.cuda.current_device()}"):
        sel = InGraphSelector(prog, tier="torchc", device=spelling)
        static = sel.init_state()
        algos = torch.full((len(lats),), -1, dtype=torch.int32, device=dev)
        err = torch.zeros((), dtype=torch.float32, device=dev)
        captures = graphs.captures
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            cur = static[CURSOR_KEY].to(torch.int64)
            y, algo, new = sel.all_reduce(x, "data", static, group=nccl,
                                          latency_ns=lat)
            algos.index_copy_(0, cur, algo.reshape(1))
            err.copy_(torch.maximum(err, (y - x).abs().max()))
            for k in static:
                static[k].copy_(new[k])
        check(graphs.captures == captures + 1, f"device={spelling!r}: the "
              "captured step holds no switch node")
        torch.cuda.synchronize()
        with sync_errors():
            for v in lats:
                lat.fill_(v)
                g.replay()
        torch.cuda.synchronize()
        out[repr(spelling)] = {
            "device": str(sel.device), "algos": algos.cpu().tolist(),
            "state": {k: v.cpu().numpy().tobytes()
                      for k, v in static.items()},
            "host_syncs": sel.host_syncs, "max_abs_err": float(err)}
    return out


def empty_in_graph_ms(lib, n: int = 50) -> float:
    """The duration of an empty <<<1,1>>> kernel inside a CUDA graph, as
    ``torch.profiler`` reads a kernel node's (the bound of a policy
    kernel timed the same way in a captured step)."""
    import torch

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(n):
            check(lib.bpf_empty_launch(stream) == 0, "empty kernel launch")
    g.replay()
    trace = device_trace(lambda: [g.replay() for _ in range(4)], n=4 * n)
    ev = next(v for k, v in trace["by_name"].items()
              if k.startswith("bpf_empty"))
    return ev["us_each"] / 1e3


def replay_timing(lib, replay, spin_ns: int = 50_000_000) -> tuple:
    """Device ms per replay of a captured step: CUDA events around
    ``TIMING_REPS`` replays issued back to back.  First, the host ms of
    one replay issued behind a ``spin_ns`` spin kernel: near 0 when a
    replay only enqueues (the events then read device time), near the
    spin when the launch waits for the stream's earlier work (the events
    then also hold each launch's latency)."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    check(lib.bpf_spin_launch(stream, spin_ns) == 0, "spin kernel launch")
    t0 = time.perf_counter_ns()
    replay()
    blocked_ms = (time.perf_counter_ns() - t0) / 1e6
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMING_REPS):
        replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / TIMING_REPS, blocked_ms


def sync_free_main_path(kernels, dev, lib, empty_ms: float, smi: str,
                        eager_parts: dict) -> tuple:
    """Phase 15 on the card: (a) :func:`predicated_on_card`; (b)
    :func:`captured_loop` on ``cuda``, ``cuda32`` and ``torchc``, the
    launch counts set to 0 just before and read just after, every tier's
    algos equal; (c) the replay times beside phase 8's eager step parts;
    (d) :func:`captured_device_spellings`, the ``torchc`` step captured
    with each spelling of the card.  Returns the ``@captured`` kernel-table rows of B1 and B2 and the
    phase's record."""
    import torch.distributed as dist

    from repro_torch.core import graphs
    from repro_torch.core.pair import words_to_pairs

    t_phase = time.time()
    pred = predicated_on_card(kernels, dev, lib)
    pred_s = time.time() - t_phase
    log("[predicated] every shipped policy: torchc.compile_predicated on "
        "the card, eager under sync-debug 'error' and as replays of one "
        "capture, bit-exact against B1 and the interpreter over "
        f"{N_SAMPLES} samples, 0 host reads ({pred_s:.1f} s); per "
        "decision ATen ops / eager host ms / replay device us / B1 device "
        "us: " + "; ".join(
            f"{n} {r['aten_ops']} / {r['eager_host_ms']:.3f} / "
            f"{r['replay_device_us']:.1f} / {r['b1_device_us']:.2f}"
            for n, r in pred.items()) + f"; {smi}")

    prog = adaptive_ingraph_program()
    lats = replay_latencies()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        gloo = dist.new_group(backend="gloo")
        runs = {}
        for tier in ("cuda", "cuda32", "torchc"):
            runs[tier] = captured_loop(prog, tier, dev, dist.group.WORLD,
                                       gloo, lats, lib)
        t_spell = time.time()
        spellings = captured_device_spellings(
            prog, dev, dist.group.WORLD, lats[:N_DEVICE_REPLAYS])
        spell_s = time.time() - t_spell
    finally:
        dist.destroy_process_group()
    for tier in ("cuda32", "torchc"):
        check(runs[tier]["algos"] == runs["cuda"]["algos"],
              f"{tier}: captured algos differ from cuda's")
    base = spellings["None"]
    check(base["algos"] == runs["torchc"]["eager_algos"][:N_DEVICE_REPLAYS],
          "device=None: the replayed algos differ from (b)'s eager run")
    for spelling, r in spellings.items():
        check(r["device"] == str(dev), f"device={spelling}: the selector "
              f"holds {r['device']}, its tensors are on {dev}")
        check(r["host_syncs"] == 0 and r["max_abs_err"] == 0.0,
              f"device={spelling}: {r['host_syncs']} host reads, max "
              f"|y - x| {r['max_abs_err']}")
        check(r["algos"] == base["algos"], f"device={spelling}: algos "
              "differ from device=None's")
        check(r["state"] == base["state"], f"device={spelling}: state "
              "bytes differ from device=None's")
    log(f"[captured device] torchc selectors built with device=" +
        ", ".join(spellings) + f" all hold {dev}; each one's all_reduce "
        f"captured over the 1-rank NCCL group with the latency a tensor "
        f"on the card and replayed over the first {N_DEVICE_REPLAYS} "
        f"latencies under sync-debug 'error': algos (default "
        f"{base['algos'].count(0)}, tree {base['algos'].count(2)}) and "
        f"state bytes equal to device=None's, which equal (b)'s eager "
        f"run, 0 host reads, y == x ({spell_s:.1f} s); {smi}")
    empty_graph_ms = empty_in_graph_ms(lib)
    rows = []
    for tier, label, kname in (("cuda", "policy_kernel", "bpf_kernel"),
                               ("cuda32", "policy_kernel32",
                                "bpf_kernel32")):
        r = runs[tier]
        sel = r["sel"]
        check(r["launches"] > 0, f"{tier}: the policy kernel never launched")
        st = {m: v for m, v in r["static"].items() if m in sel.map_names}
        ctx = sel._ctx_vec({"coll_type": 0, "msg_size": X_BYTES,
                            "n_ranks": 1, "comm_id": 0, "max_channels": 32,
                            "dtype_bytes": 1_000})
        t = kernel_timing(lib, sel.kernel,
                          words_to_pairs(ctx) if tier == "cuda32"
                          else ctx, st, pairs=tier == "cuda32")
        check(t["max_abs_err"] == 0, f"{tier}: the kernel disagrees on the "
              f"captured step's state (max abs err {t['max_abs_err']})")
        ev = r["trace"]["by_name"][kname]
        rows.append({"name": f"{label}[{prog.name}]@captured",
                     "route": "cuda",
                     "source": KERNEL32_SOURCE if tier == "cuda32"
                     else KERNEL_SOURCE,
                     "replaces": REPLACES32 if tier == "cuda32"
                     else REPLACES,
                     "launches": r["launches"],
                     "graph_launches": r["replays"],
                     "max_abs_err": t["max_abs_err"],
                     "ms": ev["us_each"] / 1e3, "plain_ms": t["plain_ms"],
                     "bound_ms": empty_graph_ms, "bound_by": "launch",
                     "library_ms": None})
    seconds = time.time() - t_phase
    in_graph = " / ".join(f"{1e3 * r['ms']:.3f}" for r in rows)
    log(f"[captured] adaptive_ingraph's all_reduce over a 1-rank NCCL "
        f"group, x f32 {X_BYTES >> 20} MiB, captured once per tier and "
        f"replayed {len(lats)} times (the reference stream, then "
        f"{N_LOG_UNIFORM} log-uniform latencies) under sync-debug "
        f"'error': algos equal to the eager run and across cuda, cuda32 "
        f"and torchc, state bytes equal, lat_map counts {len(lats)}, y == "
        f"x on every replay, a gloo capture refused; switch nodes "
        f"{graphs.captures}; branch bodies run (default, ring, tree, "
        f"bidir) per the device counters, equal to the algos: " + "; ".join(
            f"{t} {r['bodies']}" for t, r in runs.items())
        + f"; per tier, a profiled window of {N_TRACE} replays held by "
        f"device counts: " + "; ".join(
            f"{t} {r['window']['counted']}" for t, r in runs.items()))
    log("[captured time] per replay: host p50 / p99 us (p50 under "
        "sync-debug), device us, busy share of the window; eager step "
        "(all_reduce with its host read) us: " + "; ".join(
            f"{t} {r['replay_host_p50_us']:.1f} / "
            f"{r['replay_host_p99_us']:.1f} "
            f"({r['replay_host_debug_p50_us']:.1f}), "
            f"{r['replay_device_us']:.1f}, "
            f"{100 * r['trace']['busy_share']:.2f}%; eager "
            f"{r['eager_step_us']:.1f}" for t, r in runs.items())
        + "; phase 8's eager step parts (us): " + "; ".join(
            f"{t} " + " ".join(f"{k} {v:.1f}" for k, v in p.items())
            for t, p in eager_parts.items())
        + "; the step without the all-reduce (no switch node), host p50 / "
        "device us: " + "; ".join(
            f"{t} {r['decide_only']['host_p50_us']:.1f} / "
            f"{r['decide_only']['device_us']:.1f}" for t, r in runs.items())
        + "; a launch behind a 50 ms spin took (host ms) " + "; ".join(
            f"{t} {r['replay_behind_spin_host_ms']:.2f} with the switch, "
            f"{r['decide_only']['behind_spin_host_ms']:.2f} without"
            for t, r in runs.items())
        + f"; B1 / B2 in a replay {in_graph} us against an empty kernel "
        f"in a graph {1e3 * empty_graph_ms:.3f} us"
        + f" ({seconds:.1f} s for the phase); {smi}")
    record = {"seconds": seconds, "predicated_s": pred_s,
              "predicated": pred,
              "captured": {t: {k: v for k, v in r.items()
                               if k not in ("sel", "static", "algos",
                                            "eager_algos")}
                           for t, r in runs.items()},
              "device_spellings": {k: {"device": r["device"],
                                       "host_syncs": r["host_syncs"]}
                                   for k, r in spellings.items()},
              "device_spellings_s": spell_s,
              "switch_nodes": graphs.captures,
              "empty_in_graph_ms": empty_graph_ms}
    return rows, record


# ---------------------------------------------------------------------------

def main() -> int:
    # cuBLAS's fixed workspace: phase 13 trains with deterministic
    # algorithms on, which torch refuses for cuBLAS without it (read when
    # the handle is made, so before any card work)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    # the model kernels (phase 10) build beside the policy kernels
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=2) as pool:
        model_build = pool.submit(build_model_kernels)
        policies = [cudac.PolicyKernel(p.program) for p in ALL_POLICIES]
        earlier_build = pool.submit(earlier_kernels, policies)
        kernels = cudac.build_all(policies)
        earlier = earlier_build.result()
        model_build_s = model_build.result()
    build_s = time.time() - t0
    stats = cudac.cache_stats()
    log(f"[build] {len(kernels)} policy kernels, the same programs in the "
        f"earlier design (one library) and 3 model kernels in "
        f"{build_s:.1f} s (nvcc runs {stats['builds']}, cache hits "
        f"{stats['cache_hits']}); the model kernels' build took "
        f"{model_build_s:.1f} s of it")
    reports = {k.name: kernel_report(k) for k in kernels}
    log("[kernel design] per program: frame routes; threads; per entry "
        "local bytes / registers / shared bytes (cudaFuncGetAttributes), "
        "localSizeBytes 0 on route regs checked: " + "; ".join(
            f"{n} {','.join(r['routes'])}; {r['threads']}; " + " ".join(
                f"{e} {a['local_bytes']}/{a['registers']}/"
                f"{a['shared_bytes']}" for e, a in r["attrs"].items())
            for n, r in reports.items()))
    early_attrs = {n: k.attributes() for n, k in earlier.items()}
    log("[kernel design] the earlier design (route memory, <<<1,1>>>), "
        "local bytes / registers per entry: " + "; ".join(
            f"{n} " + " ".join(f"{e} {a['local_bytes']}/{a['registers']}"
                               for e, a in at.items())
            for n, at in early_attrs.items()))

    # ---- 3. kernel vs plain version vs interpreter -------------------------
    diff = {}
    for i, k in enumerate(kernels):
        r = differential(k, dev, seed=100 + i)
        check(r["max_abs_err"] == 0,
              f"{k.name}: kernel disagrees (max abs err {r['max_abs_err']})")
        diff[k.name] = {"launches": k.launches, **r}
    log("[kernels] bit-exact vs torchc and the VM: " + " ".join(
        f"{n}={d['launches']}" for n, d in diff.items()))
    lib = timing_lib()
    empty_ms = empty_device_ms(lib)
    warp_ms = empty_warp_ms(lib)
    table = []
    for i, k in enumerate(kernels):
        ctx0, maps0 = phase3_state(k, dev, 100 + i)
        t = kernel_timing(lib, k, ctx0, maps0, earlier=earlier[k.name],
                          plain_reps=3)
        check(t["max_abs_err"] == 0 and t["earlier_max_abs_err"] == 0,
              f"{k.name}: a design disagrees on phase 3's state "
              f"({t['max_abs_err']}, {t['earlier_max_abs_err']})")
        diff[k.name]["timing"] = t
        table.append(policy_row(f"policy_kernel[{k.name}]@phase3", k,
                                diff[k.name]["launches"], t, empty_ms,
                                reports[k.name]))
    log("[phase3 time] B1 us per launch on phase 3's state, back to back "
        "on the card, this design / the earlier design (same run): "
        + "; ".join(f"{n} {1e3 * d['timing']['ms']:.3f} / "
                    f"{1e3 * d['timing']['earlier_ms']:.3f}"
                    for n, d in diff.items())
        + f"; empty launch <<<1,1>>> {1e3 * empty_ms:.3f}, <<<1,32>>> "
        f"{1e3 * warp_ms:.3f}; {smi}")

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
    host_floor = host_floor_ms(lib)
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
    main_rows = []
    for n in MAIN_PATH:
        b = live[n]
        t = kernel_timing(lib, b.kernel, b._io[:b.kernel.n_fields].clone(),
                          {m: v.clone() for m, v in b._dev.items()},
                          earlier=earlier[n])
        check(t["max_abs_err"] == 0 and t["earlier_max_abs_err"] == 0,
              f"{n}: a design disagrees on the main-path state (max abs "
              f"err {t['max_abs_err']}, {t['earlier_max_abs_err']})")
        main_rows.append(policy_row(f"policy_kernel[{n}]", b.kernel,
                                    launches[n], t, empty_ms, reports[n]))
    table[:0] = main_rows
    log("[kernel time] ms per launch, back to back on the card, this design "
        "(the earlier design in the same run): " + "; ".join(
            f"{r['name']} {r['ms']:.6f} ({r['earlier_ms']:.6f})"
            for r in main_rows) + f"; empty launch {empty_ms:.6f}; {smi}")

    parts = {n: bridge_breakdown(live[n]) for n in MAIN_PATH}
    log("[breakdown] median us per bridge call, from its spans under the "
        "profiler (call = upload + enqueue + wait + writeback + host "
        "work): " + "; ".join(
            f"{n} " + " ".join(f"{k} {v:.1f}" for k, v in p.items())
            for n, p in parts.items()))
    trace = device_trace(main_path_window(cuda_run["disp"]))
    log_trace("[trace]", "decisions", trace)

    # ---- 7. the pair-form kernel (B2) --------------------------------------
    from repro_torch.collectives.ingraph import InGraphSelector
    diff32 = {}
    for i, k in enumerate(kernels):
        if not k.pairs:
            builds = cudac.cache_stats()["builds"]
            for make in (lambda: cudac.check_supported32(k.prog),
                         lambda: InGraphSelector(k.prog, tier="cuda32")):
                try:
                    make()
                except cudac.CudacError as e:
                    check("lru_hash" in str(e) and "cuda32" in str(e),
                          f"{k.name}: unexpected cuda32 rejection {e}")
                else:
                    raise RuntimeError(f"chip smoke failed: {k.name} "
                                       "accepted for cuda32")
            check(cudac.cache_stats()["builds"] == builds,
                  f"a kernel was built for {k.name} on cuda32")
            diff32[k.name] = "rejected (lru_hash)"
            continue
        before = k.launches32
        r = differential(k, dev, seed=200 + i, pairs=True)
        check(r["max_abs_err"] == 0, f"{k.name}: pair-form kernel "
              f"disagrees (max abs err {r['max_abs_err']})")
        diff32[k.name] = {"launches32": k.launches32 - before, **r}
        ctx0, maps0 = phase3_state(k, dev, 200 + i, pairs=True)
        t = kernel_timing(lib, k, ctx0, maps0, pairs=True,
                          earlier=earlier[k.name], plain_reps=3)
        check(t["max_abs_err"] == 0 and t["earlier_max_abs_err"] == 0,
              f"{k.name}: a pair-form design disagrees on phase 7's state "
              f"({t['max_abs_err']}, {t['earlier_max_abs_err']})")
        diff32[k.name]["timing"] = t
        table.append(policy_row(f"policy_kernel32[{k.name}]@phase7", k,
                                diff32[k.name]["launches32"], t, empty_ms,
                                reports[k.name], pairs=True))
    gold = goldens32(dev)
    log(f"[pair] {sum(isinstance(v, dict) for v in diff32.values())} "
        f"policies bit-exact vs torchc.run32 and the VM; rejected for "
        f"cuda32: {[n for n, v in diff32.items() if isinstance(v, str)]}; "
        f"{gold['goldens']} golden programs bit-exact (built in "
        f"{gold['build_s']:.1f} s)")
    log("[phase7 time] B2 us per launch on phase 7's state, back to back "
        "on the card, this design / the earlier design (same run): "
        + "; ".join(f"{n} {1e3 * d['timing']['ms']:.3f} / "
                    f"{1e3 * d['timing']['earlier_ms']:.3f}"
                    for n, d in diff32.items() if isinstance(d, dict))
        + f"; empty launch {1e3 * empty_ms:.3f}; {smi}")

    # ---- 8. in-graph closed loop -------------------------------------------
    disp = warmed_dispatcher()
    steps = ingraph_steps()
    t0 = time.time()
    ig = {t: ingraph_loop(disp, t, steps) for t in ("cuda32", "cuda",
                                                      "torch")}
    ig_s = time.time() - t0
    n_dec = N_SHARDS * N_STEPS
    for t in ("cuda32", "cuda"):
        check(ig[t]["picks"] == ig["torch"]["picks"],
              f"in-graph {t} decisions differ from torch's")
        check(ig[t]["maps"] == ig["torch"]["maps"],
              f"in-graph {t} merged maps differ from torch's")
        check(ig[t]["launches"] == n_dec,
              f"in-graph {t}: {ig[t]['launches']} launches for {n_dec} "
              "decide calls")
        check(ig[t]["merged"] == ig["torch"]["merged"] == 1,
              f"in-graph {t}: {ig[t]['merged']} maps merged")
    ig_algos = sorted({a for a, _ in ig["torch"]["picks"]})
    check(len(ig_algos) >= 2, f"in-graph loop ran one algorithm {ig_algos}")
    step = {t: {"p50_us": pct(ig[t]["times_ns"], 50) / 1e3,
                "p99_us": pct(ig[t]["times_ns"], 99) / 1e3}
            for t in ("cuda32", "cuda", "torch")}
    log(f"[ingraph] {N_SHARDS} shard states x {N_STEPS} steps on cuda32, "
        f"cuda and torch ({ig_s:.1f} s): identical (algo, channels), "
        f"algorithms {ig_algos}, faults {ig['torch']['faults']}, merged "
        f"maps identical; launches cuda32 {ig['cuda32']['launches']}, "
        f"cuda {ig['cuda']['launches']}; step (decide + host read + pick) "
        + "; ".join(f"{t} p50 {v['p50_us']:.1f} us p99 {v['p99_us']:.1f} us"
                    for t, v in step.items()) + f"; {smi}")
    sel32 = ig["cuda32"]["sel"]
    from repro_torch.collectives.ingraph import CURSOR_KEY, FAULT_KEY
    from repro_torch.core import torchc
    ctx32 = torchc.words_to_pairs(sel32._ctx_vec(
        {"coll_type": 0, "msg_size": 1 << 20, "n_ranks": 8, "comm_id": 0,
         "max_channels": 32}))
    t32 = kernel_timing(lib, sel32.kernel, ctx32,
                        {m: v for m, v in ig["cuda32"]["states"][0].items()
                         if m not in (FAULT_KEY, CURSOR_KEY)}, pairs=True,
                        earlier=earlier[sel32.program.name])
    check(t32["max_abs_err"] == 0 and t32["earlier_max_abs_err"] == 0,
          "pair-form kernel disagrees on the in-graph state (max abs err "
          f"{t32['max_abs_err']}, {t32['earlier_max_abs_err']})")
    table.append(policy_row(f"policy_kernel32[{sel32.program.name}]",
                            sel32.kernel, ig["cuda32"]["launches"], t32,
                            empty_ms, reports[sel32.program.name],
                            pairs=True))
    log(f"[kernel32 time] {table[-1]['name']} {t32['ms']:.6f} ms per "
        f"launch back to back on the card (the earlier design "
        f"{t32['earlier_ms']:.6f}); empty launch {empty_ms:.6f}; "
        f"plain (torchc.run32) {t32['plain_ms']:.6f} ms; {smi}")
    ig_parts = {t: ingraph_breakdown(ig[t]["sel"], ig[t]["states"][0])
                for t in ("cuda32", "cuda")}
    log("[ingraph breakdown] median us per step (step = ctx + copy + "
        "launch + clamp + read + host work): " + "; ".join(
            f"{t} " + " ".join(f"{k} {v:.1f}" for k, v in p.items())
            for t, p in ig_parts.items()))
    ig_trace = device_trace(ingraph_window(sel32, ig["cuda32"]["states"][0]))
    log_trace("[ingraph trace]", "cuda32 in-graph steps", ig_trace)

    # ---- 9. collectives ----------------------------------------------------
    t0 = time.time()
    ranks = gloo_collectives()
    coll_s = time.time() - t0
    for r, rec in sorted(ranks.items()):
        check(not rec["bad"], f"rank {r}: {rec['bad'][:3]}")
        check(rec["builds"] == 0, f"rank {r} built {rec['builds']} kernels")
        check(len(rec["algos"]) >= 2, f"rank {r} ran one algorithm "
              f"{rec['algos']}")
        check(rec["launches32"] == N_COLL_STEPS,
              f"rank {r}: {rec['launches32']} pair-form launches")
    check(ranks[0]["merged"] == 1 and
          ranks[0]["count_delta"] == N_RANKS * N_COLL_STEPS,
          f"merged rank states: {ranks[0].get('merged')} maps, count "
          f"delta {ranks[0].get('count_delta')}")
    coll_algos = sorted({a for r in ranks.values() for a in r["algos"]})
    nccl = nccl_one_rank(dev)
    log(f"[collectives] {N_RANKS}-rank gloo, {N_COLL_STEPS} steps per rank "
        f"({coll_s:.1f} s): every output allclose to torch's collective "
        f"(worst {max(r['worst']['simple'] for r in ranks.values())} "
        f"SIMPLE, {max(r['worst']['bf16'] for r in ranks.values())} bf16 "
        f"wire); algorithms {coll_algos}; "
        f"rank states merged (count delta {ranks[0]['count_delta']}); "
        f"1-rank NCCL on the card: {nccl['ran']}")

    # ---- 10. the model kernels (B3-B5) -------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    small = model_test_shapes(dev)
    log(f"[model build] 3 model kernels (rmsnorm.cu, grouped_matmul.cu, "
        f"flash_attention.cu) built by nvcc in {model_build_s:.1f} s, in "
        f"parallel with the policy kernels; at the test shapes, float32 "
        f"and bfloat16, each kernel within tolerance of its plain version "
        f"on the card: " + ", ".join(f"{k} max abs err {v:.3g}"
                                     for k, v in small.items()))
    mixed = model_operand_dtypes(dev)
    log(f"[model dtypes] mixed and float16 operands (ROADMAP C7), "
        f"{len(OPERAND_MIXES)} mixes a kernel at the test shapes, each "
        f"within its output dtype's tolerance of its plain version on the "
        f"card, launches as planned: " + ", ".join(
            f"{k} max abs err {v:.3g}"
            for k, v in mixed["max_abs_err"].items())
        + "; routes: " + "; ".join(f"{k}: {v}"
                                   for k, v in mixed["routes"].items()))
    model_rows, model_cells = model_main_path(dev, lib)
    table.extend(model_rows)
    attn_rows, attn_cells = attention_train_main_path(dev, lib)
    table.extend(attn_rows)
    zero_rows = zero_rows_at_width(dev)
    model_s = time.time() - t0
    log(f"[model] {len(model_rows)} full-width cells through the ops, each "
        f"launching its kernel as its design states (1, or 2 for a "
        f"split-KV call; the grouped matmul on wgmma) and within 2e-2 "
        f"and two bf16 steps "
        f"(+ 2^-8 rms) of its plain version; "
        f"{zero_rows} query rows without keys exactly 0 ({model_s:.1f} s); "
        f"{smi}")

    # ---- 11. the host tiers and the observability plane --------------------
    from repro_torch.core import cc
    t0 = time.time()
    have_cc = cc.have_cc()
    auto_tier = PolicyRuntime(tier="auto").tier
    cpu = host_cpu()
    if have_cc:
        log(f"[host tiers] have_cc() True: the native tier builds with "
            f"{' '.join(cc._CC)}; tier='auto' resolves to {auto_tier}")
    else:
        log("[host tiers] have_cc() False: no C toolchain on this machine; "
            "tier='native' runs the jit closure and no native number is "
            "reported")
    codegen = {p.program.name: host_tier_identity(p.program, seed=100 + i)
               for i, p in enumerate(ALL_POLICIES)}
    # the host tiers launch no kernel: every count set to 0 before their
    # closed loops and read after
    counted = (list(kernels) + [b.kernel for b in cuda_run["bridges"]]
               + list(model_kernels().values()))
    for k in counted:
        k.launches = 0
        if hasattr(k, "launches32"):
            k.launches32 = 0
    host_runs = {t: closed_loop(t, N_DECISIONS) for t in ("native", "jit")}
    host_launches = sum(k.launches + getattr(k, "launches32", 0)
                        for k in counted)
    check(host_launches == 0,
          f"{host_launches} kernel launches on the host tiers")
    for t, r in host_runs.items():
        check(r["decisions"] == interp_run["decisions"]
              == cuda_run["decisions"],
              f"{t} decisions differ from interp's and cuda's")
        check(r["maps"] == interp_run["maps"] == cuda_run["maps"],
              f"{t} final map bytes differ from interp's and cuda's")
    timed = ("native", "jit") if have_cc else ("jit",)
    dec_lat = {t: {"p50_us": pct(r["times_ns"], 50) / 1e3,
                   "p99_us": pct(r["times_ns"], 99) / 1e3}
               for t, r in ([(t, host_runs[t]) for t in timed]
                            + [("cuda", cuda_run), ("interp", interp_run)])}
    log(f"[host tiers] every shipped policy on jit, native and auto "
        f"identical to interp over phase 3's samples (ret, ctx, every map "
        f"byte); {N_DECISIONS} closed-loop decisions on "
        f"CollectiveDispatcher(tier='native') and (tier='jit') identical "
        f"to interp and cuda (decisions and final maps), 0 kernel "
        f"launches; decide() " + "; ".join(
            f"{t} p50 {v['p50_us']:.2f} us p99 {v['p99_us']:.2f} us"
            for t, v in dec_lat.items()) + f"; host CPU {cpu}; {smi}")
    t1 = table1_latency(timed)
    log("[table1] ns per decision on the host clock, runtime.invoke p50 / "
        "p99 (the loaded program alone p50): " + "; ".join(
            f"{k} {v['invoke_p50_ns']:.0f} / {v['invoke_p99_ns']:.0f} "
            f"({v['fn_p50_ns']:.0f})" for k, v in t1.items())
        + f"; host CPU {cpu}; {smi}")
    obs = {t: recorder_run(r) for t, r in (("cuda", cuda_run),
                                            ("interp", interp_run))}
    check(obs["cuda"]["histogram"] == obs["interp"]["histogram"]
          and obs["cuda"]["stragglers"] == obs["interp"]["stragglers"],
          "the flight recorder saw other events on cuda than on interp")
    host_s = time.time() - t0
    log(f"[obs] FlightRecorder on the phase-5 cuda runtime: {N_RECORDED} "
        f"decisions counted by the latency histogram, "
        f"{len(obs['cuda']['stragglers'])} straggler records, "
        f"{obs['cuda']['lines']} JSON lines valid by the exporter's own "
        f"validator; histogram and records identical to interp's "
        f"({host_s:.1f} s for the phase)")

    # ---- 12. the model zoo and the serving engine --------------------------
    serve_rows, serving = serving_main_path(dev, lib, empty_ms, smi)
    table.extend(serve_rows)

    # ---- 13. the training path ---------------------------------------------
    train_rows, training = training_main_path(dev, lib, empty_ms, smi)
    table.extend(train_rows)

    # ---- 14. the launch plane ----------------------------------------------
    launch_rows, launch = launch_main_path(dev, lib, empty_ms, training,
                                           smi)
    table.extend(launch_rows)

    # ---- 15. the sync-free in-graph step -----------------------------------
    sync_rows, sync_free = sync_free_main_path(kernels, dev, lib, empty_ms,
                                               smi, ig_parts)
    table.extend(sync_rows)

    record = {"device": name, "nvidia_smi": smi, "build_s": build_s,
              "kernel_design": reports, "earlier_attrs": early_attrs,
              "differential": diff, "latency": lat,
              "host_floor_ms": host_floor, "empty_launch_ms": empty_ms,
              "empty_warp_ms": warp_ms,
              "breakdown_us": parts, "trace": trace,
              "main_path_s": {"cuda": cuda_s, "interp": interp_s},
              "differential32": diff32, "goldens32": gold,
              "ingraph": {"seconds": ig_s, "step_us": step,
                          "algos": ig_algos,
                          "faults": ig["torch"]["faults"],
                          "launches": {t: ig[t]["launches"]
                                       for t in ("cuda32", "cuda")}},
              "kernel32": t32, "ingraph_breakdown_us": ig_parts,
              "ingraph_trace": ig_trace,
              "collectives": {"seconds": coll_s, "ranks": ranks,
                              "nccl": nccl},
              "model_kernels": {"build_s": model_build_s,
                                "test_shapes_max_abs_err": small,
                                "operand_dtypes": mixed,
                                "cells": model_cells,
                                "train_attention": attn_cells,
                                "zero_rows": zero_rows,
                                "seconds": model_s},
              "host_tiers": {"have_cc": have_cc,
                             "compiler": cc._CC, "auto": auto_tier,
                             "host_cpu": cpu, "codegen": codegen,
                             "decide_us": dec_lat, "table1_ns": t1,
                             "recorder": {k: v for k, v in obs["cuda"].items()
                                          if k != "stragglers"},
                             "seconds": host_s},
              "serving": serving, "training": training, "launch": launch,
              "sync_free": sync_free,
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
