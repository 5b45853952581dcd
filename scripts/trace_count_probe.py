#!/usr/bin/env python3
"""Does ``torch.profiler`` see every kernel of a replayed captured step?

    python3 scripts/trace_count_probe.py [--phase15 R]

Needs a CUDA card.  ``chip_smoke.py`` phase 15 (b) checks, in a profiled
window of replays of the captured ``adaptive_ingraph`` step, that the
switch node's setter kernel ran once per replay.  This script captures
that step (a 1-rank NCCL group, 16 MiB f32) on ``tier="cuda"`` (a few
kernels per replay) and ``tier="torchc"`` (~260), then profiles windows
of 25, 50, 100 and 200 replays in turns, three rounds, every replay
after a device fill of one fixed latency, so that every replay runs the
same nodes and each kernel name must be seen a multiple of the window's
replays.  Per window: the setter kernels seen, all device events, and
the names seen a count that is not such a multiple.  With ``--phase15
R`` it instead runs phase 15 (b) itself (``chip_smoke.captured_loop``
on ``cuda``, ``cuda32`` and ``torchc``) ``R`` times in one process, its
checks recorded instead of raised, and reports each run's failed checks
and its profiled window: setter and kernel events against the replays,
all device events, and every name seen fewer times than the replays.
Prints a line per window, then, last, one JSON record of them all with
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

WINDOWS = (25, 50, 100, 200)
ROUNDS = 3


def capture(sel, x, lat, nccl):
    import torch

    from repro_torch.collectives.ingraph import CURSOR_KEY
    static = sel.init_state()
    log = torch.full((4096,), -1, dtype=torch.int32, device=x.device)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        cur = static[CURSOR_KEY].to(torch.int64) % 4096
        _, algo, new = sel.all_reduce(x, "data", static, group=nccl,
                                      latency_ns=lat)
        log.index_copy_(0, cur, algo.reshape(1))
        for k in static:
            static[k].copy_(new[k])
    return g, (static, log)


def window(g, lat, n: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            lat.fill_(1_000)
            g.replay()
        torch.cuda.synchronize()
    counts: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            counts[e.name] = counts.get(e.name, 0) + 1
    setter = sum(c for k, c in counts.items()
                 if k.startswith("bpf_switch_set"))
    return {"replays": n, "setter": setter,
            "events": sum(counts.values()),
            "short": {k: c for k, c in counts.items() if c % n}}


def phase15_runs(rounds: int, tiers, settles, dev, smi: str) -> dict:
    """Phase 15 (b) ``rounds`` times per tier, its checks recorded; round
    ``i`` waits ``settles[i % len(settles)]`` s before its profiler
    stops.  Per run, where the window's setter kernels lie: the us from
    the window's first device event to the first setter, from the last
    setter to the last event, the median gap between setters and the
    gaps over three times it."""
    import torch
    import torch.distributed as dist
    import torch.profiler

    import chip_smoke

    class Settled(torch.profiler.profile):
        settle = 0.0
        last = None

        def __exit__(self, *exc):
            time.sleep(Settled.settle)
            Settled.last = self
            return super().__exit__(*exc)

    torch.profiler.profile = Settled
    failed: list = []
    chip_smoke.check = lambda cond, msg: cond or failed.append(msg)
    prog = chip_smoke.adaptive_ingraph_program()
    lats = chip_smoke.replay_latencies()
    lib = chip_smoke.timing_lib()
    gloo = dist.new_group(backend="gloo")
    rec = {"nvidia_smi": smi, "runs": []}
    for turn in range(rounds):
        for tier in tiers:
            del failed[:]
            Settled.settle = settles[turn % len(settles)]
            r = chip_smoke.captured_loop(prog, tier, dev, dist.group.WORLD,
                                         gloo, lats, lib)
            n = r["window"]["replays"]
            by_name = r["trace"]["by_name"]
            dev_ev = [e for e in Settled.last.events()
                      if e.device_type.name == "CUDA"]
            t0 = min(e.time_range.start for e in dev_ev)
            t1 = max(e.time_range.end for e in dev_ev)
            sets = sorted(e.time_range.start for e in dev_ev
                          if e.name.startswith("bpf_switch_set"))
            gaps = [b - a for a, b in zip(sets, sets[1:])]
            med = sorted(gaps)[len(gaps) // 2] if gaps else 0.0
            rec["runs"].append({
                "round": turn, "tier": tier, "settle_s": Settled.settle,
                "failed": list(failed), "window": r["window"],
                "events": sum(v["count"] for v in by_name.values()),
                "head_us": sets[0] - t0 if sets else None,
                "tail_us": t1 - sets[-1] if sets else None,
                "median_gap_us": med,
                "long_gaps": [(i, g) for i, g in enumerate(gaps)
                              if g > 3 * med],
                "below_replays": {k: v["count"] for k, v in by_name.items()
                                  if v["count"] < n}})
            w = rec["runs"][-1]
            print(tier, turn, w["settle_s"], w["window"]["switch"],
                  w["events"], round(w["head_us"] or 0, 1),
                  round(w["tail_us"] or 0, 1), round(med, 1),
                  w["long_gaps"][:4], w["failed"], flush=True)
    return rec


def main() -> int:
    import argparse

    import torch
    import torch.distributed as dist
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase15", type=int, default=0, metavar="R")
    ap.add_argument("--tiers", default="cuda,cuda32,torchc")
    ap.add_argument("--settle", default="0",
                    help="comma-separated waits (s) before the profiler "
                         "stops, taken in turns by the rounds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_count_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.collectives.ingraph import InGraphSelector
    from repro_torch.core import cudac

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    rec = {"nvidia_smi": smi, "torch": torch.__version__, "windows": []}
    if args.phase15:
        try:
            rec = phase15_runs(args.phase15, args.tiers.split(","),
                               [float(v) for v in args.settle.split(",")],
                               dev, smi)
        finally:
            dist.destroy_process_group()
        print(json.dumps(rec))
        return 0
    try:
        prog = chip_smoke.adaptive_ingraph_program()
        cudac.PolicyKernel(prog).build()
        x = torch.randn(chip_smoke.X_BYTES // 4, device=dev)
        lat = torch.zeros((), dtype=torch.int64, device=dev)
        for tier in ("cuda", "torchc"):
            sel = InGraphSelector(prog, tier=tier)
            st = sel.init_state()
            for _ in range(3):          # eager first: NCCL's communicator
                _, _, st = sel.all_reduce(x, "data", st, latency_ns=lat)
            torch.cuda.synchronize()
            g, keep = capture(sel, x, lat, dist.group.WORLD)
            for _ in range(8):                   # warm replays
                g.replay()
            for turn in range(ROUNDS):
                for n in WINDOWS:
                    rec["windows"].append({"tier": tier, "round": turn,
                                           **window(g, lat, n)})
                    w = rec["windows"][-1]
                    print(tier, turn, n, w["setter"], w["events"],
                          w["short"], flush=True)
            del g, keep
    finally:
        dist.destroy_process_group()
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
