#!/usr/bin/env python3
"""What a replay of the captured in-graph step costs the host, part by
part.

    python3 scripts/captured_step_probe.py

Needs a CUDA card.  ``chip_smoke.py`` phase 15 captures
``adaptive_ingraph``'s ``sel.all_reduce`` (1-rank NCCL group, 16 MiB
f32) with a device log of the algo and a device running max of
``|y - x|``.  This script captures that step on ``tier="cuda32"`` in
variants that add one part at a time, twice each in turns:

* ``decide``: the decision and the state copy only;
* ``switch``: plus the all-reduce (the switch node over its branches);
* ``switch+log``: plus the algo written at the write cursor;
* ``switch+err``: plus the running max of ``|y - x|``;
* ``full``: all of them (phase 15's step).

Per variant: host us per replay (p50 over 300 replays, each after a
device fill of the latency), and the host ms of one replay issued behind
a ~50 ms ``torch.cuda._sleep`` (near 0 when the launch only enqueues,
near 50 when it waits for the stream's earlier work).  Prints one JSON
record (also to ``chiprun_out/captured_step_probe.json``) with the
card's name and power limit.
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

VARIANTS = ("decide", "switch", "switch+log", "switch+err", "full")


def capture(sel, variant: str, x, lat, nccl, n_log: int):
    import torch

    from repro_torch.collectives.ingraph import CURSOR_KEY
    static = sel.init_state()
    log = torch.full((n_log,), -1, dtype=torch.int32, device=x.device)
    err = torch.zeros((), dtype=torch.float32, device=x.device)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        cur = static[CURSOR_KEY].to(torch.int64) % n_log
        if variant == "decide":
            algo, _, new = sel.decide(static, coll=0,
                                      msg_bytes=x.numel() * 4, n=1,
                                      latency_ns=lat)
        else:
            y, algo, new = sel.all_reduce(x, "data", static, group=nccl,
                                          latency_ns=lat)
        if variant in ("switch+log", "full"):
            log.index_copy_(0, cur, algo.reshape(1))
        if variant in ("switch+err", "full"):
            err.copy_(torch.maximum(err, (y - x).abs().max()))
        for k in static:
            static[k].copy_(new[k])
    return g, (static, log, err)


def cost(g, lat) -> dict:
    import torch
    times = []
    for i in range(300):
        t0 = time.perf_counter_ns()
        lat.fill_(1_000 if i % 3 else 5_000_000)
        g.replay()
        times.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter_ns()
    g.replay()
    behind = (time.perf_counter_ns() - t0) / 1e6
    torch.cuda.synchronize()
    return {"host_p50_us": sorted(times)[150] / 1e3,
            "behind_sleep_host_ms": behind}


def main() -> int:
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("captured_step_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.collectives.ingraph import InGraphSelector

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
    rec = {"nvidia_smi": smi, "torch": torch.__version__, "runs": []}
    try:
        sel = InGraphSelector(chip_smoke.adaptive_ingraph_program(),
                              tier="cuda32")
        x = torch.randn(chip_smoke.X_BYTES // 4, device=dev)
        lat = torch.zeros((), dtype=torch.int64, device=dev)
        st = sel.init_state()
        for _ in range(3):                       # the eager warm-up
            _, _, st = sel.all_reduce(x, "data", st, latency_ns=lat)
        torch.cuda.synchronize()
        for turn in range(2):
            for v in VARIANTS:
                g, keep = capture(sel, v, x, lat, dist.group.WORLD, 4096)
                rec["runs"].append({"turn": turn, "variant": v,
                                    **cost(g, lat)})
                del g, keep
    finally:
        dist.destroy_process_group()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "captured_step_probe.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
