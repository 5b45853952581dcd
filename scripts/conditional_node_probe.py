#!/usr/bin/env python3
"""What CUDA-graph conditional nodes take on this card's torch.

    python3 scripts/conditional_node_probe.py

Needs a CUDA card.  Prints one JSON record (also to
``chiprun_out/conditional_node_probe.json``) with the card's name and
power limit:

1. the torch and CUDA versions, and whether torch binds conditional
   nodes (``CUDAGraph.get_currently_capturing_graph``,
   ``begin_capture_to_if_node``, ``end_capture_to_conditional_node``);
2. the port's switch node (``core/graphs.py``) captured with four
   bodies, each a 16 MiB copy, the body picked by a device int ``algo``:
   each replay's output, and the device events of a ``torch.profiler``
   window of replays;
3. the same with ``dist.all_reduce`` of a 1-rank NCCL group inside the
   first body (the in-graph selector's default branch): whether the
   capture is accepted (the CUDA error if not), each replay's output,
   and what the device runs in a window of replays and in one eager
   call;
4. a policy kernel (B1, ``adapt_tuner``) launched inside a capture and
   replayed, against eager launches on the same inputs;
5. whether replays and device fills pass ``set_sync_debug_mode("error")``;
6. the host cost of a replay: p50 us over 200 replays, and the host ms
   of one replay issued behind a ~50 ms ``torch.cuda._sleep`` (near 0
   when the launch only enqueues, near 50 when it waits for the
   stream's earlier work), for each switch graph and for the same copy
   captured without a switch node.

Each part is caught and recorded, so one refusal does not hide the rest.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src")]


def device_events(run) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0) + 1
    return out


def switch_probe(x, bodies, picks) -> dict:
    import torch
    algo = torch.zeros((), dtype=torch.int32, device=x.device)
    y = torch.zeros_like(x)
    for b in bodies:            # warm-up: each body once, eagerly
        b()
    torch.cuda.synchronize()
    from repro_torch.core import graphs
    graphs.build()
    pool = torch.cuda.MemPool()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        graphs.captured_switch(algo, bodies, y, pool)
    ok = []
    for a in picks:
        y.zero_()
        algo.fill_(a)
        g.replay()
        ok.append(bool(torch.equal(y, x)))

    def window():
        for a in picks:
            algo.fill_(a)
            g.replay()
    rec = {"picks": picks, "y_equals_x": ok,
           "window_events": device_events(window),
           "launch": launch_cost(g.replay)}
    torch.cuda.set_sync_debug_mode("error")
    try:
        for a in picks:
            algo.fill_(a)
            g.replay()
        rec["sync_debug_error_passed"] = True
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return rec


def launch_cost(replay) -> dict:
    import time

    import torch
    times = []
    for _ in range(200):
        t0 = time.perf_counter_ns()
        replay()
        times.append(time.perf_counter_ns() - t0)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)          # ~50 ms at the SM clock
    t0 = time.perf_counter_ns()
    replay()
    behind = (time.perf_counter_ns() - t0) / 1e6
    torch.cuda.synchronize()
    return {"host_p50_us": sorted(times)[100] / 1e3,
            "behind_sleep_host_ms": behind}


def plain_copy(x) -> dict:
    import torch
    y = torch.zeros_like(x)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        y.copy_(x)
    return launch_cost(g.replay)


def guarded(rec: dict, key: str, fn) -> None:
    try:
        rec[key] = fn()
    except Exception as e:       # recorded: the probe reports every part
        rec[key] = {"error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]}


def main() -> int:
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("conditional_node_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    G = torch.cuda.CUDAGraph
    rec = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "nvidia_smi": smi,
           "binds": {n: hasattr(G, n) for n in (
               "get_currently_capturing_graph", "begin_capture_to_if_node",
               "end_capture_to_conditional_node")},
           "nccl_version": ".".join(map(str, torch.cuda.nccl.version()))}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    x = torch.randn(4 << 20, device=dev)                # 16 MiB of f32
    picks = [0, 2, 0, 1, 3, 0, 2, 2]
    copy = [lambda: x] * 4
    guarded(rec, "copy_bodies", lambda: switch_probe(x, copy, picks))
    guarded(rec, "copy_without_switch", lambda: plain_copy(x))

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        def native():
            z = x.clone()
            dist.all_reduce(z)
            return z
        native()
        torch.cuda.synchronize()
        guarded(rec, "eager_all_reduce_events", lambda: device_events(
            lambda: [native() for _ in range(3)]))
        guarded(rec, "nccl_body", lambda: switch_probe(
            x, [native] + copy[1:], picks))
    finally:
        dist.destroy_process_group()

    def kernel_capture():
        from repro_torch.core import cudac, torchc
        from repro_torch.core.maps import MapRegistry
        from repro_torch.policies import adapt_tuner
        k = cudac.PolicyKernel(adapt_tuner.program).build()
        reg = MapRegistry()
        maps = {}
        for d in k.prog.maps:
            m = reg.create(d.name, d.kind, key_size=d.key_size,
                           value_size=d.value_size,
                           max_entries=d.max_entries)
            maps[d.name] = torchc.map_to_array(m, dev)
        ctx = torch.zeros(k.n_fields, dtype=torch.int64, device=dev)
        ctx[0] = 7
        ret = torch.zeros(1, dtype=torch.int64, device=dev)
        e_ctx, e_ret = ctx.clone(), ret.clone()
        e_maps = {n: t.clone() for n, t in maps.items()}
        k.launch(e_ctx, e_ret, e_maps)
        torch.cuda.synchronize()
        e_ctx, e_ret = ctx.clone(), ret.clone()
        e_maps = {n: t.clone() for n, t in maps.items()}
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            k.launch(ctx, ret, maps)
        for _ in range(3):
            g.replay()
            k.launch(e_ctx, e_ret, e_maps)
        torch.cuda.synchronize()
        return {"equal": bool(torch.equal(ctx, e_ctx)
                              and torch.equal(ret, e_ret)
                              and all(torch.equal(maps[n], e_maps[n])
                                      for n in maps)),
                "launches": k.launches}
    guarded(rec, "policy_kernel_capture", kernel_capture)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "conditional_node_probe.json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
