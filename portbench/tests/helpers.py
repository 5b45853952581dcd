"""Runs of the harness on the CPU: a cell at a size a test can hold, the
chip check skipped, the port on a host tier."""

import time

from portbench import harness

SMALL_TRAIN = {
    "model": {"num_hidden_layers": 2, "hidden_size": 256,
              "num_attention_heads": 4, "num_key_value_heads": 2,
              "head_dim": 64, "intermediate_size": 512, "vocab_size": 2048},
    "port_overrides": {"n_layers": 2, "d_model": 256, "n_heads": 4,
                       "n_kv_heads": 2, "head_dim": 64, "d_ff": 512,
                       "vocab": 2048},
    "batch": 2, "seq": 64, "window_steps": 2}
SEED = 2**31 + 977
# the cell left out of BENCHMARK.json (its rate spreads wider than any
# bound allows on the card, PERF.md): the tests still run the stateful
# decide loop, the one place the chain and the bridge run every decision
ADAPTIVE_DECIDE = "adaptive-loop.decide-loop"


def with_cells_left_out():
    """BENCHMARK.json with the left-out cell added to its metrics."""
    b = harness.load_bench()
    b["workloads"].append(
        {"name": ADAPTIVE_DECIDE, "config": "adaptive-loop",
         "traffic": "decide-loop", "chips": 1, "why": "tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "ring-mid-v2.decide-loop" in m.get("workloads", []):
            m["workloads"].append(ADAPTIVE_DECIDE)
    return b


def cpu_run(workload, *, seed=SEED, seconds=0.01, trace=False, tier="jit",
            sizes=None, fault=None, bench=None):
    return harness.run(harness.RunArgs(
        workload, seed, seconds, trace, time.perf_counter(), device="cpu",
        tier=tier, sizes=sizes or {"max_blocks": 1}, fault=fault),
        bench=bench if bench is not None else with_cells_left_out())
