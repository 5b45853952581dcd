#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits 2, printing no result, without the cards the cell asks for, without
the port's package beside the harness, or when the run has loaded JAX or
the JAX package.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "src"))

if __name__ == "__main__":
    from portbench import harness
    harness.cache_dirs()
    sys.exit(harness.main(sys.argv[1:], T_START))
