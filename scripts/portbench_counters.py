#!/usr/bin/env python3
"""One benchmark run, then the port's trace counters of its traced window.

    python3 <this script> --workload <cell> --seed <n> --seconds <s> --trace 1

Runs ``portbench.harness.main`` of the checkout in the working directory
(another commit's checkout too: its ``portbench/`` and ``src/`` are the
ones imported) in this process, so that after the run the newest
``torch.profiler`` session's counters are still in
``repro_torch.obs.trace``: the result line goes to stdout as
``portbench/run.py`` prints it, then one ``COUNTERS`` line to stderr
with each counter's total (``array`` for a sum kept on the device) and
additions, None where nothing was counted or the checkout's port lacks
the counter.  With ``--trace 0`` no session runs and every counter is
None.  Needs the cell's cards, as ``portbench/run.py`` does.
"""

import os
import sys
import time

T0 = time.perf_counter()


def main() -> int:
    root = os.getcwd()
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(root, "src"))
    from portbench import harness
    harness.cache_dirs()
    rc = harness.main(sys.argv[1:], T0)
    from repro_torch.obs import trace
    out = {}
    for name in trace.COUNTERS:
        c = trace.counter(name)
        out[name] = None if c is None else (
            c["total"] if isinstance(c["total"], int) else "array",
            c["additions"])
    print("COUNTERS", out, file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
