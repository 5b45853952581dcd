#!/usr/bin/env python3
"""Phase 5's closed loop of ``chip_smoke.py`` alone, for ``decide()``'s
latency.

    python3 scripts/decide_alone.py [--root DIR] [--n N]

Needs a CUDA card.  Runs the checkout at ``--root`` (default: the one
holding this script): its ``chip_smoke.closed_loop`` on ``cuda`` and
then on ``interp`` (the host's own speed, no kernel), ``--n`` decisions
each, so two commits can be timed in turns on one card: unpack the
other commit with ``git archive`` under ``build/`` and run this script
once per root, alternating.  Prints, last, one JSON record of
``decide()``'s p50 and p99 per tier beside the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose chip_smoke.py and src/ run")
    ap.add_argument("--n", type=int, default=10_000)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    if not torch.cuda.is_available():
        print("decide_alone: torch sees no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs

    torch.cuda.set_device(torch.device("cuda", 0))
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    out = {"root": root, "nvidia_smi": smi, "n": args.n}
    for tier in ("cuda", "interp"):
        run = cs.closed_loop(tier, args.n)
        out[tier] = {"p50_us": cs.pct(run["times_ns"], 50) / 1e3,
                     "p99_us": cs.pct(run["times_ns"], 99) / 1e3}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
