#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` (the sync-free in-graph step) alone.

    python3 scripts/phase15_alone.py [--root DIR]

Needs a CUDA card.  Builds the policy kernels of the checkout at
``--root`` (default: the one holding this script) and runs that
checkout's ``chip_smoke.sync_free_main_path``, so two commits can be
timed in turns in one process tree: unpack the other commit with
``git archive`` under ``build/`` and run this script once per root,
alternating.  Prints the phase's lines, then, last, one JSON record of
its replay times per tier beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TIMES = ("replay_host_p50_us", "replay_host_p99_us", "replay_device_us",
         "eager_step_us")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose chip_smoke.py and src/ run")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch
    if not torch.cuda.is_available():
        print("phase15_alone: torch sees no CUDA device", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from repro_torch.core import cudac
    from repro_torch.policies import ALL_POLICIES

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    kernels = cudac.build_all(cudac.PolicyKernel(p.program)
                              for p in ALL_POLICIES)
    lib = cs.timing_lib()
    _, rec = cs.sync_free_main_path(kernels, dev, lib,
                                    cs.empty_device_ms(lib), smi, {})
    out = {"root": root, "nvidia_smi": smi, "seconds": rec["seconds"],
           "tiers": {t: {k: r[k] for k in TIMES}
                     for t, r in rec["captured"].items()},
           "device_spellings": rec.get("device_spellings")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
