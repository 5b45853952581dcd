#!/usr/bin/env python3
"""How long nvcc takes to build the policy kernel of a loop, by design.

    python3 scripts/loop_build_probe.py [--timeout S]

Needs ``nvcc`` (no card).  For the loop programs of
``tests/torch_samples.py`` (``loop_chain_goldens``: 65-step division
chains through a map cell, a stack slot and a register, a multiply chain
through a stack slot; the pair golden ``inloop_ema``) and the shipped
loop policies, builds each program's translation unit three ways, one
``nvcc`` each, all in parallel, each cut at ``--timeout`` seconds:

* ``rule``: the shipped source (``#pragma unroll 1`` on a loop whose
  body stores through a ctx or map pointer or calls a map-writing
  helper or a callee; every other loop left to nvcc);
* ``unrolled``: the shipped source without any pragma (nvcc's choice
  on every loop, over the register frame);
* ``earlier``: the kernel before the register frame (route ``memory``,
  one thread), without any pragma.

Prints one line a program (seconds a build, ``cut`` where the time ran
out), then one JSON record (also ``chiprun_out/loop_build_probe.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOOP_POLICIES = ("latency_argmin_tuner", "histogram_bucket_tuner")


def _unpragma(src):
    return dataclasses.replace(src, body=src.body.replace(
        "#pragma unroll 1\n", ""))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--timeout", type=float, default=180.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]

    import repro_torch.core as C
    import torch_samples as samples
    from repro_torch.core import cudac
    from repro_torch.core.verifier import verify_with_info
    from repro_torch.device import nvcc_path
    from repro_torch.policies import ALL_POLICIES

    nvcc = nvcc_path()
    if nvcc is None:
        print("loop_build_probe: no nvcc", file=sys.stderr)
        return 2
    progs = [g.program(C) for g in samples.loop_chain_goldens()]
    progs += [g.program(C) for g in samples.pair_goldens()
              if g.id.startswith("inloop_ema")][:1]
    progs += [p.program for p in ALL_POLICIES
              if p.program.name in LOOP_POLICIES]
    jobs = []
    for prog in progs:
        vinfo = verify_with_info(prog)
        rule = cudac.emit_source(prog, vinfo)
        jobs += [(prog.name, "rule", rule.full),
                 (prog.name, "unrolled", _unpragma(rule).full),
                 (prog.name, "earlier", _unpragma(cudac.emit_source(
                     prog, vinfo, route="memory", one_thread=True)).full)]
    work = tempfile.mkdtemp(prefix="loop_build_", dir=os.path.join(
        ROOT, "chiprun_out") if os.path.isdir(os.path.join(
            ROOT, "chiprun_out")) else None)

    def build(job):
        name, variant, src = job
        cu = os.path.join(work, f"{name}_{variant}.cu")
        with open(cu, "w") as f:
            f.write(src)
        t0 = time.time()
        try:
            r = subprocess.run([nvcc, *cudac.NVCC_FLAGS, "-o", cu[:-3] + ".so",
                                cu], capture_output=True,
                               timeout=args.timeout)
        except subprocess.TimeoutExpired:
            return None
        finally:
            for ext in (".cu", ".so"):
                if os.path.exists(cu[:-3] + ext):
                    os.unlink(cu[:-3] + ext)
        if r.returncode != 0:
            raise RuntimeError(f"{name} {variant}: nvcc failed: "
                               f"{r.stderr.decode(errors='replace')[:2000]}")
        return time.time() - t0

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as ex:
        secs = list(ex.map(build, jobs))
    os.rmdir(work)
    rec = {}
    for (name, variant, _), t in zip(jobs, secs):
        rec.setdefault(name, {})[variant] = t
    for name, row in rec.items():
        print(f"[loop build] {name}: " + ", ".join(
            f"{v} {'cut' if t is None else f'{t:.1f} s'}"
            for v, t in row.items()), flush=True)
    out = {"timeout_s": args.timeout, "cpus": os.cpu_count(),
           "seconds": rec}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "loop_build_probe.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
