#!/usr/bin/env python3
"""The policy kernel's designs side by side on the card (B1, B2).

    python3 scripts/policy_kernel_probe.py [--reps N]

Needs a CUDA card.  Builds every shipped policy in each design below
(one library a design, every program under its own prefix), holds each
build bit for bit to the plain version and the interpreter on phase 3's
seeded samples (``chip_smoke.differential``), prints each entry's
``cudaFuncGetAttributes`` (local bytes, registers, shared bytes), and
times B1 of every program in every design on phase 3's state, the
designs of one program in turn, ``--reps`` rounds (the order reversed
every other round).  B2 is timed for ``shipped`` and ``earlier``.

Designs (``cudac.emit_source`` options, or the shipped source edited
here):

* ``earlier``: the memory frame, thread 0 alone — the kernel before the
  Hopper redesign (``<<<1,1>>>``);
* ``shipped``: the defaults (the register frame, a warp for a program
  with a scanned map, one thread otherwise);
* ``one_thread`` / ``warp``: every program on one thread / warp-uniform;
* ``unroll1``, ``unroll16``: every loop given ``#pragma unroll N``.

Other designs measured with this script in earlier states of the
emitter (staging the ctx and maps in shared memory, by several rules and
two copies) are named in PERF.md beside their numbers.

Also the empty launch, ``<<<1,1>>>`` and on one warp.  Prints one line
a program, then the card's name and power limit, then one JSON record
(also ``chiprun_out/policy_kernel_probe.json``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DESIGNS = {
    "earlier": {"route": "memory", "one_thread": True},
    "shipped": {},
    "one_thread": {"one_thread": True},
    "warp": {},
    "unroll1": {},
    "unroll16": {},
}


def edited(name: str, src):
    """The shipped source as design ``name`` runs it."""
    if name == "warp" and src.threads == 1:
        return dataclasses.replace(
            src, header=src.header.replace("#define BPF_WARP 0\n", "", 1),
            launchers=src.launchers.replace("<<<1, 1, 0,", "<<<1, 32, 0,"),
            threads=32)
    if name.startswith("unroll"):
        body = re.sub(r"^(\s*)while \(1\) \{",
                      rf"#pragma unroll {name[6:]}\n\1while (1) {{",
                      src.body.replace("#pragma unroll 1\n", ""),
                      flags=re.M)
        return dataclasses.replace(src, body=body)
    return src

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src"),
                    os.path.join(ROOT, "tests")]
    import torch
    if not torch.cuda.is_available():
        print("policy_kernel_probe: torch sees no CUDA device",
              file=sys.stderr)
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
    progs = [p.program for p in ALL_POLICIES]

    def bundle(d: int, name: str) -> list:
        ks = [cudac.PolicyKernel(p, prefix=f"d{d}p{i}_", **DESIGNS[name])
              for i, p in enumerate(progs)]
        for k in ks:
            k.source = edited(name, k.source)
        if name == "shipped":
            return cudac.build_all(ks)      # as the port builds them
        return cudac.build_bundle(ks)

    from concurrent.futures import ThreadPoolExecutor
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(DESIGNS)) as ex:
        built = dict(zip(DESIGNS, ex.map(lambda a: bundle(*a),
                                         enumerate(DESIGNS))))
    build_s = time.time() - t0
    lib = cs.timing_lib()
    empty = {"1x1": cs.empty_device_ms(lib), "warp": cs.empty_warp_ms(lib)}
    print(f"[probe] {len(DESIGNS)} designs x {len(progs)} programs built in "
          f"{build_s:.1f} s; empty launch ms: " + ", ".join(
              f"{k} {v:.6f}" for k, v in empty.items()), flush=True)

    rec = {"nvidia_smi": smi, "build_s": build_s, "empty_ms": empty,
           "programs": {}}
    for i, prog in enumerate(progs):
        row = {"attrs": {}, "err": {}, "us": {}, "us32": {}}
        for name in DESIGNS:
            k = built[name][i]
            row["attrs"][name] = k.attributes()
            row["err"][name] = cs.differential(k, dev, seed=100 + i)[
                "max_abs_err"]
            if k.pairs:
                row["err"][name] = max(row["err"][name], cs.differential(
                    k, dev, seed=200 + i, pairs=True)["max_abs_err"])
        row["routes"] = list(built["shipped"][i].source.routes)
        for pairs in (False, True):
            if pairs and not built["shipped"][i].pairs:
                continue
            names = ["shipped", "earlier"] if pairs else list(DESIGNS)
            seed = 200 + i if pairs else 100 + i
            times = {n: [] for n in names}
            for r in range(args.reps):
                for name in (names if r % 2 == 0 else names[::-1]):
                    k = built[name][i]
                    ctx, maps = cs.phase3_state(k, dev, seed, pairs)
                    ret = torch.zeros(2 if pairs else 1, dtype=torch.int32
                                      if pairs else torch.int64, device=dev)
                    launch = k.launch32 if pairs else k.launch
                    times[name].append(1e3 * cs.device_ms(
                        lib, lambda: launch(ctx, ret, maps)))
            row["us32" if pairs else "us"] = {
                n: min(v) for n, v in times.items()}
        rec["programs"][prog.name] = row
        a = row["attrs"]
        print(f"[probe] {prog.name}: routes {','.join(row['routes'])}; "
              "B1 us " + " ".join(
                  f"{n} {v:.3f}" for n, v in row["us"].items())
              + ("; B2 us " + " ".join(f"{n} {v:.3f}" for n, v in
                                       row["us32"].items())
                 if row["us32"] else "")
              + "; local/regs/smem " + " ".join(
                  f"{n} {a[n]['kernel']['local_bytes']}/"
                  f"{a[n]['kernel']['registers']}/"
                  f"{a[n]['kernel']['shared_bytes']}"
                  for n in DESIGNS)
              + f"; max abs err {max(row['err'].values())}", flush=True)
    bad = {p: r["err"] for p, r in rec["programs"].items()
           if any(r["err"].values())}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "policy_kernel_probe.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    print(smi)
    print(json.dumps({"bit_exact": not bad, "disagree": bad,
                      "empty_ms": empty}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
