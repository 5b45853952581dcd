#!/usr/bin/env python3
"""Readings that set the limits of ``correct``: the program's numbers over
many seeds, the control's (the plain reference in the nearest precision
below the configuration's, or breaking the guarantee it states), and the
faults', at the cell's own size on the card.  The benchmark's own runs
never run this.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--what program,control,frozen_step,half_batch] [--decisions N]

One JSON line per seed and reading on standard output.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "src"))


def decide_cell(cell, seeds, n):
    """The control's mismatches against the reference over ``n`` steps."""
    from portbench.runners import decide_loop as dl
    for seed in seeds:
        dec, maps = dl.control_run(cell.config, cell.mix, seed, n)
        got = dl.compare(cell.config, cell.mix, seed, dec, maps)
        yield {"seed": seed, "what": "control", "steps": n,
               **{c.name: c.value for c in got}}


def train_cell(cell, seeds, what, dev="cuda"):
    import dataclasses
    import torch
    from portbench import deploy, faults, weights
    from portbench.runners import train as drv
    from portbench.reference import qwen3 as ref_q
    from repro_torch.data import DataConfig
    from repro_torch.models.layers import MeshAxes
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train import (AdamWConfig, Trainer, TrainerConfig,
                                   TrainStepConfig)
    mix, model = cell.mix, cell.model
    B, S = mix["batch"], mix["seq"]
    cfg = drv.port_config(model, {})
    n = int(mix["checked_steps"])
    tcfg = TrainerConfig(
        steps=n, log_every=10 ** 9, ckpt_every=0, seed=0,
        ckpt_dir=os.path.join(ROOT, "build", "portbench", "ckpt"),
        data=DataConfig(seq_len=S, global_batch=B),
        step=TrainStepConfig(opt=AdamWConfig(**mix["opt"]),
                             total_steps=int(mix["total_steps"]),
                             warmup_steps=int(mix["warmup_steps"])))
    rt, disp = deploy.build(cell.config)
    feeds = drv.DecidingFeed(disp, mix, int(cell.config["n_ranks"]))
    tr = Trainer(cfg, MeshAxes(dp=1, tp=1), None, tcfg, device=dev)

    def program(seed, fault=None):
        tr.tcfg.data = dataclasses.replace(tr.tcfg.data,
                                           seed=drv.data_seed(seed))
        tr.step_idx, tr.metrics_log = 0, []
        feeds.events.clear()
        with torch.no_grad():
            for t in tree_leaves(tr.opt_state):
                t.zero_()
        weights.fill(tree_leaves(tr.params), model, seed, dev)
        prog = drv.checked_steps(tr, feeds, model, seed, dev, n, mix)
        with faults.planted(fault):
            tr.run(steps=n)
        return drv.losses(tr, prog, n)

    for seed in seeds:
        t0 = time.time()
        ref = drv.reference_readings(model, mix, seed, B, S, dev)
        t_ref = time.time() - t0
        for w in what:
            if w == "control":
                got = drv.reference_readings(model, mix, seed, B, S, dev,
                                             quantize=True)
            else:
                got = program(seed, None if w == "program" else w)
            yield {"seed": seed, "what": w, "ref_s": t_ref,
                   **ref_q.gaps(got, ref), "losses": got["losses"],
                   "ref_losses": ref["losses"], "leaves": ref["names"],
                   "grad_norms": got["grad_norms"],
                   "ref_grad_norms": ref["grad_norms"],
                   "change_norms": got["change_norms"],
                   "ref_change_norms": ref["change_norms"]}
            if dev == "cuda":
                torch.cuda.empty_cache()


def main(argv):
    import argparse
    import json
    from portbench import harness
    harness.cache_dirs()
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="program,control")
    p.add_argument("--decisions", type=int, default=60000)
    a = p.parse_args(argv)
    cell = harness.find_cell(harness.load_bench(), a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    kind = cell.mix["kind"]
    if kind == "decide_loop":
        rows = decide_cell(cell, seeds, a.decisions)
    else:
        rows = train_cell(cell, seeds, a.what.split(","))
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
