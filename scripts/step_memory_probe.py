#!/usr/bin/env python3
"""Where a training step's memory goes on the card, beside the dry run's
prediction of it.

    python3 scripts/step_memory_probe.py

Needs a CUDA card.  Builds ``chip_smoke.py`` phase 13's trainer
(tinyllama-1.1b at full width, B 8 x S 2048, remat, bf16 activations,
f32 master; deterministic algorithms, no TF32, no reduced-precision bf16
reductions) and runs:

1. one warm step, then one step between ``reset_peak_memory_stats`` and
   ``max_memory_allocated``: the memory still allocated after a step
   beside the params and AdamW state (what a step leaves behind), and
   the step's peak;
2. one step under ``launch.roofline.TraceAnalyzer`` on the real tensors,
   which also reads the allocator around every ATen op: the allocator's
   peak, what the analyzer tracked at that op, and every op whose
   kernel allocated more than 64 MiB inside itself (the allocator's peak
   during the op above both its before and after; no dispatch mode sees
   these allocations, so the dry run cannot);
3. one step under ``FlopCounterMode`` beside the dry run of the same
   step on meta tensors (``launch.dryrun.lower_combo`` on a 1-rank fake
   group): FLOPs, and the predicted working set.

Prints one JSON record (also to ``chiprun_out/step_memory_probe.json``)
with the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
GiB = float(1 << 30)
INTERNAL_MIN = 64 << 20


def main() -> int:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("step_memory_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    from torch.utils.flop_counter import FlopCounterMode

    import chip_smoke as cs
    from repro_torch.collectives.dispatch import reset_dispatcher
    from repro_torch.launch.dryrun import lower_combo
    from repro_torch.launch.roofline import TraceAnalyzer
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.train import Trainer

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    reset_dispatcher(tier="jit")
    cfg, tcfg = cs.train_configs()
    tr = Trainer(cfg, cs.serve_axes(), None,
                 dataclasses.replace(tcfg, ckpt_dir=""), device=dev)
    tr.run(steps=1)
    torch.cuda.synchronize()
    state = sum(t.numel() * t.element_size() for t in tree_leaves(
        {"p": tr.params, "o": tr.opt_state}))
    after = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr.run(steps=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()

    class Probe(TraceAnalyzer):
        """The analyzer, reading the allocator around each op."""

        def __init__(self):
            super().__init__()
            self.internal: dict = {}
            self.top = (0, "", 0)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = super().__torch_dispatch__(func, types, args, kwargs)
            high = torch.cuda.max_memory_allocated()
            extra = high - max(before, torch.cuda.memory_allocated())
            if extra > INTERNAL_MIN:
                rec = self.internal.setdefault(str(func), [0, 0])
                rec[0] += 1
                rec[1] = max(rec[1], extra)
            if high > self.top[0]:
                self.top = (high, str(func),
                            self.live_bytes + self.arg_bytes)
            return out

    probe = Probe()
    probe.arguments((tr.params, tr.opt_state))
    with probe:
        tr.run(steps=1)
    torch.cuda.synchronize()
    with FlopCounterMode(display=False) as counter:
        tr.run(steps=1)
    dry = lower_combo(cs.TRAIN_ARCH, "train_4k", multi_pod=False,
                      mesh_shape=(1, 1), cfg=cfg,
                      global_batch=cs.TRAIN_BATCH, seq_len=cs.TRAIN_SEQ,
                      tier="jit")
    record = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__,
        "allocated_after_a_step_gib": after / GiB,
        "state_gib": state / GiB,
        "step_peak_gib": peak / GiB,
        "probe": {"allocator_peak_gib": probe.top[0] / GiB,
                  "at_op": probe.top[1],
                  "tracked_at_that_op_gib": probe.top[2] / GiB,
                  "tracked_peak_gib": (probe.peak_bytes + probe.arg_bytes)
                  / GiB,
                  "internal_temps_gib": {k: {"ops": n, "max": b / GiB}
                                         for k, (n, b) in
                                         probe.internal.items()}},
        "flops_counted": counter.get_total_flops(),
        "dry_run": {"flops": dry["trace_flops_per_dev"],
                    "working_set_gib": sum(dry["memory_analysis"].values())
                    / GiB,
                    "memory_analysis": dry["memory_analysis"],
                    "lower_s": dry["lower_s"]},
    }
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "step_memory_probe.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
