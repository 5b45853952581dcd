"""End-to-end training driver example on the PyTorch port: train a
TinyLlama-family model for a few hundred steps with a verified policy
governing the gradient-sync collectives, including a mid-run hot-reload
(``examples/train_lm.py`` on the JAX package).

    PYTHONPATH=src python examples/train_lm_torch.py          # the card
    PYTHONPATH=src python examples/train_lm_torch.py --cpu    # CPU

The policies run on the CUDA policy kernel (``tier="cuda"``) and the
model on the card, unless ``--cpu`` asks for both on the host (the
policies' plain PyTorch version, ``tier="torch"``).  ``size_aware`` is
loaded first and hot-reloaded to ``ring_mid_v2`` half-way through; the
trainer rebuilds its step once and loses no step.
"""

import argparse

import numpy as np

from repro_torch.collectives.dispatch import reset_dispatcher
from repro_torch.configs import get_config
from repro_torch.core.runtime import PolicyRuntime
from repro_torch.data import DataConfig
from repro_torch.models.layers import MeshAxes
from repro_torch.policies import ring_mid_v2, size_aware
from repro_torch.train import (AdamWConfig, Trainer, TrainerConfig,
                               TrainStepConfig)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU with the policies' plain "
                         "PyTorch version (tier torch)")
    args = ap.parse_args(argv)
    device, tier = ("cpu", "torch") if args.cpu else (None, "cuda")

    cfg = get_config("tinyllama-1.1b").with_overrides(
        name="tinyllama-custom", n_layers=args.layers,
        d_model=args.d_model, n_heads=max(args.d_model // 64, 1),
        n_kv_heads=max(args.d_model // 128, 1),
        d_ff=args.d_model * 3, vocab=args.vocab)
    n_params = cfg.param_count()
    print(f"model: {n_params / 1e6:.1f}M params, {args.steps} steps")

    rt = PolicyRuntime(tier=tier)
    rt.load(size_aware.program)
    reset_dispatcher(runtime=rt)

    tr = Trainer(cfg, MeshAxes(tp=1, dp=1, fsdp=False), None,
                 TrainerConfig(
                     steps=args.steps, log_every=20,
                     data=DataConfig(seq_len=args.seq,
                                     global_batch=args.batch),
                     step=TrainStepConfig(
                         opt=AdamWConfig(lr=1e-3),
                         total_steps=args.steps,
                         warmup_steps=args.steps // 10)),
                 device=device)

    half = args.steps // 2
    tr.run(steps=half)
    print(f"== hot-reloading policy at step {half} (job keeps running)")
    rt.reload(ring_mid_v2.program)
    # run() returns the trainer's whole log, both halves
    log = tr.run(steps=args.steps - half)

    losses = [m["loss"] for m in log]
    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first else 'NOT LEARNING'})")
    print(f"policy reloads survived: {rt.stats.reloads}, "
          f"0 lost steps, {tr.step_idx} total steps on {tr.device}")
    return {"steps": tr.step_idx, "losses": losses,
            "reloads": rt.stats.reloads, "rebuilds": tr.rebuilds}


if __name__ == "__main__":
    main()
