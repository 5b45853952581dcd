"""Training driver (the port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 200 --seq 256 --batch 8 --smoke [--policy ring_mid_v2]

Trains on the card, with the policies on the CUDA policy kernel
(``tier="cuda"``), unless ``--device cpu`` asks for the CPU (the policies
then run their plain PyTorch version, ``tier="torch"``).  ``--smoke``
takes the reduced config on one rank.  Without it, start one process per
card of the production mesh (``torchrun``, 256 ranks; the process group
must exist, see ``launch.mesh.make_production_mesh``), with the full
config and ``remat``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..collectives.dispatch import reset_dispatcher
from ..configs import get_config, get_smoke_config
from ..core.runtime import PolicyRuntime
from ..data import DataConfig
from ..models.layers import MeshAxes
from ..train import AdamWConfig, Trainer, TrainerConfig, TrainStepConfig
from .mesh import make_production_mesh, mesh_axes


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--policy", default="none")
    ap.add_argument("--bucketed", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    on_cpu = args.device is not None and args.device.startswith("cpu")
    rt = PolicyRuntime(tier="torch" if on_cpu else "cuda")
    if args.policy != "none":
        import repro_torch.policies as pol
        rt.load(getattr(pol, args.policy).program)
        print(f"loaded verified policy: {args.policy}")
    reset_dispatcher(runtime=rt)

    if args.smoke:
        cfg = get_smoke_config(args.arch)
        mesh = None
        ax = MeshAxes(tp=1, dp=1, fsdp=False)
    else:
        cfg = get_config(args.arch).with_overrides(remat=True)
        mesh = make_production_mesh(
            device_type="cpu" if on_cpu else "cuda")
        ax = mesh_axes(mesh, fsdp=True)

    tcfg = TrainerConfig(
        steps=args.steps, log_every=10,
        ckpt_dir=args.ckpt_dir or os.path.join(
            tempfile.gettempdir(), f"repro_ckpt_{args.arch}"),
        ckpt_every=args.ckpt_every,
        data=DataConfig(seq_len=args.seq, global_batch=args.batch),
        step=TrainStepConfig(opt=AdamWConfig(lr=args.lr),
                             total_steps=args.steps, warmup_steps=max(
                                 args.steps // 20, 5),
                             bucketed_grad_sync=args.bucketed))
    tr = Trainer(cfg, ax, mesh, tcfg, device=args.device)
    if args.ckpt_every and tr.maybe_restore():
        print(f"restored from step {tr.step_idx}")
    log = tr.run()
    print(f"final loss {log[-1]['loss']:.4f} over {len(log)} steps; "
          f"mean step {np.mean([m['step_time_s'] for m in log[2:]]):.3f}s")
    return log


if __name__ == "__main__":
    main()
