"""Trainer loop: data -> step -> metrics -> checkpoint, with live policy
hot-reload (the paper's headline operational capability) and the
profiler-plugin closed loop (the port of ``repro/train/trainer.py``).

Hot-reload semantics (§T3): the trainer watches the policy runtime's
epoch, and an operator may reload a policy mid-run; the job itself never
restarts.  The reference decides at trace time, so an epoch bump makes it
retrace its step.  The port is eager: every collective calls
``decide()``, and the dispatcher's decision cache serves repeats within
an epoch, so the next step decides under the new policy by itself.  The
trainer still rebuilds its step on an epoch bump, as the reference does,
and counts the rebuilds (``Trainer.rebuilds``).

Each step's latency (host clock around the step, ending in a
synchronise) feeds the attached profiler chain: the §5.3 loop.
Checkpoints hold global tensors whatever the mesh, as the reference's do.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ..collectives.dispatch import dispatcher
from ..core.context import CollType
from ..data import DataConfig, make_dataset
from ..device import resolve_device
from ..models import init_params
from ..models.config import ModelConfig
from ..models.layers import MeshAxes
from ..models.transformer import tree_leaves
from ..obs import trace as _trace
from .checkpoint import latest_step, load_checkpoint, save_checkpoint
from .optimizer import adamw_init
from .step import TrainStepConfig, gather_tree, make_train_step, shard_tree


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0                 # 0 = disabled
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    step: TrainStepConfig = dataclasses.field(default_factory=TrainStepConfig)
    seed: int = 0


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (``jax.block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """``mesh`` may be ``None`` for one rank; the axes' process groups
    ride on ``ax``.  Runs on the card unless ``device`` names another."""

    def __init__(self, cfg: ModelConfig, ax: MeshAxes, mesh,
                 tcfg: TrainerConfig, *, device=None):
        self.cfg = cfg
        self.ax = ax
        self.mesh = mesh
        self.tcfg = tcfg
        self.device = resolve_device(device, "Trainer")
        self.metrics_log: List[Dict[str, float]] = []

        params, self.param_specs = init_params(tcfg.seed, cfg, ax,
                                               device=self.device)
        self.params = shard_tree(params, self.param_specs, ax)
        del params
        self.opt_state = adamw_init(self.params)
        self.rebuilds = 0
        self._build_step()
        self._policy_epoch = dispatcher().epoch
        self.step_idx = 0

    def _build_step(self):
        self._step_fn, self.opt_specs = make_train_step(
            self.cfg, self.ax, self.mesh, self.param_specs, self.tcfg.step)

    # -- checkpoint -----------------------------------------------------------
    def global_state(self) -> dict:
        """``{"p": params, "o": opt_state}`` as global tensors (every rank
        of the mesh calls it)."""
        return {"p": gather_tree(self.params, self.param_specs, self.ax),
                "o": gather_tree(self.opt_state, self.opt_specs, self.ax)}

    def maybe_restore(self) -> bool:
        st = latest_step(self.tcfg.ckpt_dir)
        if st is None:
            return False
        state, step, _ = load_checkpoint(self.tcfg.ckpt_dir,
                                         self.global_state())
        with torch.no_grad():
            for mine, specs, key in ((self.params, self.param_specs, "p"),
                                     (self.opt_state, self.opt_specs, "o")):
                local = shard_tree(state[key], specs, self.ax)
                _copy_tree(mine, local)
        self.step_idx = step
        return True

    def save(self):
        state = self.global_state()
        if not dist.is_initialized() or dist.get_rank() == 0:
            save_checkpoint(self.tcfg.ckpt_dir, self.step_idx, state,
                            extra={"arch": self.cfg.name})
        if dist.is_initialized() and self.ax.world > 1:
            dist.barrier()

    # -- main loop --------------------------------------------------------------
    def run(self, *, steps: Optional[int] = None) -> List[Dict[str, float]]:
        steps = steps or self.tcfg.steps
        data = make_dataset(self.cfg, self.tcfg.data,
                            start_step=self.step_idx)
        it = iter(data)
        disp = dispatcher()
        try:
            for _ in range(steps):
                # live policy hot-reload: epoch bump -> rebuild
                if disp.epoch != self._policy_epoch:
                    self._policy_epoch = disp.epoch
                    self._build_step()
                    self.rebuilds += 1

                # a span only while a torch.profiler session runs
                # (obs/trace.py), with the step's index
                with _trace.span(_trace.TRAINER_DATA_WAIT, self.step_idx):
                    batch = next(it)
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, batch)
                _sync(self.device)
                dt = time.perf_counter() - t0
                self.step_idx += 1

                # profiler plugin feed: step latency -> shared eBPF maps
                disp.profiler_feed(
                    comm_id=0, latency_ns=int(dt * 1e9),
                    coll=CollType.ALL_REDUCE, channels=0,
                    ts_ns=time.monotonic_ns())

                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = self.step_idx
                m["step_time_s"] = dt
                self.metrics_log.append(m)
                if self.step_idx % self.tcfg.log_every == 0:
                    print(f"step {self.step_idx:6d} loss {m['loss']:.4f} "
                          f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e} "
                          f"{dt * 1e3:.0f} ms", flush=True)
                if self.tcfg.ckpt_every and \
                        self.step_idx % self.tcfg.ckpt_every == 0:
                    self.save()
        finally:
            if hasattr(data, "stop"):
                data.stop()
        return self.metrics_log


def _copy_tree(dst, src) -> None:
    for a, b in zip(tree_leaves(dst), tree_leaves(src)):
        a.copy_(b.to(device=a.device, dtype=a.dtype))
