"""AdamW, from scratch (the port of ``repro/train/optimizer.py``).

Plain tensor ops in the reference's order: the clip comes from the f32
global norm of every gradient leaf, the bias corrections from an f32
step, the update runs in f32 with the decay inside ``delta`` and is cast
back to each parameter's dtype.  ``torch.optim.AdamW`` folds the bias
corrections into the step size instead, which moves the result by more
than the reference's rounding.  The state keeps the reference's keys
(``m``, ``v``, and ``step`` as an int32 scalar), so checkpoints
interchange.

Optimizer state lives with the same sharding as the parameters (the m/v
moments are cut like each parameter), so sharded training costs 3x
parameter memory per shard, not per replica.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from ..models.transformer import tree_flatten, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params) -> dict:
    some = tree_leaves(params)[0]
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=some.device),
    }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0, *,
                 gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, dict, dict]:
    """Returns (new_params, new_state, metrics).  ``gnorm`` replaces
    ``global_norm(grads)`` where the gradients are this rank's shards of
    a larger tree (``step.py`` passes the norm of the whole tree)."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    t = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)

    def upd(p, g, m, v):
        g = g.float() * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    flat_p, rebuild = tree_flatten(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(state["m"])
    flat_v = tree_leaves(state["v"])
    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = rebuild([o[0] for o in out])
    new_m = rebuild([o[1] for o in out])
    new_v = rebuild([o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr.float()}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
