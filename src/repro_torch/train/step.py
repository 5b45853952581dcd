"""Sharded train step construction (the port of ``repro/train/step.py``).

There is no ``shard_map``: every rank runs ``local_step`` on its own
shards, and the step's collectives run over the process groups of
``MeshAxes`` (``model_group``, ``data_group``, ``pod_group``).  Gradient
synchronization is explicit and policy-dispatched:

  * FSDP-sharded params ('data' in spec): the backward of the forward
    all-gather is a reduce-scatter over 'data' — gradients arrive already
    sharded and reduced (ZeRO-3).
  * model-replicated leaves: explicit all-reduce over 'model' (each model
    rank holds a part of their gradient, ``models/layers.py``).
  * data/pod-replicated leaves: explicit all-reduce over 'data' / 'pod'.

All explicit all-reduces flow through the collective dispatcher — this
gradient sync is exactly the traffic class the paper's policies tune.
Two sync modes:

  bucketed=False — one all-reduce per parameter leaf (NCCL-default-like)
  bucketed=True  — leaves are flattened into a single fused bucket per
                   (axis, reduction) class before the collective (fewer,
                   larger messages — the classic gradient-bucketing win)

``jit``'s ``in_shardings`` is :func:`shard_tree` here (a global tree cut
to this rank's shards by its specs) and :func:`gather_tree` puts the
shards back together (checkpoints hold global tensors); ``donate_argnums``
becomes in-place updates of the parameter and optimizer tensors.

Two faults of the reference are not kept (ROADMAP C8): each rank's loss
is seeded with ``1/tp`` (the reference seeds 1 and returns ``tp`` times
the gradients), and the norm that clips the gradients is the whole
tree's (the reference's ``global_norm`` inside ``shard_map`` reads each
rank's shards only, so ranks clip by different factors).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..collectives.dispatch import dispatcher
from ..core.context import AxisKind
from ..models import loss_fn
from ..models.config import ModelConfig
from ..models.layers import MeshAxes, data_rank, model_rank, pod_rank
from ..models.transformer import tree_flatten, tree_leaves
from .optimizer import AdamWConfig, adamw_update, global_norm
from .schedule import cosine_schedule


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    opt: AdamWConfig = AdamWConfig()
    total_steps: int = 10_000
    warmup_steps: int = 100
    bucketed_grad_sync: bool = False


def _spec_axes(spec) -> set:
    out = set()
    for entry in spec:
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            out.update(entry)
        else:
            out.add(entry)
    return out


def _is_spec(v) -> bool:
    return isinstance(v, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in v)


def spec_leaves(specs) -> list:
    """The spec tuples of a spec tree, in the order of ``tree_flatten``
    on the matching tensor tree."""
    if _is_spec(specs):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    return [s for v in specs for s in spec_leaves(v)]


def _group(axis: str, ax: MeshAxes):
    return {ax.model: ax.model_group, ax.data: ax.data_group,
            ax.pod: ax.pod_group}[axis]


def _psum(x, axis: str, kind: int, ax: MeshAxes):
    return dispatcher().all_reduce(x, axis, group=_group(axis, ax),
                                   axis_kind=kind)


def sync_grads(grads, specs, ax: MeshAxes, *, bucketed: bool = False):
    """Reduce gradients per the sharding rules above."""
    flat_g, rebuild = tree_flatten(grads)
    flat_s = spec_leaves(specs)
    if len(flat_g) != len(flat_s):
        raise ValueError(f"{len(flat_g)} gradient leaves, {len(flat_s)} "
                         "specs")

    plan = []  # (needs_model, needs_data) per leaf
    for s in flat_s:
        axes = _spec_axes(s)
        plan.append(("model" not in axes and ax.tp > 1,
                     "data" not in axes and ax.dp > 1))

    if not bucketed:
        out = []
        for g, (nm, nd) in zip(flat_g, plan):
            if nm:
                g = _psum(g, ax.model, AxisKind.MODEL, ax)
            if nd:
                g = _psum(g, ax.data, AxisKind.DATA, ax)
            if ax.pod:
                g = _psum(g, ax.pod, AxisKind.POD, ax)
            out.append(g)
        flat_g = out
    else:
        # fuse same-class leaves into one flat bucket per collective
        for cls in [(True, False), (False, True), (True, True)]:
            idxs = [i for i, p in enumerate(plan) if p == cls]
            if not idxs:
                continue
            parts = [flat_g[i].reshape(-1).float() for i in idxs]
            sizes = [p.numel() for p in parts]
            bucket = torch.cat(parts)
            nm, nd = cls
            if nm:
                bucket = _psum(bucket, ax.model, AxisKind.MODEL, ax)
            if nd:
                bucket = _psum(bucket, ax.data, AxisKind.DATA, ax)
            off = 0
            for i, sz in zip(idxs, sizes):
                flat_g[i] = bucket[off:off + sz].reshape(
                    flat_g[i].shape).to(flat_g[i].dtype)
                off += sz
        if ax.pod:
            parts = [g.reshape(-1).float() for g in flat_g]
            sizes = [p.numel() for p in parts]
            bucket = _psum(torch.cat(parts), ax.pod, AxisKind.POD, ax)
            off = 0
            for i, sz in enumerate(sizes):
                flat_g[i] = bucket[off:off + sz].reshape(
                    flat_g[i].shape).to(flat_g[i].dtype)
                off += sz

    scale = 1.0 / (ax.dp * ax.n_pods)
    flat_g = [g * scale for g in flat_g]
    return rebuild(flat_g)


def batch_specs(cfg: ModelConfig, ax: MeshAxes, *, replicate_batch=False):
    dp_axes = None if replicate_batch else (
        (ax.pod, ax.data) if ax.pod else ax.data)
    s = {"tokens": (dp_axes, None), "labels": (dp_axes, None)}
    if cfg.family == "audio":
        s["frames"] = (dp_axes, None, None)
    if cfg.family == "vlm":
        s["patches"] = (dp_axes, None, None)
    return s


# ---------------------------------------------------------------------------
# global trees <-> this rank's shards
# ---------------------------------------------------------------------------

def _axis_pos(axis: str, ax: MeshAxes) -> Tuple[int, int]:
    """(this rank's index, the axis size)."""
    if axis == ax.model:
        return model_rank(ax), ax.tp
    if axis == ax.data:
        return data_rank(ax), ax.dp
    if axis == ax.pod:
        return pod_rank(ax), ax.n_pods
    raise ValueError(f"no mesh axis {axis!r}")


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _cut(t: torch.Tensor, spec, ax: MeshAxes) -> torch.Tensor:
    cut = False
    for dim, entry in enumerate(spec):
        idx, n = 0, 1
        for axis in _entry_axes(entry):
            i, size = _axis_pos(axis, ax)
            idx, n = idx * size + i, n * size
        if n > 1:
            part = t.shape[dim] // n
            t, cut = t.narrow(dim, idx * part, part), True
    return t.clone(memory_format=torch.contiguous_format) if cut else t


def shard_tree(tree, specs, ax: MeshAxes):
    """This rank's shards of a global tree: each dim whose spec names
    mesh axes split in equal parts, this rank's part kept (a copy)."""
    flat, rebuild = tree_flatten(tree)
    return rebuild([_cut(t, s, ax) for t, s in zip(flat, spec_leaves(specs))])


def _gather(t: torch.Tensor, spec, ax: MeshAxes) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        for axis in reversed(_entry_axes(entry)):
            _, n = _axis_pos(axis, ax)
            if n > 1:
                parts = [torch.empty_like(t) for _ in range(n)]
                dist.all_gather(parts, t.contiguous(),
                                group=_group(axis, ax))
                t = torch.cat(parts, dim=dim)
    return t


def gather_tree(tree, specs, ax: MeshAxes):
    """The global tree from every rank's shards (the inverse of
    :func:`shard_tree`; every rank of the mesh calls it)."""
    flat, rebuild = tree_flatten(tree)
    return rebuild([_gather(t, s, ax)
                    for t, s in zip(flat, spec_leaves(specs))])


def _norm_of_whole_tree(grads, flat_specs, ax: MeshAxes) -> torch.Tensor:
    """The f32 norm of the global gradient tree from this rank's shards:
    each leaf's sum of squares weighted by the share of the mesh that
    holds the same shard, summed over every axis."""
    if ax.world == 1:
        return global_norm(grads)
    sizes = {ax.model: ax.tp, ax.data: ax.dp}
    total = 0
    for g, s in zip(tree_leaves(grads), flat_specs):
        cut = int(np.prod([sizes.get(a, 1) for a in _spec_axes(s)]))
        total = total + torch.sum(torch.square(g.float())) * (cut / ax.world)
    total = total.detach()
    for n, group in ((ax.tp, ax.model_group), (ax.dp, ax.data_group),
                     (ax.n_pods, ax.pod_group)):
        if n > 1:
            dist.all_reduce(total, group=group)
    return torch.sqrt(total)


def _mean_over(x: torch.Tensor, n: int, group) -> torch.Tensor:
    if n > 1:
        x = x.clone()
        dist.all_reduce(x, group=group)
    return x / n


def loss_and_grads(params, batch, cfg: ModelConfig, ax: MeshAxes,
                   param_specs, *, bucketed: bool = False):
    """(loss, synchronised gradients) of this rank's shards on this
    rank's rows of the batch: autograd through the dispatched
    collectives, then :func:`sync_grads`."""
    flat_p, rebuild = tree_flatten(params)
    leaves = [p.detach().requires_grad_() for p in flat_p]
    loss = loss_fn(rebuild(leaves), batch, cfg, ax)
    # the loss is replicated over the model axis: 1/tp per rank sums to
    # the one seed of the tp=1 loss (models/layers.py)
    grads = torch.autograd.grad(
        loss, leaves, grad_outputs=torch.full_like(loss, 1.0 / ax.tp),
        allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat_p, grads)]
    return loss.detach(), sync_grads(rebuild(grads), param_specs, ax,
                                     bucketed=bucketed)


def local_batch(batch, cfg: ModelConfig, ax: MeshAxes, device):
    """This rank's rows of the global batch (numpy arrays or tensors),
    as tensors on ``device``."""
    bspecs = batch_specs(cfg, ax)
    return shard_tree({k: torch.as_tensor(v).to(device)
                       for k, v in batch.items()},
                      {k: bspecs[k] for k in batch}, ax)


def make_train_step(cfg: ModelConfig, ax: MeshAxes, mesh, param_specs,
                    step_cfg: TrainStepConfig) -> Tuple[Callable, dict]:
    """Returns (step, opt_spec_tree).

    step(params, opt_state, batch) -> (params, opt_state, metrics)

    ``params`` and ``opt_state`` are this rank's shards (``shard_tree``),
    updated in place and returned; ``batch`` is the global batch (numpy
    arrays or tensors), cut here to this rank's rows.  ``mesh`` is kept
    for the reference's signature: the axes' groups come from ``ax``
    (``launch.mesh.mesh_axes`` fills them from a mesh).  Metrics are
    f32 scalars, the loss averaged over the data and pod axes.
    """
    opt_specs = {"m": param_specs, "v": param_specs, "step": ()}
    flat_specs = spec_leaves(param_specs)

    def local_step(params, opt_state, batch):
        batch = local_batch(batch, cfg, ax, tree_leaves(params)[0].device)
        loss, grads = loss_and_grads(params, batch, cfg, ax, param_specs,
                                     bucketed=step_cfg.bucketed_grad_sync)
        lr_scale = cosine_schedule(opt_state["step"],
                                   step_cfg.total_steps,
                                   step_cfg.warmup_steps)
        gnorm = _norm_of_whole_tree(grads, flat_specs, ax)
        with torch.no_grad():
            new_p, new_o, metrics = adamw_update(
                params, grads, opt_state, step_cfg.opt, lr_scale,
                gnorm=gnorm)
            del grads
            for old, new in ((params, new_p), (opt_state["m"], new_o["m"]),
                             (opt_state["v"], new_o["v"])):
                for a, b in zip(tree_leaves(old), tree_leaves(new)):
                    a.copy_(b)
            opt_state["step"].copy_(new_o["step"])
        # metrics reduced to replicated scalars
        loss = _mean_over(loss, ax.dp, ax.data_group)
        if ax.pod:
            loss = _mean_over(loss, ax.n_pods, ax.pod_group)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return local_step, opt_specs
