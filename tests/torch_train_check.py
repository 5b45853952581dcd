"""Shared half of ``tests/test_torch_train_mesh.py`` (and of the ``dp = 2``
leg of ``chip_smoke.py`` phase 13): the port's train step on spawned
``gloo`` ranks, and the reference's on a host mesh.

Every run starts from the reference's ``init_params`` tree for the
``tinyllama-1.1b`` smoke config in f32 (``PRNGKey(0)``) and takes
``N_STEPS`` steps on numpy-seeded global batches.

- :func:`reference_main` (``python tests/torch_train_check.py OUT``, with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` in its
  environment only) runs the reference: its ``make_train_step`` on a
  1-device mesh (the math, with the default clip and with the clip off),
  on a ``dp = 2`` FSDP mesh with the clip off (with and without the bf16
  wire), and its synchronised gradients at ``tp = 1``, ``tp = 2`` and
  ``tp = 2 x dp = 2``; all into one ``.npz``.
- :func:`rank_main` runs the port's jobs on one rank of a ``gloo`` group
  and returns global tensors (gathered from the shards) to the parent.

The port is held to the math; the reference's ``tp = 2`` gradients are
``tp`` times it and its ``dp = 2`` clip reads each rank's shards only
(ROADMAP C8), which the tests name.  With the clip off (``grad_clip``
1e9) the reference's ``dp = 2`` step is the math again, and the port is
also held to it there.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ARCH = "tinyllama-1.1b"
B, S = 4, 16
N_STEPS = 3
STEP_CFG = dict(total_steps=10, warmup_steps=2)
NO_CLIP = 1e9


def batches(vocab: int, n: int = N_STEPS) -> list:
    rng = np.random.RandomState(17)
    out = []
    for _ in range(n):
        toks = rng.randint(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def flat_keys(tree, prefix=""):
    """(path, leaf) pairs in ``jax.tree`` order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_keys(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flat_keys(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# the reference (JAX), in its own process
# ---------------------------------------------------------------------------

def reference_weights():
    """The reference's f32 smoke config and its ``init_params`` tree."""
    import jax

    import repro.models as R
    from repro.configs import get_smoke_config
    from repro.models.layers import MeshAxes

    cfg = get_smoke_config(ARCH).with_overrides(dtype="float32")
    params, _ = R.init_params(jax.random.PRNGKey(0), cfg,
                              MeshAxes(tp=1, dp=1, fsdp=False))
    return cfg, jax.tree.map(np.asarray, params)


def reference_main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.models as R
    from repro.collectives.dispatch import reset_dispatcher
    from repro.compat import shard_map
    from repro.core.runtime import PolicyRuntime
    from repro.models.layers import MeshAxes
    from repro.train import TrainStepConfig, make_train_step
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro.train.step import batch_specs, sync_grads

    reset_dispatcher(runtime=PolicyRuntime())
    cfg, w0 = reference_weights()
    data = [{k: jnp.asarray(v) for k, v in b.items()}
            for b in batches(cfg.vocab)]
    out = {}

    def mesh_of(dp, tp):
        return Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                    ("data", "model"))

    def train(name, ax, dp, tp, clip):
        _, specs = R.init_params(jax.random.PRNGKey(0), cfg, ax)
        step, _ = make_train_step(
            cfg, ax, mesh_of(dp, tp), specs,
            TrainStepConfig(opt=AdamWConfig(grad_clip=clip), **STEP_CFG))
        params = jax.tree.map(jnp.asarray, w0)
        opt = adamw_init(params)
        for i, b in enumerate(data):
            params, opt, m = step(params, opt, b)
            for k, v in m.items():
                out[f"{name}/metrics/{i}/{k}"] = np.asarray(v)
        for part, tree in (("params", params), ("m", opt["m"]),
                           ("v", opt["v"])):
            for path, leaf in flat_keys(tree):
                out[f"{name}/{part}{path}"] = np.asarray(leaf)

    train("math", MeshAxes(tp=1, dp=1, fsdp=False), 1, 1, 1.0)
    train("math_noclip", MeshAxes(tp=1, dp=1, fsdp=False), 1, 1, NO_CLIP)
    for bf16 in (False, True):
        train(f"dp2_noclip_bf16{int(bf16)}",
              MeshAxes(tp=1, dp=2, fsdp=True, gather_bf16=bf16), 2, 1,
              NO_CLIP)

    def grads(name, ax, dp, tp):
        _, specs = R.init_params(jax.random.PRNGKey(0), cfg, ax)

        def local(p, b):
            g = jax.grad(lambda p: R.loss_fn(p, b, cfg, ax))(p)
            return sync_grads(g, specs, ax)

        sm = shard_map(local, mesh=mesh_of(dp, tp),
                       in_specs=(specs, batch_specs(cfg, ax)),
                       out_specs=specs, check_vma=False)
        g = jax.jit(sm)(jax.tree.map(jnp.asarray, w0), data[0])
        for path, leaf in flat_keys(g):
            out[f"{name}/grads{path}"] = np.asarray(leaf)

    grads("tp1", MeshAxes(tp=1, dp=1, fsdp=False), 1, 1)
    grads("tp2", MeshAxes(tp=2, dp=1, fsdp=False), 1, 2)
    grads("tp2dp2", MeshAxes(tp=2, dp=2, fsdp=True), 2, 2)
    np.savez(out_path, **out)


def reference_tree(ref: dict, prefix: str) -> dict:
    """``{path: array}`` of one run's leaves in the reference's file."""
    prefix = prefix.rstrip("/") + "/"
    return {k[len(prefix) - 1:]: v for k, v in ref.items()
            if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# the port, one rank of a gloo group
# ---------------------------------------------------------------------------

def rank_main(rank: int, world: int, port: int, q, jobs, w0) -> None:
    try:
        q.put((rank, _rank_body(rank, world, port, jobs, w0)))
    except Exception:       # reported to the parent, which fails the test
        import traceback
        q.put((rank, {"error": traceback.format_exc()}))


def _rank_body(rank: int, world: int, port: int, jobs, w0) -> dict:
    import datetime

    import torch
    import torch.distributed as dist

    # smoke-size steps: one intra-op thread per rank, so the ranks do not
    # wait on each other's threads for the host's cores
    torch.set_num_threads(1)

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        return {job["name"]: run_job(job, w0) for job in jobs}
    finally:
        dist.destroy_process_group()


def mesh_and_axes(dp: int, tp: int, **kw):
    """A ``(dp, tp)`` ``DeviceMesh`` over the group's ranks and its axes
    (no mesh, and no process group needed, for one rank)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models.layers import MeshAxes

    if dp * tp == 1:
        return None, MeshAxes(tp=1, dp=1, **kw)
    mesh = DeviceMesh("cpu", torch.arange(dp * tp).reshape(dp, tp),
                      mesh_dim_names=("data", "model"))
    return mesh, mesh_axes(mesh, **kw)


class AlgoLog:
    """Records the algorithm each dispatched collective ran (the outermost
    call only), by wrapping the functions of ``collectives.algorithms``
    that the dispatcher's emit table looks up at call time."""

    NAMES = ("allreduce_native", "allreduce_ring", "allreduce_tree",
             "allreduce_bidir_ring", "reduce_scatter_native",
             "reduce_scatter_ring", "all_gather_native", "all_gather_ring",
             "all_to_all_native", "all_to_all_chunked")

    def __init__(self):
        from repro_torch.collectives import algorithms as alg
        self.alg, self.ran, self.saved, self.depth = alg, [], {}, 0

    def __enter__(self):
        for n in self.NAMES:
            fn = getattr(self.alg, n)
            self.saved[n] = fn

            def wrapped(*a, _fn=fn, _n=n, **kw):
                if self.depth == 0:
                    self.ran.append(_n)
                self.depth += 1
                try:
                    return _fn(*a, **kw)
                finally:
                    self.depth -= 1
            setattr(self.alg, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.alg, n, fn)


def expected_algos(decisions) -> list:
    """The algorithm function each ``Decision`` names (the emit table)."""
    from repro_torch.collectives.dispatch import _algo_fn
    return [_algo_fn(d.coll, d.algo).__name__ for d in decisions]


def run_job(job: dict, w0) -> dict:
    """One job on this rank: ``kind`` "train" (``N_STEPS`` steps of
    ``make_train_step``; metrics, global params / m / v, the decisions
    against the algorithms that ran, the decision cache's counts and, on
    ``tier="cuda"``, the policy kernel's launches), "grads" (the
    synchronised gradients of batch 0, global) or "remat" (model-axis
    collectives issued by the backward under each remat variant, and the
    gradients)."""
    import torch

    from repro_torch.collectives.dispatch import reset_dispatcher
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.runtime import PolicyRuntime
    from repro_torch.models import init_params
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.transformer import tree_flatten
    from repro_torch.train import AdamWConfig, TrainStepConfig
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import (gather_tree, local_batch,
                                        loss_and_grads, make_train_step,
                                        shard_tree)
    import repro_torch.policies as pol

    rt = PolicyRuntime(tier=job.get("tier", "torch"))
    if job.get("policy"):
        rt.load(getattr(pol, job["policy"]).program)
    disp = reset_dispatcher(runtime=rt)
    cfg = get_smoke_config(ARCH).with_overrides(dtype="float32",
                                                **job.get("cfg", {}))
    mesh, ax = mesh_and_axes(job["dp"], job["tp"], fsdp=job["fsdp"],
                             gather_bf16=job.get("bf16", False))
    _, specs = init_params(0, cfg, ax, device="cpu")
    params = shard_tree(params_from_numpy(w0, device="cpu"), specs, ax)
    data = batches(cfg.vocab)
    rec: dict = {}

    def numpy_tree(tree):
        return {p: t.detach().numpy() for p, t in flat_keys(tree)}

    if job["kind"] == "train":
        step, opt_specs = make_train_step(
            cfg, ax, mesh, specs,
            TrainStepConfig(opt=AdamWConfig(grad_clip=job["clip"]),
                            bucketed_grad_sync=job.get("bucketed", False),
                            **STEP_CFG))
        opt = adamw_init(params)
        bridges = [link.fn for sec in rt.sections()
                   for link in rt.chain(sec) if hasattr(link.fn, "kernel")]
        for b in bridges:
            b.kernel.launches = 0
        disp.clear_log()
        with AlgoLog() as algos:
            for b in data:
                params, opt, m = step(params, opt, b)
                rec.setdefault("metrics", []).append(
                    {k: float(v) for k, v in m.items()})
        dec = list(disp.decisions)
        rec["decisions"] = [(d.coll, d.algo, d.proto, d.axis_kind)
                            for d in dec]
        rec["named"] = expected_algos(dec)
        rec["ran"] = algos.ran
        rec["cache"] = (disp.cache_hits, disp.cache_misses)
        rec["launches"] = sum(b.kernel.launches for b in bridges)
        rec["host_fallbacks"] = sum(b.stats.host_fallbacks for b in bridges)
        rec["params"] = numpy_tree(gather_tree(params, specs, ax))
        g = gather_tree(opt, opt_specs, ax)
        rec["m"], rec["v"] = numpy_tree(g["m"]), numpy_tree(g["v"])
    elif job["kind"] == "grads":
        b = local_batch(data[0], cfg, ax, "cpu")
        _, g = loss_and_grads(params, b, cfg, ax, specs)
        rec["grads"] = numpy_tree(gather_tree(g, specs, ax))
    elif job["kind"] == "remat":
        from repro_torch.core.context import AxisKind
        from repro_torch.models import loss_fn
        b = local_batch(data[0], cfg, ax, "cpu")
        for name, over in (("off", {}),
                           ("none", dict(remat=True, remat_policy="none")),
                           ("save_psum", dict(remat=True,
                                              remat_policy="save_psum"))):
            c = cfg.with_overrides(**over)
            flat, rebuild = tree_flatten(params)
            leaves = [p.detach().requires_grad_() for p in flat]

            def model_colls():
                return sum(d.axis_kind == AxisKind.MODEL
                           for d in disp.decisions)
            disp.clear_log()
            loss = loss_fn(rebuild(leaves), b, c, ax)
            fwd = model_colls()
            disp.clear_log()
            g = torch.autograd.grad(loss, leaves)
            rec[name] = {"forward": fwd, "backward": model_colls(),
                         "grads": [t.numpy() for t in g]}
    return rec


if __name__ == "__main__":
    reference_main(sys.argv[1])
    sys.stdout.flush()
    os._exit(0)
