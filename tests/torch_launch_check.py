"""Shared half of ``tests/test_torch_launch.py``: the reference's serve step
and dry-run analysis on a host mesh, and the port's serve step on one
rank of a ``gloo`` group.

- :func:`reference_main` (``python tests/torch_launch_check.py OUT``, with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` in its
  environment only) runs the reference: its ``make_serve_step`` (prefill,
  then ``N_DECODE`` decode steps from empty caches) at ``tp = 2`` on a
  ``(1, 2)`` mesh for every arch of ``SERVE_ARCHS``, and, for every
  ``DRY_COMBOS`` entry, its step lowered and compiled on a ``(2, 2)`` mesh
  and analysed by ``launch.roofline``'s HLO parser (``parse_hlo`` +
  ``multiplicities`` + ``aggregate``): the dot FLOPs, HBM bytes and wire
  bytes per device and the collectives by op.  Arrays go to ``OUT.npz``,
  the analysis to ``OUT.json``.
- :func:`rank_main` runs the port's serve step on one rank of a ``gloo``
  group and returns the global outputs (caches gathered from the shards).
- :func:`compare_main` (``python tests/torch_launch_check.py --compare``)
  prints the dry run's (2, 2) smoke combos on both sides as one table.

Every serve run uses the f32 smoke config and the reference's
``init_params`` tree for its mesh axes (``PRNGKey(0)``).
"""

from __future__ import annotations

import json
import sys

import numpy as np

# dense, MoE, recurrent
SERVE_ARCHS = ("tinyllama-1.1b", "olmoe-1b-7b", "recurrentgemma-9b")
B, S, CTX, N_DECODE = 2, 8, 16, 2
# the dry run's (2, 2) smoke combos: (arch, shape, global batch, seq len)
DRY_COMBOS = tuple((a, s, 4, 64) for a in ("tinyllama-1.1b", "olmoe-1b-7b")
                   for s in ("train_4k", "prefill_32k", "decode_32k"))


def prompt(vocab: int) -> np.ndarray:
    return np.random.RandomState(29).randint(
        0, vocab, (B, S)).astype(np.int32)


def decode_tokens(vocab: int) -> list:
    rng = np.random.RandomState(31)
    return [rng.randint(0, vocab, (B, 1)).astype(np.int32)
            for _ in range(N_DECODE)]


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


def reference_weights(arch: str, tp: int):
    """The reference's f32 smoke config and its ``init_params`` tree (as
    numpy) for ``MeshAxes(tp=tp, fsdp=False)``."""
    import jax

    import repro.models as R
    from repro.configs import get_smoke_config
    from repro.models.layers import MeshAxes

    cfg = get_smoke_config(arch).with_overrides(dtype="float32")
    params, _ = R.init_params(jax.random.PRNGKey(0), cfg,
                              MeshAxes(tp=tp, dp=1, fsdp=False))
    return cfg, jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# the reference (JAX), in its own process
# ---------------------------------------------------------------------------

def reference_serve(arch: str, tp: int, devices) -> dict:
    """The reference's prefill logits, decode tokens and final caches."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import repro.models as R
    from repro.launch.specs import cache_shapes_and_specs
    from repro.models.layers import MeshAxes
    from repro.models.transformer import init_caches
    from repro.train.step import make_serve_step

    cfg, w = reference_weights(arch, tp)
    ax = MeshAxes(tp=tp, dp=1, fsdp=False)
    _, specs = R.init_params(jax.random.PRNGKey(0), cfg, ax)
    mesh = Mesh(np.array(devices[:tp]).reshape(1, tp), ("data", "model"))
    params = jax.tree.map(jnp.asarray, w)
    out = {}
    pre = make_serve_step(cfg, ax, mesh, specs, None, mode="prefill")
    out["prefill"] = np.asarray(pre(params, {"tokens": prompt(cfg.vocab)}))
    _, cache_specs = cache_shapes_and_specs(cfg, B, CTX, ax, "data")
    dec = make_serve_step(cfg, ax, mesh, specs, cache_specs, mode="decode")
    caches = init_caches(params, cfg, B, CTX, MeshAxes(tp=1, dp=1))
    for i, tok in enumerate(decode_tokens(cfg.vocab)):
        nxt, caches = dec(params, jnp.asarray(tok), caches,
                          jnp.full((B,), i, jnp.int32))
        out[f"token/{i}"] = np.asarray(nxt)
    for path, leaf in flat_keys(caches):
        out[f"cache{path}"] = np.asarray(leaf)
    return out


def reference_dry(arch: str, shape_name: str, batch: int, seq: int,
                  devices) -> dict:
    """The reference dry run's step at the smoke size on a ``(2, 2)``
    mesh, analysed from its compiled HLO as ``analyze_compiled`` does
    (without ``cost_analysis``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.configs import SHAPES, get_smoke_config
    from repro.launch.mesh import mesh_axes
    from repro.launch.roofline import aggregate, multiplicities, parse_hlo
    from repro.launch.specs import (batch_shapes, cache_shapes_and_specs,
                                    opt_shapes, param_shapes_and_specs)
    from repro.train.step import (TrainStepConfig, make_serve_step,
                                  make_train_step)

    kind = SHAPES[shape_name].kind
    mesh = Mesh(np.array(devices[:4]).reshape(2, 2), ("data", "model"))
    ax = mesh_axes(mesh, fsdp=kind == "train")
    cfg = get_smoke_config(arch)
    if kind == "train":
        cfg = cfg.with_overrides(remat=True, remat_policy="none")
    p_sds, p_specs = param_shapes_and_specs(cfg, ax)
    if kind == "train":
        step, _ = make_train_step(cfg, ax, mesh, p_specs, TrainStepConfig())
        lowered = step.lower(p_sds, opt_shapes(p_sds),
                             batch_shapes(cfg, batch, seq, kind="train"))
    elif kind == "prefill":
        step = make_serve_step(cfg, ax, mesh, p_specs, None, mode="prefill")
        b = batch_shapes(cfg, batch, seq, kind="prefill")
        b.pop("labels")
        lowered = step.lower(p_sds, b)
    else:
        c_sds, c_specs = cache_shapes_and_specs(cfg, batch, seq, ax, "data")
        step = make_serve_step(cfg, ax, mesh, p_specs, c_specs,
                               mode="decode")
        lowered = step.lower(p_sds, jax.ShapeDtypeStruct((batch, 1),
                                                         jnp.int32),
                             c_sds, jax.ShapeDtypeStruct((batch,),
                                                         jnp.int32))
    comps, entry = parse_hlo(lowered.compile().as_text(), 4)
    flops, hbm, wire, by_op = aggregate(comps, multiplicities(comps, entry),
                                        4)
    return {"flops": flops, "bytes": hbm, "wire": wire, "by_op": by_op}


def reference_main(out_path: str) -> None:
    import jax

    from repro.collectives.dispatch import reset_dispatcher
    from repro.core.runtime import PolicyRuntime

    reset_dispatcher(runtime=PolicyRuntime())
    devices = jax.devices()
    arrays = {}
    for arch in SERVE_ARCHS:
        for k, v in reference_serve(arch, 2, devices).items():
            arrays[f"{arch}/{k}"] = v
    np.savez(out_path + ".npz", **arrays)
    dry = {f"{a}|{s}": reference_dry(a, s, b, q, devices)
           for a, s, b, q in DRY_COMBOS}
    with open(out_path + ".json", "w") as f:
        json.dump(dry, f)


# ---------------------------------------------------------------------------
# the port, one rank of a gloo group (or one process for tp = 1)
# ---------------------------------------------------------------------------

def port_serve(arch: str, w, ax, cfg) -> dict:
    """The port's prefill logits, decode tokens and final global caches
    through ``make_serve_step`` on this rank's shards of ``w``."""
    import torch

    from repro_torch.launch.specs import (cache_shapes_and_specs,
                                          param_shapes_and_specs)
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.layers import MeshAxes
    from repro_torch.models.transformer import init_caches
    from repro_torch.train.step import (gather_tree, make_serve_step,
                                        shard_tree)

    _, specs = param_shapes_and_specs(cfg, ax)
    params = params_from_numpy(w, device="cpu")
    local = shard_tree(params, specs, ax)
    out = {}
    pre = make_serve_step(cfg, ax, None, specs, None, mode="prefill")
    out["prefill"] = pre(local, {"tokens": prompt(cfg.vocab)}).numpy()
    _, cache_specs = cache_shapes_and_specs(cfg, B, CTX, ax, "data")
    dec = make_serve_step(cfg, ax, None, specs, cache_specs, mode="decode")
    caches = shard_tree(init_caches(params, cfg, B, CTX, MeshAxes()),
                        cache_specs, ax)
    for i, tok in enumerate(decode_tokens(cfg.vocab)):
        nxt, caches = dec(local, tok, caches,
                          torch.full((B,), i, dtype=torch.int32))
        out[f"token/{i}"] = nxt.numpy()
    for path, leaf in flat_keys(gather_tree(caches, cache_specs, ax)):
        out[f"cache{path}"] = leaf.numpy()
    return out


def rank_main(rank: int, world: int, port: int, q, jobs) -> None:
    """``jobs``: (arch, numpy weights) pairs, served at ``tp = world``."""
    try:
        q.put((rank, _rank_body(rank, world, port, jobs)))
    except Exception:       # reported to the parent, which fails the test
        import traceback
        q.put((rank, {"error": traceback.format_exc()}))


def _rank_body(rank: int, world: int, port: int, jobs) -> dict:
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.collectives.dispatch import reset_dispatcher
    from repro_torch.configs import get_smoke_config

    import torch_train_check as chk

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        reset_dispatcher(tier="jit")
        _, ax = chk.mesh_and_axes(1, world, fsdp=False)
        return {arch: port_serve(arch, w, ax, get_smoke_config(arch)
                                 .with_overrides(dtype="float32"))
                for arch, w in jobs}
    finally:
        dist.destroy_process_group()


def compare_main() -> None:
    """``python tests/torch_launch_check.py --compare``: the (2, 2) smoke
    combos on both sides, printed as one table (per rank: FLOPs, HBM
    bytes, wire bytes, and the collectives by op) and one JSON line."""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun

    ref = {f"{a}|{s}": reference_dry(a, s, b, q, jax.devices())
           for a, s, b, q in DRY_COMBOS}
    port = dryrun.run_mesh(4, [dict(
        arch=a, shape_name=s, multi_pod=False, tier="jit", mesh_shape=(2, 2),
        cfg=get_smoke_config(a), global_batch=b, seq_len=q)
        for a, s, b, q in DRY_COMBOS])
    rows = {}
    print(f"{'combo':28s} {'FLOPs port/ref':>16s} {'bytes port/ref':>16s} "
          f"{'wire port / ref (bytes)':>28s}  collectives port | ref")
    for (a, s, _, _), p in zip(DRY_COMBOS, port):
        r = ref[f"{a}|{s}"]
        rows[f"{a}|{s}"] = {"port": {k: p[k] for k in (
            "trace_flops_per_dev", "trace_bytes_per_dev",
            "collective_wire_bytes_per_dev", "collectives_by_op")},
            "reference": r}
        ops = lambda by: ", ".join(f"{k} {v['count']:g}x {v['wire_bytes']:.0f}"
                                   for k, v in sorted(by.items()))
        print(f"{a + ' ' + s:28s} "
              f"{p['trace_flops_per_dev'] / r['flops']:16.4f} "
              f"{p['trace_bytes_per_dev'] / r['bytes']:16.3f} "
              f"{p['collective_wire_bytes_per_dev']:13.0f} / "
              f"{r['wire']:12.0f}  {ops(p['collectives_by_op'])} | "
              f"{ops(r['by_op'])}")
    print(json.dumps(rows))


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare_main()
    else:
        reference_main(sys.argv[1])
