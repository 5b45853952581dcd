"""Multi-pod dry run: one rank's step of every (arch × shape × mesh) combo,
run on meta tensors (the port of ``repro/launch/dryrun.py``).

Proves the distribution config is coherent without the hardware:
  * one rank of the single-pod (16×16, 256-rank) AND multi-pod (2×16×16,
    512-rank) mesh runs its train, prefill or decode step end to end on
    meta tensors, its collectives over a fake process group of the
    mesh's size (``init_process_group("cpu:fake,meta:fake")``): every
    shape, sharding and collective of the step must line up;
  * the working set the trace records proves the per-rank state fits;
  * the trace's FLOPs, bytes and collectives feed §Roofline
    (:mod:`repro_torch.launch.roofline`).

There is no compile: ``lower_s`` is the trace's time.  The policy
decisions the step's collectives take run on the card (``tier="cuda"``,
the CUDA policy kernel) unless ``--device cpu`` asks for the host JIT
(``tier="jit"``); the step's tensors are meta tensors either way.  The
fake process group is global to a process, so :func:`main` runs each
mesh in its own child process (:func:`run_mesh`).

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k \
      --mesh pod [--policy ring_mid_v2] [--bucketed] [--out out.json] \
      [--device cpu]
  python -m repro_torch.launch.dryrun --all --out results/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
from typing import List, Optional, Tuple

MESHES = {"pod": (16, 16), "2pod": (2, 16, 16)}


def init_fake_group(world: int) -> None:
    """The process's default group: ``world`` ranks of the fake backend
    (this process is rank 0), for CPU and meta tensors; its collectives
    return at once and move nothing."""
    import torch.distributed as dist
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                            rank=0, world_size=world)


def _load_policy(name: str, tier: str):
    from ..collectives.dispatch import reset_dispatcher
    from ..core.runtime import PolicyRuntime

    rt = PolicyRuntime(tier=tier)
    if name and name != "none":
        import repro_torch.policies as pol
        rt.load(getattr(pol, name).program)
    reset_dispatcher(runtime=rt)
    return rt


def _mesh(mesh_shape: Optional[Tuple[int, ...]], multi_pod: bool):
    """(DeviceMesh over the default group's first ranks, its label)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from .mesh import make_production_mesh

    shape = mesh_shape or MESHES["2pod" if multi_pod else "pod"]
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        init_fake_group(n)
    if mesh_shape is None:
        return (make_production_mesh(multi_pod=multi_pod, device_type="cpu"),
                "2pod" if multi_pod else "pod")
    names = ("pod", "data", "model")[-len(shape):]
    return (DeviceMesh("cpu", torch.arange(n).reshape(shape),
                       mesh_dim_names=names),
            "x".join(str(s) for s in shape))


def lower_combo(arch: str, shape_name: str, *, multi_pod: bool,
                policy: str = "none", bucketed: bool = False,
                gather_bf16: bool = False, capacity_factor: float = 0.0,
                remat: bool = True, remat_policy: str = "none",
                mlstm_chunk: int = 0, serve_bf16: bool = False,
                tier: str = "cuda", mesh_shape=None, cfg=None,
                global_batch: Optional[int] = None,
                seq_len: Optional[int] = None):
    """Returns a result dict (the trace's roofline inputs).

    Runs rank 0's step of the combo on meta tensors under
    :class:`~repro_torch.launch.roofline.TraceAnalyzer`.  The default
    process group must be a fake one of at least the mesh's size; with
    none, a fake group of the mesh's size is started here.
    ``mesh_shape`` (e.g. ``(2, 2)``), ``cfg`` (e.g. a smoke config),
    ``global_batch`` and ``seq_len`` replace the production mesh, the
    arch's serving config and the shape's batch and length; ``tier`` is
    the policy runtime's."""
    import torch

    from ..collectives.dispatch import dispatcher
    from ..configs import SHAPES, serving_config, shape_supported
    from ..models.transformer import tree_map
    from ..train.step import (TrainStepConfig, make_serve_step,
                              make_train_step, shard_tree)
    from .mesh import mesh_axes
    from .roofline import analyze_trace, timed_trace
    from .specs import (batch_shapes, cache_shapes_and_specs, opt_shapes,
                        param_shapes_and_specs)

    shape = SHAPES[shape_name]
    skip = shape_supported(arch, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name,
                "mesh": "2pod" if multi_pod else "pod",
                "status": "skipped", "reason": skip}

    rt = _load_policy(policy, tier)
    mesh, mesh_name = _mesh(mesh_shape, multi_pod)
    is_train = shape.kind == "train"
    ax = mesh_axes(mesh, fsdp=is_train, gather_bf16=gather_bf16)

    cfg = cfg or serving_config(arch, shape_name)
    if is_train:
        cfg = cfg.with_overrides(remat=remat, remat_policy=remat_policy)
    if capacity_factor:
        cfg = cfg.with_overrides(capacity_factor=capacity_factor)
    if mlstm_chunk:
        cfg = cfg.with_overrides(mlstm_chunk=mlstm_chunk)
    B = global_batch or shape.global_batch
    S = seq_len or shape.seq_len

    params, param_specs = param_shapes_and_specs(cfg, ax)
    if serve_bf16 and not is_train:
        # serving-time bf16 parameter residency: halves the dominant
        # param-read traffic of decode (models cast per-op regardless)
        params = tree_map(lambda a: a.to(torch.bfloat16)
                          if a.dtype == torch.float32 else a, params)
    local = shard_tree(params, param_specs, ax)
    del params

    # every decision the step takes, and the policy kernel's launches
    disp = dispatcher()
    made = [0]
    decide = disp.decide

    def counted(*a, **kw):
        made[0] += 1
        return decide(*a, **kw)
    disp.decide = counted
    bridges = [link.fn for s in rt.sections() for link in rt.chain(s)
               if hasattr(link.fn, "kernel")]
    for b in bridges:
        b.kernel.launches = 0

    if is_train:
        opt = opt_shapes(local)
        step_fn, _ = make_train_step(
            cfg, ax, mesh, param_specs,
            TrainStepConfig(bucketed_grad_sync=bucketed))
        batch = batch_shapes(cfg, B, S, kind="train")
        run, args = (lambda: step_fn(local, opt, batch)), (local, opt)
    elif shape.kind == "prefill":
        step_fn = make_serve_step(cfg, ax, mesh, param_specs, None,
                                  mode="prefill")
        batch = batch_shapes(cfg, B, S, kind="prefill")
        batch.pop("labels")
        run, args = (lambda: step_fn(local, batch)), local
    else:  # decode
        world_dp = ax.dp * ax.n_pods
        replicate = B < world_dp or B % world_dp != 0
        dp_axes = None if replicate else (
            ("pod", "data") if ax.pod else "data")
        cache, cache_specs = cache_shapes_and_specs(cfg, B, S, ax, dp_axes)
        caches = shard_tree(cache, cache_specs, ax)
        del cache
        step_fn = make_serve_step(cfg, ax, mesh, param_specs, cache_specs,
                                  mode="decode", replicate_batch=replicate)
        tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
        pos = torch.empty((B,), dtype=torch.int32, device="meta")
        run, args = (lambda: step_fn(local, tok, caches, pos)), \
            (local, caches)
    try:
        an, _, t_lower = timed_trace(run, args)
    finally:
        del disp.decide

    result = analyze_trace(an, arch=arch, shape=shape_name, mesh=mesh_name,
                           cfg=cfg, n_devices=int(mesh.mesh.numel()),
                           kind=shape.kind, global_batch=B, seq_len=S)
    result.update({
        "status": "ok", "policy": policy, "bucketed": bucketed,
        "tier": tier, "lower_s": round(t_lower, 1),
        "decisions": {"made": made[0], "cache_hits": disp.cache_hits,
                      "cache_misses": disp.cache_misses,
                      "policy_launches": sum(b.kernel.launches
                                             for b in bridges)}})
    return result


def _error(job: dict, exc: BaseException) -> dict:
    shape = job.get("mesh_shape")
    mesh = "x".join(str(s) for s in shape) if shape else (
        "2pod" if job.get("multi_pod") else "pod")
    return {"arch": job["arch"], "shape": job["shape_name"], "mesh": mesh,
            "status": "error",
            "error": f"{type(exc).__name__}: {exc}",
            "traceback": traceback.format_exc()}


def _mesh_child(q, world: int, jobs: List[dict]) -> None:
    """One child process: a fake group of ``world`` ranks, then each
    job's :func:`lower_combo`; the results go back on ``q``."""
    out = []
    try:
        init_fake_group(world)
        for job in jobs:
            try:
                out.append(lower_combo(**job))
            except Exception as e:
                traceback.print_exc()
                out.append(_error(job, e))
    except Exception as e:          # the group itself failed
        out = [_error(j, e) for j in jobs]
    q.put(out)


def run_mesh(world: int, jobs: List[dict], timeout: float = 1800.0
             ) -> List[dict]:
    """Each job's :func:`lower_combo` (its keyword arguments, with
    ``arch`` and ``shape_name``) in one spawned child process holding a
    fake group of ``world`` ranks."""
    import multiprocessing as mp
    import queue
    import time

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_mesh_child, args=(q, world, jobs))
    p.start()
    deadline = time.monotonic() + timeout
    try:
        while True:
            try:
                return q.get(timeout=1.0)
            except queue.Empty:
                if p.exitcode is not None:
                    raise RuntimeError(f"the dry run's child for {world} "
                                       f"ranks exited with {p.exitcode} "
                                       "and no result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the dry run's child for {world} "
                                       f"ranks gave no result in "
                                       f"{timeout:.0f} s") from None
    finally:
        p.join(timeout=60)
        if p.is_alive():
            p.terminate()
            p.join()


def main(argv=None) -> None:
    from ..configs import SHAPES
    from ..configs.registry import ARCH_IDS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "2pod", "both"],
                    default="pod")
    ap.add_argument("--policy", default="none")
    ap.add_argument("--bucketed", action="store_true")
    ap.add_argument("--gather-bf16", action="store_true")
    ap.add_argument("--capacity-factor", type=float, default=0.0)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", default="none")
    ap.add_argument("--mlstm-chunk", type=int, default=0)
    ap.add_argument("--serve-bf16", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the policy decisions run (default: the "
                         "card, tier cuda; cpu: the host JIT)")
    args = ap.parse_args(argv)
    tier = "jit" if args.device == "cpu" else "cuda"
    if tier == "cuda":
        # no fallback: without a card the run stops here, not in a child
        from ..device import require_cuda
        require_cuda("the dry run's policy decisions (tier='cuda'; pass "
                     "--device cpu for the host JIT)")

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["pod", "2pod"] if args.mesh == "both" else [args.mesh]

    results = []
    for m in meshes:
        jobs, paths = [], []
        for a in archs:
            for s in shapes:
                key = f"{a}|{s}|{m}|{args.policy}|{int(args.bucketed)}"
                if args.tag:
                    key += f"|{args.tag}"
                out_path = None
                if args.out:
                    if not args.out.endswith(".json"):
                        os.makedirs(args.out, exist_ok=True)
                    out_path = (os.path.join(
                        args.out, key.replace("|", "__") + ".json")
                        if not args.out.endswith(".json") else args.out)
                    if os.path.exists(out_path):
                        print(f"SKIP (cached) {key}", flush=True)
                        continue
                print(f"=== {key}", flush=True)
                jobs.append(dict(
                    arch=a, shape_name=s, multi_pod=(m == "2pod"),
                    policy=args.policy, bucketed=args.bucketed,
                    gather_bf16=args.gather_bf16,
                    capacity_factor=args.capacity_factor,
                    remat=not args.no_remat, remat_policy=args.remat_policy,
                    mlstm_chunk=args.mlstm_chunk,
                    serve_bf16=args.serve_bf16, tier=tier))
                paths.append(out_path)
        if not jobs:
            continue
        world = 1
        for s in MESHES[m]:
            world *= s
        for r, out_path in zip(run_mesh(world, jobs), paths):
            results.append(r)
            print(json.dumps({k: v for k, v in r.items()
                              if k not in ("collectives_by_op", "traceback")},
                             indent=None), flush=True)
            if out_path:
                with open(out_path, "w") as f:
                    json.dump(r, f, indent=1)

    n_err = sum(r["status"] == "error" for r in results)
    print(f"DONE {len(results)} combos, {n_err} errors", flush=True)
    sys.exit(1 if n_err else 0)


if __name__ == "__main__":
    main()
