"""Both halves of the port's collective check
(``tests/test_torch_collectives.py``).

* ``python tests/torch_collective_check.py OUT.npz`` — the REFERENCE
  half: runs the JAX package's algorithms on an 8-device host mesh
  (``XLA_FLAGS=--xla_force_host_platform_device_count=8`` set by the
  caller) over the seeded inputs of :func:`inputs` and saves every
  output, plus the reference in-graph selector's algorithm picks.
* :func:`rank_main` — the PORT half: one rank of an 8-rank ``gloo``
  group running ``repro_torch.collectives`` over the same inputs; it
  returns its outputs, torch's own collective on the same inputs, and
  the dispatcher's and the in-graph selector's decisions.

Inputs come from numpy seeded per case and rank.  Each case has a random
normal payload (compared with the reference's outputs, and for SIMPLE
with torch's collective) and a small-integer payload (compared with
torch's collective for every protocol: a bf16 wire carries small
integers and their sums exactly, so the comparison sees the algorithm's
data movement, not bf16 rounding).
"""

from __future__ import annotations

import os
import sys
import zlib

import numpy as np

N = 8
SIZES = (64, 1000, 8192)
SIMPLE, LL, LL128 = 0, 1, 2

# (case, algorithm, kwargs) per all-reduce variant
ALLREDUCE = [
    ("ring_c1", "allreduce_ring", dict(n_channels=1)),
    ("ring_c4", "allreduce_ring", dict(n_channels=4)),
    ("ring_c40", "allreduce_ring", dict(n_channels=40)),
    ("ring_ll", "allreduce_ring", dict(n_channels=2, protocol=LL)),
    ("ring_ll128", "allreduce_ring", dict(n_channels=2, protocol=LL128)),
    ("bidir_c2", "allreduce_bidir_ring", dict(n_channels=2)),
    ("bidir_ll128", "allreduce_bidir_ring",
     dict(n_channels=3, protocol=LL128)),
    ("tree", "allreduce_tree", dict()),
    ("tree_ll", "allreduce_tree", dict(protocol=LL)),
    ("tree_ll128", "allreduce_tree", dict(protocol=LL128)),
]
# (case, algorithm, native counterpart, per-rank input shape, kwargs)
OTHERS = [
    ("reduce_scatter_ring", "reduce_scatter_ring", "reduce_scatter",
     (N, 5), {}),
    ("reduce_scatter_ring_ll128", "reduce_scatter_ring", "reduce_scatter",
     (N, 5), dict(protocol=LL128)),
    ("all_gather_ring", "all_gather_ring", "all_gather", (1, 3, 4), {}),
    ("all_gather_ring_ll", "all_gather_ring", "all_gather", (1, 3, 4),
     dict(protocol=LL)),
    ("all_to_all_chunked", "all_to_all_chunked", "all_to_all", (N, 6), {}),
    ("all_to_all_chunked_ll128", "all_to_all_chunked", "all_to_all",
     (N, 6), dict(protocol=LL128)),
]
# the in-graph loop of tests/test_ingraph_dispatch.py
INGRAPH_LATENCIES = [1000] * 3 + [5_000_000] * 4


def cases():
    """Every (case, algorithm, native, per-rank shape, kwargs)."""
    out = [(f"{name}_{size}", fn, "all_reduce", (1, size), kw)
           for size in SIZES for name, fn, kw in ALLREDUCE]
    return out + OTHERS


def inputs(case: str, shape, rank: int, kind: str) -> np.ndarray:
    """Seeded per-rank input: ``kind`` "normal" or "int" (small ints)."""
    rng = np.random.default_rng([zlib.crc32(case.encode()), rank,
                                 kind == "int"])
    if kind == "int":
        return rng.integers(-8, 9, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def adaptive_program(ns):
    """``adaptive_ingraph`` (tests/test_ingraph_dispatch.py) built with one
    package's frontend."""
    lat_map = ns.map_decl("lat_map", kind="array", value_size=16,
                          max_entries=4)

    @ns.policy(section="tuner", maps=[lat_map])
    def adaptive_ingraph(ctx):
        st = lat_map.lookup(0)
        if st is None:
            ctx.algorithm = 0
            return 0
        if st[0] == 0:
            st[0] = ctx.dtype_bytes
        else:
            st[0] = (st[0] * 3 + ctx.dtype_bytes) // 4
        st[1] = st[1] + 1
        if st[0] > 1000000:
            ctx.algorithm = 2
            ctx.n_channels = 2
        else:
            ctx.algorithm = 0
            ctx.n_channels = 8
        return 0

    return adaptive_ingraph.program


# ---------------------------------------------------------------------------
# the reference half (JAX, 8 host devices)
# ---------------------------------------------------------------------------

def reference_main(out_path: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P

    import repro.core as ref_core
    from repro.collectives import algorithms as alg
    from repro.collectives.ingraph import InGraphSelector
    from repro.compat import enable_x64, shard_map

    mesh = Mesh(np.array(jax.devices()).reshape(N), ("x",))
    natives = {
        "all_reduce": lambda v: lax.psum(v, "x"),
        "reduce_scatter": lambda v: lax.psum_scatter(v, "x", tiled=True),
        "all_gather": lambda v: lax.all_gather(v, "x", tiled=True),
        "all_to_all": lambda v: lax.all_to_all(v, "x", split_axis=0,
                                               concat_axis=0, tiled=True),
    }

    def spmd(fn, x):
        return np.asarray(jax.jit(shard_map(fn, mesh=mesh, in_specs=P("x"),
                                            out_specs=P("x")))(x))

    out = {}
    compiled = {}
    for case, fn, native, shape, kw in cases():
        x = np.concatenate([inputs(case, shape, r, "normal")
                            for r in range(N)])
        f = getattr(alg, fn)
        out[case] = spmd(lambda v: f(v, "x", **kw), x)
        if (native, shape) not in compiled:    # one compile per shape
            compiled[native, shape] = jax.jit(shard_map(
                natives[native], mesh=mesh, in_specs=P("x"),
                out_specs=P("x")))
        out[f"{case}/native"] = np.asarray(compiled[native, shape](x))

    sel = InGraphSelector(adaptive_program(ref_core))
    state = sel.init_state()
    step = jax.jit(shard_map(
        lambda v, st, lat: sel.all_reduce(v, "x", st, latency_ns=lat),
        mesh=mesh, in_specs=(P("x"), P(), P()),
        out_specs=(P("x"), P(), P()), check_vma=False))
    x = np.concatenate([inputs("ingraph", (1, 4096), r, "normal")
                        for r in range(N)])
    algos = []
    with enable_x64(True):
        for lat in INGRAPH_LATENCIES:
            y, algo, state = step(x, state, jnp.uint32(lat))
            algos.append(int(np.asarray(algo)))
    out["ingraph/y"] = np.asarray(y)
    out["ingraph/algos"] = np.asarray(algos)
    np.savez(out_path, **out)


# ---------------------------------------------------------------------------
# the port half (one rank of an 8-rank gloo group)
# ---------------------------------------------------------------------------

def rank_main(rank: int, port: int, q) -> None:
    try:
        q.put((rank, _rank_body(rank, port)))
    except Exception:       # reported to the parent, which fails the test
        import traceback
        q.put((rank, {"error": traceback.format_exc()}))


def _rank_body(rank: int, port: int) -> dict:
    import datetime

    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=N, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        return _rank_cases(rank, torch, dist)
    finally:
        dist.destroy_process_group()


def _rank_cases(rank, torch, dist) -> dict:
    import repro_torch.core as port_core
    from repro_torch.collectives import algorithms as A
    from repro_torch.collectives.dispatch import (CollectiveDispatcher,
                                                  reset_dispatcher)
    from repro_torch.collectives.ingraph import InGraphSelector
    from repro_torch.core import FaultInjector, PolicyRuntime
    from repro_torch.policies import bad_channels, ring_mid_v2

    natives = {"all_reduce": A.allreduce_native,
               "reduce_scatter": A.reduce_scatter_native,
               "all_gather": A.all_gather_native,
               "all_to_all": A.all_to_all_native}
    res: dict = {}
    for case, fn, native, shape, kw in cases():
        f = getattr(A, fn)
        for kind in ("normal", "int"):
            x = torch.from_numpy(inputs(case, shape, rank, kind))
            res[f"{case}/{kind}"] = f(x, None, **kw).numpy()
            res[f"{case}/{kind}/native"] = natives[native](x).numpy()

    # a group of 6 ranks (2..7): group ranks map to global ranks, and the
    # tree falls back to a ring on a size that is not a power of two
    sub = dist.new_group(ranks=list(range(2, N)))
    if rank >= 2:
        x = torch.from_numpy(inputs("sub6", (1, 999), rank, "normal"))
        res["sub6/tree"] = A.allreduce_tree(x, sub).numpy()
        res["sub6/ring_c3"] = A.allreduce_ring(x, sub, n_channels=3).numpy()
        res["sub6/native"] = A.allreduce_native(x, sub).numpy()

    # policy-driven dispatch end to end, as the reference tests it
    rt = PolicyRuntime(tier="torch")
    rt.load(ring_mid_v2.program)
    disp = reset_dispatcher(runtime=rt)
    dec = []
    for label, numel in (("small", 1 << 19), ("mid", 2 << 20)):
        x = torch.from_numpy(inputs(f"disp_{label}", (1, numel), rank,
                                    "int"))
        res[f"disp_{label}"] = disp.all_reduce(x, "x").numpy()
        res[f"disp_{label}/native"] = A.allreduce_native(x).numpy()
        dec.append(disp.decisions[-1])
    rt.reload(bad_channels.program)
    res["disp_reload"] = disp.all_reduce(x, "x").numpy()
    dec.append(disp.decisions[-1])
    res["decisions"] = [(d.algo, d.proto, d.channels, d.from_policy)
                        for d in dec]
    # an injected decide()-path fault is invisible to the collective:
    # bit-identical to running with the policy detached
    base = CollectiveDispatcher(runtime=PolicyRuntime(tier="torch"))
    rt2 = PolicyRuntime(tier="torch")
    rt2.load(ring_mid_v2.program)
    disp2 = CollectiveDispatcher(runtime=rt2)
    x = torch.from_numpy(inputs("fault", (1, 2 << 20), rank, "normal"))
    want = base.all_reduce(x, "x")
    with FaultInjector(seed=3).plan("decide", prob=1.0):
        got = disp2.all_reduce(x, "x")
    res["fault_identical"] = bool(torch.equal(got, want))
    res["fault_exceptions"] = disp2.fault_stats.policy_exceptions
    d = disp2.decisions[-1]
    res["fault_decision"] = (d.algo, d.from_policy)

    # the in-graph selector's all_reduce (tests/test_ingraph_dispatch.py)
    sel = InGraphSelector(adaptive_program(port_core), tier="torch")
    state = sel.init_state()
    x = torch.from_numpy(inputs("ingraph", (1, 4096), rank, "normal"))
    algos = []
    for lat in INGRAPH_LATENCIES:
        y, algo, state = sel.all_reduce(x, "x", state,
                                        latency_ns=torch.tensor(lat))
        algos.append(int(algo))
    res["ingraph/y"] = y.numpy()
    res["ingraph/native"] = A.allreduce_native(x).numpy()
    res["ingraph/algos"] = algos
    res["ingraph/host_syncs"] = sel.host_syncs

    # mesh facts over a 2 x 4 DeviceMesh, 4 ranks per node
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import mesh_topology
    os.environ["LOCAL_WORLD_SIZE"] = "4"
    mesh = DeviceMesh("cpu", torch.arange(N).reshape(2, 4),
                      mesh_dim_names=("node", "local"))
    res["topology"] = mesh_topology(mesh, axis_name="local")
    disp.set_topology(mesh)
    res["dispatcher_topology"] = disp.topology
    return res


if __name__ == "__main__":
    sys.exit(reference_main(sys.argv[1]))
