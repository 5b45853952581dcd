"""Mesh-scale dispatch in the port (``tests/test_mesh_dispatch.py``'s
contracts), port against reference where the reference has the same
surface:

  * ``launch.mesh.mesh_topology`` over a ``DeviceMesh`` and
    ``set_topology`` feeding ``n_nodes`` / ``ranks_per_node`` into the
    policy ctx and the decision-cache key;
  * ``topo_tuner`` deciding as the reference does across sizes and node
    counts;
  * ``register_mesh_sync`` / ``sync_telemetry`` and the
    ``telemetry_sync_every`` auto-trigger; ``_comm_id`` stability;
  * ``make_ingraph``, the in-graph write cursor and the merge back into
    host maps;
  * the dispatcher's emit table and collective entry points on a 1-rank
    group (the multi-rank runs are in ``tests/test_torch_collectives.py``);
  * ``launch.mesh.make_host_mesh``: a ``(1, n)`` mesh over the default
    group, and the reference's requested-versus-available error.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.collectives.dispatch import (CollectiveDispatcher,
                                              DispatchConfig, _algo_fn,
                                              _comm_id)
from repro_torch.core import PolicyRuntime, make_ctx
from repro_torch.core.context import Algo, AxisKind, CollType, Proto
from repro_torch.core.maps import MapRegistry
from repro_torch.device import DeviceError
from repro_torch.launch.mesh import make_host_mesh, mesh_topology
from repro_torch.policies.mesh import topo_tuner

KiB = 1 << 10
MiB = 1 << 20


def _disp(**cfg_kw):
    rt = PolicyRuntime(tier="torch")
    rt.load(topo_tuner.program)
    return CollectiveDispatcher(runtime=rt, config=DispatchConfig(**cfg_kw))


def _ref_disp():
    from repro.collectives.dispatch import CollectiveDispatcher as RefDisp
    from repro.core import PolicyRuntime as RefRuntime
    from repro.policies.mesh import topo_tuner as ref_topo
    rt = RefRuntime(tier="jit")
    rt.load(ref_topo.program)
    return RefDisp(runtime=rt)


@pytest.fixture
def one_rank_group():
    """A 1-rank gloo group in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# mesh facts
# ---------------------------------------------------------------------------

def test_mesh_topology_facts_and_axis_validation(one_rank_group,
                                                 monkeypatch):
    from torch.distributed.device_mesh import DeviceMesh
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    mesh = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
    topo = mesh_topology(mesh)
    assert topo == {"n_nodes": 1, "ranks_per_node": 1, "n_devices": 1,
                    "axis_sizes": {"data": 1, "model": 1}}
    assert mesh_topology(mesh, axis_name="model")["n_nodes"] == 1
    with pytest.raises(ValueError, match="no axis 'x'"):
        mesh_topology(mesh, axis_name="x")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert mesh_topology(mesh)["n_nodes"] == 1


def test_set_topology_from_mesh_and_explicit(one_rank_group):
    from torch.distributed.device_mesh import DeviceMesh
    disp = _disp()
    assert disp.topology == (0, 0)                 # unknown until set
    mesh = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
    assert disp.set_topology(mesh) == (1, 1) == disp.topology
    assert disp.set_topology(n_nodes=4, ranks_per_node=8) == (4, 8)
    assert disp.set_topology(n_nodes=-3) == (0, 0)


# ---------------------------------------------------------------------------
# topology-aware decisions
# ---------------------------------------------------------------------------

def test_topology_ctx_fields_reach_policies():
    disp = _disp()
    disp.set_topology(n_nodes=1, ranks_per_node=8)
    d = disp.decide(CollType.ALL_REDUCE, 4 * MiB, 8, axis_name="x")
    assert d.from_policy and d.algo == Algo.RING
    disp.set_topology(n_nodes=2, ranks_per_node=4)
    d = disp.decide(CollType.ALL_REDUCE, 4 * MiB, 8, axis_name="x")
    assert d.from_policy and d.algo == Algo.BIDIR_RING
    d = disp.decide(CollType.ALL_REDUCE, 32 * KiB, 8, axis_name="x")
    assert d.from_policy and d.algo == Algo.TREE and d.proto == Proto.LL


def test_topology_joins_decision_cache_key():
    disp = _disp()
    disp.set_topology(n_nodes=1, ranks_per_node=8)
    args = (CollType.ALL_REDUCE, 4 * MiB, 8)
    d1 = disp.decide(*args, axis_name="x")
    assert disp.cache_misses == 1
    d2 = disp.decide(*args, axis_name="x")
    assert disp.cache_hits == 1 and d2.algo == d1.algo
    disp.set_topology(n_nodes=2, ranks_per_node=4)
    d3 = disp.decide(*args, axis_name="x")
    assert disp.cache_misses == 2
    assert d3.algo == Algo.BIDIR_RING != d1.algo


def test_topo_tuner_decisions_equal_reference():
    """Sizes x node counts x collectives through both dispatchers: the
    same Decision every time (the reference on its host JIT tier)."""
    import dataclasses
    port, ref = _disp(), _ref_disp()
    sizes = [16 * KiB, 64 * KiB, 256 * KiB, 1 * MiB, 4 * MiB, 32 * MiB]
    for n_nodes, rpn in [(1, 8), (2, 2), (2, 4), (2, 8), (4, 4), (4, 8)]:
        port.set_topology(n_nodes=n_nodes, ranks_per_node=rpn)
        ref.set_topology(n_nodes=n_nodes, ranks_per_node=rpn)
        for size in sizes:
            for coll in (CollType.ALL_REDUCE, CollType.ALL_GATHER):
                got = port.decide(coll, size, n_nodes * rpn, axis_name="x")
                want = ref.decide(coll, size, n_nodes * rpn, axis_name="x")
                assert dataclasses.astuple(got) == \
                    dataclasses.astuple(want), (n_nodes, rpn, size, coll)


def test_non_allreduce_defers():
    disp = _disp()
    disp.set_topology(n_nodes=1, ranks_per_node=8)
    d = disp.decide(CollType.ALL_GATHER, 4 * MiB, 8, axis_name="x")
    assert not d.from_policy


# ---------------------------------------------------------------------------
# telemetry sync plumbing, communicator identity
# ---------------------------------------------------------------------------

def test_sync_telemetry_runs_registered_callbacks():
    disp = _disp()
    calls = []
    disp.register_mesh_sync(lambda: calls.append("a"))
    disp.register_mesh_sync(lambda: calls.append("b"))
    assert disp.sync_telemetry() == 2
    assert calls == ["a", "b"]
    assert disp.telemetry_syncs == 1


def test_telemetry_sync_every_auto_triggers():
    disp = _disp(telemetry_sync_every=3)
    disp.set_topology(n_nodes=1, ranks_per_node=8)
    calls = []
    disp.register_mesh_sync(lambda: calls.append(1))
    for i in range(7):
        disp.decide(CollType.ALL_REDUCE, (1 + i % 2) * MiB, 8,
                    axis_name="x")
    assert len(calls) == 2 and disp.telemetry_syncs == 2
    disp.sync_telemetry()
    assert len(calls) == 3


def test_comm_id_stable_and_equal_to_reference():
    from repro.collectives.dispatch import _comm_id as ref_comm_id
    assert _comm_id("x", 8) == _comm_id("x", 8) == ref_comm_id("x", 8)
    assert _comm_id("x", 8) != _comm_id("x", 4)
    assert _comm_id("x", 8) != _comm_id("y", 8)
    d1 = _disp()
    d1.set_topology(n_nodes=1, ranks_per_node=8)
    a = d1.decide(CollType.ALL_REDUCE, MiB, 8, axis_name="x")
    d2 = _disp()
    d2.set_topology(n_nodes=2, ranks_per_node=4)
    b = d2.decide(CollType.ALL_REDUCE, MiB, 8, axis_name="x")
    assert a.comm_id == b.comm_id


# ---------------------------------------------------------------------------
# in-graph shard state: make_ingraph, the cursor, the merge
# ---------------------------------------------------------------------------

def test_ingraph_cursor_counts_decides_and_merge_lands_in_host_maps():
    from repro_torch.collectives.ingraph import CURSOR_KEY, InGraphSelector
    from repro_torch.policies.telemetry import bucket_tuner
    sel = InGraphSelector(bucket_tuner.program, tier="torch")
    assert "bucket_tune_state" in sel.written_names
    reg = MapRegistry()
    base = sel.init_state(reg)
    assert int(base[CURSOR_KEY][0]) == 0

    def run(state, times):
        for _ in range(times):
            _, _, state = sel.decide(state, coll=CollType.ALL_REDUCE,
                                     msg_bytes=MiB, n=8)
        return state

    s0, s1 = run(dict(base), 2), run(dict(base), 3)
    assert int(s0[CURSOR_KEY][0]) == 2 and int(s1[CURSOR_KEY][0]) == 3
    stats = {}
    assert sel.merge_shard_states(reg, [s0, s1], base, stats) == 1
    m = reg.get("bucket_tune_state")
    (key_bytes,) = list(m.keys())
    vals = np.frombuffer(bytes(m.lookup_ref(key_bytes)), dtype="<u8")
    assert int(vals[0]) == 5 and int(vals[1]) == MiB
    assert stats.get("dropped_keys", 0) == 0
    reg2 = MapRegistry()
    base2 = sel.init_state(reg2)
    sel.merge_shard_states(reg2, [s1, s0], base2)
    assert np.array_equal(m.to_device(), reg2.get("bucket_tune_state")
                          .to_device())


def test_make_ingraph_seeds_from_the_runtime_maps():
    from repro_torch.collectives.ingraph import InGraphSelector
    from repro_torch.core.torchc import map_to_array
    from repro_torch.policies.telemetry import bucket_tuner
    rt = PolicyRuntime(tier="torch")
    disp = CollectiveDispatcher(runtime=rt)
    with pytest.raises(RuntimeError, match="no tuner policy attached"):
        disp.make_ingraph(tier="torch")
    rt.attach(bucket_tuner.program)
    for size in (MiB, MiB, 4 * KiB):
        disp.decide(CollType.ALL_REDUCE, size, 8, axis_name="data")
    sel, state = disp.make_ingraph(tier="torch")
    assert isinstance(sel, InGraphSelector) and sel.tier == "torch"
    assert torch.equal(state["bucket_tune_state"],
                       map_to_array(rt.maps.get("bucket_tune_state")))
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            disp.make_ingraph()                      # default: cuda
        with pytest.raises(DeviceError):
            disp.make_ingraph(tier="cuda32")


# ---------------------------------------------------------------------------
# the emit table and the entry points
# ---------------------------------------------------------------------------

def test_emit_table_matches_reference():
    from repro.collectives.dispatch import _algo_fn as ref_algo_fn
    natives = {(CollType.REDUCE_SCATTER, "<lambda>"): "reduce_scatter_native",
               (CollType.ALL_GATHER, "<lambda>"): "all_gather_native"}
    for coll in (CollType.ALL_REDUCE, CollType.ALL_GATHER,
                 CollType.REDUCE_SCATTER, CollType.ALL_TO_ALL):
        for algo in range(Algo.COUNT):
            want = ref_algo_fn(coll, algo).__name__
            want = natives.get((coll, want), want)
            assert _algo_fn(coll, algo).__name__ == want, (coll, algo)
    with pytest.raises(KeyError):
        _algo_fn(99, 0)


def test_entry_points_on_a_one_rank_group(one_rank_group):
    """n == 1: all_reduce is the identity without a decision (the
    reference's short-circuit); the other entry points decide — the same
    Decision as the reference's dispatcher — and return the input's
    values."""
    import dataclasses

    from repro.collectives.dispatch import CollectiveDispatcher as RefDisp
    from repro.core import PolicyRuntime as RefRuntime
    from repro.policies.telemetry import bucket_tuner as ref_bt
    from repro_torch.policies.telemetry import bucket_tuner
    rt = PolicyRuntime(tier="torch")
    rt.attach(bucket_tuner.program)
    disp = CollectiveDispatcher(runtime=rt)
    rrt = RefRuntime(tier="interp")
    rrt.attach(ref_bt.program)
    ref = RefDisp(runtime=rrt)
    x = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    y = disp.all_reduce(x, "data")
    assert y is x and len(disp.decisions) == 0
    assert disp.psum(x, "data") is x
    for name, coll, kind in (
            ("reduce_scatter", CollType.REDUCE_SCATTER, AxisKind.DATA),
            ("all_gather", CollType.ALL_GATHER, AxisKind.MODEL),
            ("all_to_all", CollType.ALL_TO_ALL, AxisKind.EXPERT)):
        for _ in range(2):
            y = getattr(disp, name)(x, "data", group=one_rank_group)
            assert torch.equal(y, x), name
            want = ref.decide(coll, x.numel() * 4, 1, axis_kind=kind,
                              dtype_bytes=4, axis_name="data")
            assert dataclasses.astuple(disp.decisions[-1]) == \
                dataclasses.astuple(want), name


def test_make_host_mesh_over_a_one_rank_gloo_group(one_rank_group):
    """A (1, 1) ``("data", "model")`` mesh over the default group, whose
    topology is the reference's ``make_host_mesh(1)``'s."""
    import jax

    from repro.launch.mesh import make_host_mesh as ref_make
    from repro.launch.mesh import mesh_topology as ref_topology
    mesh = make_host_mesh(1, device_type="cpu")
    assert tuple(mesh.mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == ("data", "model")
    assert mesh.device_type == "cpu"
    with jax.default_device(jax.devices("cpu")[0]):
        want = ref_topology(ref_make(1))
    assert mesh_topology(mesh) == want


@pytest.mark.parametrize("n,device_type", [(2, "cpu"), (4, "cpu"),
                                           (1, "cuda")])
def test_make_host_mesh_raises_rather_than_shrinking(one_rank_group, n,
                                                     device_type):
    """More ranks (or, for ``cuda``, more cards) than the process has:
    ``ValueError`` naming what it has and how to get ``n`` ranks, as the
    reference raises for devices, never a smaller mesh."""
    if device_type == "cuda" and torch.cuda.device_count() >= n:
        pytest.skip("this host has the cards")
    with pytest.raises(ValueError) as e:
        make_host_mesh(n, device_type=device_type)
    msg = str(e.value)
    assert f"needs {n} rank(s)" in msg and "1 rank(s)" in msg
    assert "torchrun --nproc-per-node" in msg and "gloo" in msg


def test_make_host_mesh_without_a_process_group():
    with pytest.raises(ValueError, match="not initialized"):
        make_host_mesh(1, device_type="cpu")
