"""The deterministic shard merge and the mesh-mode bridge, port against
reference (``tests/test_shard_merge.py``'s contracts).

* ``repro_torch.core.shardmerge`` on seeded shards equals
  ``repro.core.shardmerge`` bit for bit, for array and hash maps, any
  shard order;
* the mesh-mode ``DeviceBridge`` (``tier="torch"``, and the ``cuda32``
  pair path with its device pinned to the CPU) merges into host maps
  byte-identical to the reference's ``tier="pallas32"`` bridge on the
  same call sequence, and 1 shard equals 8;
* ``InGraphSelector.merge_shard_states`` equals the reference's.
"""

import numpy as np
import pytest
import torch

import repro.core.shardmerge as ref_sm
import repro_torch.core.shardmerge as sm
from repro.core.maps import MapRegistry as RefRegistry
from repro_torch.core import PolicyRuntime, make_ctx
from repro_torch.core.bridge import BridgeError, compile_host
from repro_torch.core.context import Algo, CollType
from repro_torch.core.maps import MapRegistry, hash_slot
from repro_torch.core.program import MapDecl
from repro_torch.policies.telemetry import bucket_tuner

U64 = np.uint64


def _arr_decl(mod=None, merge=("sum", "max"), value_size=16, max_entries=4):
    cls = MapDecl if mod is None else mod
    return cls(name="m", kind="array", key_size=4, value_size=value_size,
               max_entries=max_entries, merge=merge)


def _hash_decl(cls=MapDecl, max_entries=8, merge=("sum", "max")):
    return cls(name="h", kind="hash", key_size=8, value_size=16,
               max_entries=max_entries, merge=merge)


def _hash_device(max_entries, table):
    """{key: (v0, v1)} in the open-addressing device layout."""
    arr = np.zeros((max_entries + 1, 4), dtype=U64)
    for k, vals in table.items():
        i = hash_slot(k, max_entries)
        while arr[i, 3] != 0:
            i = (i + 1) % max_entries
        arr[i, :2] = vals
        arr[i, 2] = k
        arr[i, 3] = 1
    arr[max_entries, 0] = len(table)
    return arr


def _random_shards(rng, kind: str, n_shards: int):
    """A base and ``n_shards`` seeded shard arrays (some unchanged)."""
    if kind == "array":
        base = rng.integers(0, 1 << 40, (6, 2)).astype(U64)
        out = []
        for sid in range(n_shards):
            arr = base.copy()
            arr[:, 0] += rng.integers(0, 100, 6).astype(U64)
            touched = rng.random(6) < 0.5
            arr[touched, 1] = rng.integers(0, 1 << 20, touched.sum())
            out.append((sid, arr, int(rng.integers(0, 9)), base))
        return base, out
    keys = [int(k) for k in rng.choice(1 << 12, 10, replace=False)]
    base = _hash_device(8, {k: (5, 64) for k in keys[:3]})
    out = []
    for sid in range(n_shards):
        tab = {k: (int(rng.integers(5, 50)), int(rng.integers(0, 1 << 20)))
               for k in rng.choice(keys, 4, replace=False).tolist()}
        out.append((sid, _hash_device(8, tab), int(rng.integers(1, 9)),
                    base))
    return base, out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kind", ["array", "hash"])
def test_merge_equals_reference_on_seeded_shards(kind, seed):
    rng = np.random.default_rng(seed)
    base, raw = _random_shards(rng, kind, 5)
    ref_decl = (_arr_decl(ref_sm.MapDecl) if kind == "array"
                else _hash_decl(ref_sm.MapDecl))
    decl = _arr_decl() if kind == "array" else _hash_decl()
    want_stats, got_stats = {}, {}
    want = ref_sm.merge_map_shards(
        ref_decl, base, [ref_sm.Shard(*s) for s in raw], want_stats)
    for order in (list(range(5)), [3, 0, 4, 1, 2]):
        got = sm.merge_map_shards(decl, base,
                                  [sm.Shard(*raw[i]) for i in order],
                                  got_stats)
        assert np.array_equal(got, want)
    assert got_stats.get("dropped_keys", 0) == \
        2 * want_stats.get("dropped_keys", 0)


def test_slot_spec_and_pairs_roundtrip():
    d = MapDecl(name="m", kind="array", key_size=4, value_size=32,
                max_entries=1, merge=("max",))
    assert sm.slot_merge_spec(d) == ("max", "sum", "sum", "sum")
    a = np.array([0, 1, 0xFFFFFFFF, 1 << 32, (1 << 64) - 1], dtype=U64)
    assert np.array_equal(sm.pairs_to_u64(sm.u64_to_pairs(a)), a)
    # the port's pair lanes are int32 holding the same bits
    as_i32 = sm.u64_to_pairs(a).view("<i4")
    assert np.array_equal(sm.pairs_to_u64(as_i32), a)
    assert np.array_equal(sm.u64_to_pairs(a), ref_sm.u64_to_pairs(a))


def test_sum_is_delta_based_and_max_goes_to_the_highest_cursor():
    d = _arr_decl(merge=("sum", "max"), max_entries=1)
    seed = np.full((1, 2), 10, dtype=U64)

    def shard(sid, cur, count, ema):
        arr = seed.copy()
        arr[0, 0] += U64(count)
        arr[0, 1] = ema
        return sm.Shard(sid, arr, cur, seed)

    host = np.full((1, 2), 100, dtype=U64)
    out = sm.merge_array_shards(d, host, [shard(0, 2, 5, 111),
                                          shard(1, 9, 5, 222),
                                          shard(2, 4, 5, 333)])
    assert int(out[0, 0]) == 115 and int(out[0, 1]) == 222
    out = sm.merge_array_shards(d, host, [shard(2, 5, 0, 333),
                                          shard(0, 5, 0, 111)])
    assert int(out[0, 1]) == 111          # ties go to the lowest shard id
    with pytest.raises(sm.ShardMergeError, match="duplicate"):
        sm.merge_array_shards(d, host, [shard(1, 1, 0, 1), shard(1, 1, 0, 1)])
    rb = MapDecl(name="rb", kind="ringbuf", key_size=0, value_size=16,
                 max_entries=8)
    with pytest.raises(sm.ShardMergeError, match="ringbuf"):
        sm.merge_map_shards(rb, np.zeros((1, 1), dtype=U64), [])


def test_hash_overflow_drops_the_last_new_keys_and_counts_them():
    d = _hash_decl(max_entries=4)
    base = _hash_device(4, {1: (5, 0), 2: (5, 0)})
    extra = _hash_device(4, {1: (6, 0), 11: (1, 0), 12: (1, 0), 13: (1, 0)})
    stats = {}
    out = sm.merge_hash_shards(d, base, [sm.Shard(0, extra, 1, base)], stats)
    assert stats["dropped_keys"] == 1
    keys = {int(out[i, 2]) for i in range(4) if out[i, 3]}
    assert keys == {1, 2, 11, 12} and int(out[4, 0]) == 4


# ---------------------------------------------------------------------------
# mesh-mode DeviceBridge
# ---------------------------------------------------------------------------

def _port_bridge(n_shards, tier, monkeypatch, registry=None):
    if tier == "cuda32@cpu":
        from repro_torch.core import bridge as bridge_mod
        monkeypatch.setattr(bridge_mod, "require_cuda",
                            lambda what: torch.device("cpu"))
        tier = "cuda32"
    prog = bucket_tuner.program
    reg = registry or MapRegistry()
    maps = {d.name: reg.create(d.name, d.kind, key_size=d.key_size,
                               value_size=d.value_size,
                               max_entries=d.max_entries)
            for d in prog.maps}
    return (compile_host(prog, maps, tier=tier, sync="deferred",
                         n_shards=n_shards), maps["bucket_tune_state"])


def _ref_bridge(n_shards):
    from repro.core.pallasc import compile_host as ref_compile_host
    from repro.policies.telemetry import bucket_tuner as ref_bt
    prog = ref_bt.program
    reg = RefRegistry()
    maps = {d.name: reg.create(d.name, d.kind, key_size=d.key_size,
                               value_size=d.value_size,
                               max_entries=d.max_entries)
            for d in prog.maps}
    return (ref_compile_host(prog, maps, tier="pallas32", mode="jit",
                             sync="deferred", n_shards=n_shards),
            maps["bucket_tune_state"])


def _calls(seed=3):
    """(shard, coll, size) per call: 4 shards, several sizes and colls."""
    rng = np.random.default_rng(seed)
    return [(int(s), int(c), 1 << int(b)) for s, c, b in zip(
        rng.integers(0, 4, 40), rng.integers(0, 3, 40),
        rng.choice([12, 16, 20, 24], 40))]


def _ctx(ns, coll, size):
    return ns.make_ctx("tuner", coll_type=coll, msg_size=size, n_ranks=8,
                       max_channels=32).buf


@pytest.mark.parametrize("tier", ["torch", "cuda32@cpu"])
def test_mesh_bridge_merge_equals_reference(tier, monkeypatch):
    import repro.core as ref_core
    import repro_torch.core as port_core
    ref, ref_map = _ref_bridge(4)
    port, port_map = _port_bridge(4, tier, monkeypatch)
    for flush_at in (20, 40):
        for shard, coll, size in _calls()[flush_at - 20:flush_at]:
            ref.set_shard(shard)
            port.set_shard(shard)
            want = ref(_ctx(ref_core, coll, size))
            assert port(_ctx(port_core, coll, size)) == want
        assert port.flush() == ref.flush() == 1
        assert port_map.to_device().tobytes() == \
            ref_map.to_device().tobytes()
    assert port.stats.shard_merges == ref.stats.shard_merges == 2
    assert port.stats.merge_dropped_keys == ref.stats.merge_dropped_keys


@pytest.mark.parametrize("order", [list(range(8)), [5, 2, 7, 0, 3, 6, 1, 4]])
@pytest.mark.parametrize("tier", ["torch", "cuda32@cpu"])
def test_bridge_1_vs_8_shards_bit_identical(tier, order, monkeypatch):
    import repro_torch.core as port_core
    b1, m1 = _port_bridge(1, tier, monkeypatch)
    for _ in range(24):
        b1(_ctx(port_core, CollType.ALL_REDUCE, 1 << 20))
    b1.flush()
    b8, m8 = _port_bridge(8, tier, monkeypatch)
    for _ in range(3):
        for s in order:
            b8.set_shard(s)
            b8(_ctx(port_core, CollType.ALL_REDUCE, 1 << 20))
    b8.flush()
    assert np.array_equal(m1.to_device(), m8.to_device())
    assert b8.stats.shard_merges == 1
    assert b8.flush() == 0           # shard copies dropped after the merge


def test_bridge_set_shard_and_unmergeable_maps():
    b, _ = _port_bridge(4, "torch", None)
    with pytest.raises(BridgeError, match="out of range"):
        b.set_shard(4)
    with pytest.raises(BridgeError, match="out of range"):
        b.set_shard(-1)
    from repro_torch.policies.profiler import straggler_trap
    with pytest.raises(BridgeError, match="no order-free shard merge: "
                       "ema_map \\(lru_hash\\)"):
        compile_host(straggler_trap.program, {}, tier="torch",
                     sync="deferred", n_shards=2)


def test_runtime_mesh_bridges_and_host_tier_see_merged_keys():
    """A host-tier chain and a mesh-mode bridge share one map: after the
    merged flush the host program sees the keys the shards added."""
    rt = PolicyRuntime(tier="interp")
    rt.load(bucket_tuner.program)
    bridge, m = _port_bridge(4, "torch", None, registry=rt.maps)
    import repro_torch.core as port_core
    for shard in range(4):
        bridge.set_shard(shard)
        for _ in range(3):
            bridge(_ctx(port_core, CollType.ALL_REDUCE, 1 << 20))
    bridge.flush()
    ctx = make_ctx("tuner", coll_type=CollType.ALL_REDUCE, msg_size=1 << 20,
                   n_ranks=8, max_channels=32)
    assert rt.invoke("tuner", ctx) == 13          # 12 merged + this one
    assert ctx["algorithm"] == Algo.RING
    rt2 = PolicyRuntime(tier="torch", bridge_sync="deferred",
                        bridge_shards=4)
    lp = rt2.load(bucket_tuner.program)
    assert lp.fn.n_shards == 4


# ---------------------------------------------------------------------------
# in-graph shard states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["torch", "cuda32@cpu"])
def test_ingraph_merge_equals_reference(tier, monkeypatch):
    from repro.collectives.ingraph import InGraphSelector as RefSelector
    from repro.policies.telemetry import bucket_tuner as ref_bt
    from repro_torch.collectives import ingraph
    if tier == "cuda32@cpu":
        monkeypatch.setattr(ingraph, "require_cuda",
                            lambda what: torch.device("cpu"))
        tier = "cuda32"
    sel = ingraph.InGraphSelector(bucket_tuner.program, tier=tier)
    ref = RefSelector(ref_bt.program, tier="pallas32")
    reg, rreg = MapRegistry(), RefRegistry()
    base, rbase = sel.init_state(reg), ref.init_state(rreg)
    sizes = [[1 << 20, 4 << 10, 1 << 20], [64 << 10] * 2, [], [1 << 30]]
    shards, rshards = [], []
    for seq in sizes:
        st, rst = dict(base), dict(rbase)
        for size in seq:
            _, _, st = sel.decide(st, coll=0, msg_bytes=size, n=8)
            _, _, rst = ref.decide(rst, coll=0, msg_bytes=size, n=8)
        shards.append(st)
        rshards.append(rst)
    stats, rstats = {}, {}
    assert sel.merge_shard_states(reg, shards, base, stats) == \
        ref.merge_shard_states(rreg, rshards, rbase, rstats) == 1
    assert reg.get("bucket_tune_state").to_device().tobytes() == \
        rreg.get("bucket_tune_state").to_device().tobytes()
    assert stats.get("dropped_keys", 0) == rstats.get("dropped_keys", 0)
    # independent of shard order: a fresh registry, shards reversed
    reg2 = MapRegistry()
    base2 = sel.init_state(reg2)
    sel.merge_shard_states(reg2, shards[::-1], base2)
    assert np.array_equal(reg2.get("bucket_tune_state").to_device(),
                          reg.get("bucket_tune_state").to_device())
    # the stacked form splits back into the same shard states
    stacked = {k: torch.stack([s[k] for s in shards]) for k in shards[0]}
    split = ingraph.InGraphSelector.unstack_sharded(stacked)
    assert len(split) == 4 and all(
        torch.equal(split[i][k], shards[i][k]) for i in range(4)
        for k in shards[0])


def test_unstack_sharded_requires_a_consistent_axis():
    from repro_torch.collectives.ingraph import InGraphSelector
    good = {"a": np.zeros((2, 3)), "b": torch.zeros(2)}
    assert len(InGraphSelector.unstack_sharded(good)) == 2
    with pytest.raises(ValueError, match="inconsistent leading device axis"):
        InGraphSelector.unstack_sharded({"a": np.zeros((2, 3)),
                                         "b": np.zeros((3,))})
