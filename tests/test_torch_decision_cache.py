"""Decision-cache semantics of the port's dispatcher (the reference's
``tests/test_decision_cache.py`` run on ``repro_torch``, on the ``jit``
tier the reference defaults to): memoized dispatch must never violate the
paper's T3 hot-reload guarantee (a swap takes effect on the very next
decision), must never cache stateful policies, and the decision log must
stay bounded."""

import pytest

from repro_torch.collectives.dispatch import (CollectiveDispatcher,
                                              DispatchConfig, _comm_id)
from repro_torch.core import PolicyRuntime
from repro_torch.core.context import Algo, CollType
from repro_torch.policies import bad_channels, static_override
from repro_torch.policies import table1 as T


def _decide(disp, size=8 << 20, n=8, axis="dp"):
    return disp.decide(CollType.ALL_REDUCE, size, n, axis_name=axis)


def test_pure_policy_decisions_are_cached():
    rt = PolicyRuntime(tier="jit")
    rt.load(static_override.program)
    disp = CollectiveDispatcher(runtime=rt)
    d1 = _decide(disp)
    d2 = _decide(disp)
    assert d2 is d1                      # memoized object, not re-derived
    assert disp.cache_hits == 1 and disp.cache_misses == 1
    assert rt.stats.invocations == 1     # policy ran exactly once
    # different key -> miss
    d3 = _decide(disp, size=1 << 20)
    assert d3 is not d1
    assert disp.cache_misses == 2


def test_hot_reload_invalidates_decision_cache():
    """T3: the next decide() after a swap must reflect the new policy —
    no stale fast-path hits."""
    rt = PolicyRuntime(tier="jit")
    rt.load(static_override.program)     # n_channels = 8
    disp = CollectiveDispatcher(runtime=rt)
    d1 = _decide(disp)
    assert d1.channels == 8
    assert _decide(disp) is d1           # warm hit before the swap

    rt.reload(bad_channels.program)      # n_channels = 1
    d2 = _decide(disp)
    assert d2.channels == 1, "cache served a stale pre-reload decision"
    assert _decide(disp) is d2           # re-cached under the new epoch

    # swap back: epoch bumps again, cache follows
    rt.reload(static_override.program)
    assert _decide(disp).channels == 8


def test_detach_invalidates_decision_cache():
    rt = PolicyRuntime(tier="jit")
    rt.load(static_override.program)
    disp = CollectiveDispatcher(runtime=rt)
    d1 = _decide(disp)
    assert d1.from_policy
    rt.detach("tuner")
    d2 = _decide(disp)
    assert not d2.from_policy            # framework default, not stale hit
    assert d2.algo == Algo.DEFAULT


def test_stateful_policies_bypass_cache():
    """Any helper call (map state, clock, randomness) disables memoization:
    the policy must observe every dispatch."""
    rt = PolicyRuntime(tier="jit")
    rt.load(T.latency_feedback.program)  # lookup + update per call
    disp = CollectiveDispatcher(runtime=rt)
    n_calls = 5
    for _ in range(n_calls):
        _decide(disp)
    assert rt.stats.invocations == n_calls
    assert disp.cache_hits == 0
    # the map state really evolved call by call
    st = rt.maps.get("latency_map").lookup_u64(d1_comm_id(disp), slot=1)
    assert st == 4 + (n_calls - 1)


def d1_comm_id(disp):
    return disp.decisions[-1].comm_id


def test_cache_can_be_disabled():
    rt = PolicyRuntime(tier="jit")
    rt.load(static_override.program)
    disp = CollectiveDispatcher(
        runtime=rt, config=DispatchConfig(enable_decision_cache=False))
    _decide(disp)
    _decide(disp)
    assert disp.cache_hits == 0
    assert rt.stats.invocations == 2


def test_cached_hits_still_feed_log_and_net_hook():
    from repro_torch.policies import net_accounting
    rt = PolicyRuntime(tier="jit")
    rt.load(static_override.program)
    rt.load(net_accounting.program)
    disp = CollectiveDispatcher(runtime=rt)
    for _ in range(4):
        _decide(disp)
    assert len(disp.decisions) == 4      # every dispatch logged
    assert disp.net_calls == 4           # data plane saw every dispatch


def test_decision_log_is_bounded_ring_buffer():
    disp = CollectiveDispatcher(
        runtime=PolicyRuntime(tier="jit"),
        config=DispatchConfig(decision_log_max=16))
    for i in range(100):
        _decide(disp, size=(i + 1) << 10)
    assert len(disp.decisions) == 16
    # ring semantics: the newest decisions survive
    assert disp.decisions[-1].size_bytes == 100 << 10
    assert disp.decisions[0].size_bytes == 85 << 10
    disp.clear_log()
    assert len(disp.decisions) == 0


def test_default_log_bound_is_4096():
    disp = CollectiveDispatcher(runtime=PolicyRuntime(tier="jit"))
    assert disp.decisions.maxlen == 4096


def test_comm_id_is_cached_and_stable():
    _comm_id.cache_clear()
    a = _comm_id("dp", 8)
    info0 = _comm_id.cache_info()
    b = _comm_id("dp", 8)
    info1 = _comm_id.cache_info()
    assert a == b
    assert info1.hits == info0.hits + 1
    assert _comm_id("dp", 16) != a       # n participates in the hash


# ---------------------------------------------------------------------------
# Within-epoch overflow: bounded eviction, not a full flush
# ---------------------------------------------------------------------------

def test_overflow_evicts_oldest_half_not_everything():
    """Pre-fix the cache did clear() at 4096 entries, wiping the hot
    newest entries too and causing a periodic full-recompute storm under
    bursts of distinct keys.  Overflow must keep (at least) the newest
    half warm."""
    rt = PolicyRuntime(tier="jit")
    rt.load(static_override.program)
    disp = CollectiveDispatcher(runtime=rt)
    cap = disp.config.decision_cache_max
    for i in range(cap):                     # fill to the brim
        _decide(disp, size=(i + 1) << 10)
    assert disp.decision_cache_len == cap
    _decide(disp, size=(cap + 1) << 10)      # overflow: evict, then insert
    assert disp.decision_cache_len == cap // 2 + 1

    # the newest half is still warm: re-deciding the most recent keys hits
    hits0 = disp.cache_hits
    _decide(disp, size=cap << 10)
    _decide(disp, size=(cap - 1) << 10)
    assert disp.cache_hits == hits0 + 2, \
        "hot entries were wiped by the overflow handling"
    # the oldest half really was dropped (bounded memory, not a leak)
    misses0 = disp.cache_misses
    _decide(disp, size=1 << 10)
    assert disp.cache_misses == misses0 + 1


def test_overflow_keeps_cache_bounded_under_key_bursts():
    rt = PolicyRuntime(tier="jit")
    rt.load(static_override.program)
    disp = CollectiveDispatcher(runtime=rt)
    cap = disp.config.decision_cache_max
    for i in range(3 * cap):
        _decide(disp, size=(i + 1) << 10)
    assert disp.decision_cache_len <= cap


# ---------------------------------------------------------------------------
# decide() racing a hot-reload epoch bump
# ---------------------------------------------------------------------------

def test_inflight_decide_cannot_poison_cache_across_swap(monkeypatch):
    """Two threads pass the epoch check, then a hot-reload swaps in a
    STATEFUL policy before they reach the cache.  The first thread runs
    the new chain; its decision must NOT be planted where the second
    (still in-flight) thread's cache lookup finds it — a stateful
    chain's decisions may never be served from the cache (its map state
    moves between calls).  T3 allows the in-flight thread to see the OLD
    policy or the new chain's FRESH state, never the stale cached copy."""
    import threading

    from repro_torch.collectives import dispatch as dispatch_mod

    rt = PolicyRuntime(tier="jit")
    link = rt.attach(static_override.program)      # pure: channels == 8
    disp = CollectiveDispatcher(runtime=rt)
    _decide(disp)                                  # sync the generation

    gates = [threading.Event(), threading.Event()]
    parked = []
    real = dispatch_mod._comm_id

    def gated(axis_name, n):
        if axis_name == "bb":
            ev = gates[len(parked)]
            parked.append(ev)
            assert ev.wait(10)
        return real(axis_name, n)
    monkeypatch.setattr(dispatch_mod, "_comm_id", gated)

    results = {}

    def worker(tag):
        results[tag] = _decide(disp, axis="bb").channels
    t1 = threading.Thread(target=worker, args=("t1",))
    t2 = threading.Thread(target=worker, args=("t2",))
    t1.start()
    t2.start()
    while len(parked) < 2:                         # both past the epoch check
        pass

    # concurrent hot-reload: stateful size_aware reads chan_map[0]
    link.replace(T.size_aware.program)
    rt.maps.get("chan_map").update_u64(0, 11)
    gates[0].set()
    t1.join(10)
    assert results["t1"] in (8, 11)                # in-flight: either is fine

    rt.maps.get("chan_map").update_u64(0, 22)      # state moved on
    gates[1].set()
    t2.join(10)
    assert results["t2"] != 11, \
        "stale stateful decision was served from the cache"
    assert results["t2"] in (8, 22)

    # once the swap is visible, every decide runs the live chain
    rt.maps.get("chan_map").update_u64(0, 13)
    assert _decide(disp).channels == 13


def test_resync_pairs_epoch_fingerprint_and_purity_atomically():
    """The generation tuple must describe ONE chain: epoch, fingerprint
    and the purity verdict move together even when a swap lands during
    the resync probe (pre-fix these were three separate attribute writes
    interleavable with the swap)."""
    rt = PolicyRuntime(tier="jit")
    rt.attach(static_override.program)
    disp = CollectiveDispatcher(runtime=rt)
    _decide(disp)
    gen = disp._cache_gen
    assert gen[0] == rt.epoch
    assert gen[1] == rt.chain_fingerprint("tuner")
    assert gen[2] is True                          # pure chain

    rt.reload(T.size_aware.program)                # stateful now
    _decide(disp)
    gen = disp._cache_gen
    assert gen[0] == rt.epoch
    assert gen[1] == rt.chain_fingerprint("tuner")
    assert gen[2] is False                         # purity re-probed


def test_concurrent_decides_and_reloads_stay_consistent():
    """Stress: hammer decide() from four threads while the main thread
    alternates pure/stateful hot-reloads.  Every observed decision must
    be explainable by some chain that was attached around that time —
    never a torn mix."""
    import threading

    rt = PolicyRuntime(tier="jit")
    rt.load(static_override.program)               # channels 8
    disp = CollectiveDispatcher(runtime=rt)
    stop = threading.Event()
    bad = []

    def worker():
        while not stop.is_set():
            ch = _decide(disp).channels
            if ch not in (8, 11):
                bad.append(ch)
    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    rt.maps.create("chan_map", "array", value_size=8, max_entries=256)
    rt.maps.get("chan_map").update_u64(0, 11)
    for _ in range(60):
        rt.reload(T.size_aware.program)            # stateful: reads 11
        rt.reload(static_override.program)         # pure: 8
    stop.set()
    for t in threads:
        t.join(10)
    assert not bad, f"saw impossible decisions {set(bad)}"
