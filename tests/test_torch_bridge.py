"""The port's device bridge (``repro_torch.core.bridge``): the
single-shard contracts of ``tests/test_device_bridge.py`` and the bridge
cases of ``tests/test_faults.py``, on ``tier="torch"`` (the plain
PyTorch policy kernel with its maps resident in CPU tensors).

  * warm repeat calls perform ZERO map uploads while host maps are
    clean; a host mutation between calls IS picked up;
  * lookup-only maps never sync back, not even at ``flush()``;
  * kernel-written state reaches the host per call under ``step`` and
    exactly at ``flush()`` / detach / ``link.replace()`` / reload /
    bundle reload under ``deferred``;
  * upload faults retry, then run one call on the host VM (counted);
    out-of-domain decisions are counted and drained at flush;
  * a flush never writes back a device copy older than the host map.
"""

import pytest

from repro_torch.core import (FaultInjector, InjectedFault, PolicyRuntime,
                              make_ctx, map_decl, policy)
from repro_torch.core.bridge import BridgeError, compile_host
from repro_torch.core.context import Algo
from repro_torch.policies import (adapt_profiler, adapt_tuner,
                                  bucket_tuner, table1 as T)
from repro_torch.policies.loops import (histogram_bucket_tuner,
                                        latency_argmin_tuner)

CTX_KW = dict(msg_size=8 << 20, comm_id=0, n_ranks=8, max_channels=32)


def _seed_argmin(rt):
    m = rt.maps.get("config_lat_map")
    for k in range(0, m.max_entries, 5):
        m.update_u64(k, 900 + 13 * k, slot=0)


def test_warm_repeat_calls_zero_uploads():
    rt = PolicyRuntime(tier="torch")
    lp = rt.load(latency_argmin_tuner.program)
    _seed_argmin(rt)
    bridge = lp.fn
    for _ in range(3):
        rt.invoke("tuner", make_ctx("tuner", **CTX_KW))
    assert bridge.stats.calls == 3
    assert bridge.stats.map_uploads == len(latency_argmin_tuner.program.maps)
    assert bridge.stats.map_downloads == 0


def test_host_mutation_between_calls_is_picked_up():
    rt = PolicyRuntime(tier="torch")
    rt.load(latency_argmin_tuner.program)
    bridge = rt.attached("tuner").fn
    m = rt.maps.get("config_lat_map")
    m.update_u64(11, 50)
    m.update_u64(3, 900)
    ctx = make_ctx("tuner", **CTX_KW)
    rt.invoke("tuner", ctx)
    assert ctx["n_channels"] == 12
    ups = bridge.stats.map_uploads
    ctx = make_ctx("tuner", **CTX_KW)
    rt.invoke("tuner", ctx)
    assert ctx["n_channels"] == 12 and bridge.stats.map_uploads == ups
    m.update_u64(4, 7)
    ctx = make_ctx("tuner", **CTX_KW)
    rt.invoke("tuner", ctx)
    assert ctx["n_channels"] == 5
    assert bridge.stats.map_uploads == ups + 1


def test_step_sync_written_state_visible_immediately():
    rt = PolicyRuntime(tier="torch")
    rt.load(histogram_bucket_tuner.program)
    m = rt.maps.get("size_hist_map")
    before = m.lookup_u64(23)
    rt.invoke("tuner", make_ctx("tuner", **CTX_KW))
    assert m.lookup_u64(23) == before + 1


def test_deferred_sync_state_lands_at_flush():
    rt = PolicyRuntime(tier="torch", bridge_sync="deferred")
    bridge = rt.load(histogram_bucket_tuner.program).fn
    m = rt.maps.get("size_hist_map")
    for _ in range(4):
        rt.invoke("tuner", make_ctx("tuner", **CTX_KW))
    assert m.lookup_u64(23) == 0
    assert bridge.stats.map_downloads == 0
    assert bridge.flush() >= 1
    assert m.lookup_u64(23) == 4


@pytest.mark.parametrize("boundary", ["detach", "reload", "replace",
                                      "bundle"])
def test_deferred_sync_flushes_at_every_t3_boundary(boundary):
    rt = PolicyRuntime(tier="torch", bridge_sync="deferred")
    lp = rt.load(histogram_bucket_tuner.program)
    link = rt.chain("tuner")[0]
    m = rt.maps.get("size_hist_map")
    rt.invoke("tuner", make_ctx("tuner", **CTX_KW))
    assert m.lookup_u64(23) == 0
    if boundary == "detach":
        rt.detach("tuner")
    elif boundary == "reload":
        rt.reload(histogram_bucket_tuner.program)
    elif boundary == "replace":
        link.replace(latency_argmin_tuner.program)
    else:
        rt.load_bundle([latency_argmin_tuner.program])
    assert m.lookup_u64(23) == 1
    assert lp.fn.stats.flushes == 1


def test_successor_seeds_from_flushed_maps():
    rt = PolicyRuntime(tier="torch", bridge_sync="deferred")
    old = rt.load(histogram_bucket_tuner.program)
    m = rt.maps.get("size_hist_map")
    for _ in range(2):
        rt.invoke("tuner", make_ctx("tuner", **CTX_KW))
    rt.reload(histogram_bucket_tuner.program)
    assert m.lookup_u64(23) == 2 and old.fn.stats.flushes == 1
    rt.invoke("tuner", make_ctx("tuner", **CTX_KW))
    rt.attached("tuner").fn.flush()
    assert m.lookup_u64(23) == 3


def test_invalidate_forces_reupload():
    rt = PolicyRuntime(tier="torch")
    bridge = rt.load(latency_argmin_tuner.program).fn
    rt.invoke("tuner", make_ctx("tuner", **CTX_KW))
    ups = bridge.stats.map_uploads
    bridge.invalidate()
    rt.invoke("tuner", make_ctx("tuner", **CTX_KW))
    assert bridge.stats.map_uploads == ups + len(
        latency_argmin_tuner.program.maps)


def test_flush_never_writes_back_lookup_only_maps():
    rt = PolicyRuntime(tier="torch")
    bridge = rt.load(latency_argmin_tuner.program).fn
    _seed_argmin(rt)
    rt.invoke("tuner", make_ctx("tuner", **CTX_KW))
    m = rt.maps.get("config_lat_map")
    m.update_u64(11, 777)
    assert bridge.flush() == 0
    assert m.lookup_u64(11) == 777
    rt.detach("tuner")
    assert m.lookup_u64(11) == 777


def test_flush_keeps_host_writes_to_a_shared_written_map():
    """adapt_tuner and adapt_profiler both write the pinned adapt_map.
    Under ``step`` the tuner's device copy goes stale as soon as the
    profiler writes; replacing the tuner's link (a T3 flush) must not
    write that stale copy back over the profiler's updates."""
    runs = {}
    for tier in ("interp", "torch"):
        rt = PolicyRuntime(tier=tier)
        link = rt.attach(adapt_tuner.program)
        rt.attach(adapt_profiler.program)
        rt.invoke("tuner", make_ctx("tuner", comm_id=3))
        for lat in (1000, 2000, 3000):
            rt.invoke("profiler", make_ctx("profiler", comm_id=3,
                                           latency_ns=lat))
        link.replace(adapt_tuner.program)
        runs[tier] = rt.maps.get_pinned("adapt_map").to_device()
    assert (runs["torch"] == runs["interp"]).all()
    assert runs["torch"][3, 2] == 3          # three profiler samples kept


def test_runtime_rejects_unknown_bridge_sync():
    with pytest.raises(ValueError, match="bridge_sync"):
        PolicyRuntime(tier="torch", bridge_sync="eager")


def test_bridge_rejects_unknown_sync_tier_and_shards():
    prog = latency_argmin_tuner.program
    with pytest.raises(BridgeError, match="sync"):
        compile_host(prog, {}, tier="torch", sync="lazy")
    with pytest.raises(BridgeError, match="tier"):
        compile_host(prog, {}, tier="pallas")
    # mesh mode merges at flush, so it needs deferred sync
    with pytest.raises(BridgeError, match="deferred"):
        compile_host(prog, {}, tier="torch", n_shards=4)
    with pytest.raises(BridgeError, match="n_shards"):
        compile_host(prog, {}, tier="torch", sync="deferred", n_shards=0)
    with pytest.raises(ValueError, match="deferred"):
        PolicyRuntime(tier="torch", bridge_shards=2)
    with pytest.raises(ValueError, match="bridge_shards"):
        PolicyRuntime(tier="torch", bridge_sync="deferred", bridge_shards=0)


# ---------------------------------------------------------------------------
# fault containment (the bridge cases of tests/test_faults.py)
# ---------------------------------------------------------------------------

def _ema_runtime(tier):
    stats = map_decl("ema_stats", kind="array", value_size=8, max_entries=4)

    @policy(section="tuner", maps=[stats])
    def ema_pol(ctx):
        ema_update(stats, 0, 500, 2)          # noqa: F821 (DSL name)
        return 0

    rt = PolicyRuntime(tier=tier)
    lp = rt.load(ema_pol.program)
    return rt, lp, ema_pol.program


def _ema_want(prog):
    rt = PolicyRuntime(tier="interp")
    rt.load(prog)
    rt.invoke("tuner", make_ctx("tuner"))
    return rt.maps.get("ema_stats").lookup_u64(0)


def test_bridge_upload_retries_then_succeeds():
    rt, lp, prog = _ema_runtime("torch")
    bridge = lp.fn
    with FaultInjector().plan("bridge_upload", count=1):
        assert bridge(make_ctx("tuner").buf) == 0
    assert bridge.stats.upload_retries == 1
    assert bridge.stats.host_fallbacks == 0
    assert rt.maps.get("ema_stats").lookup_u64(0) == _ema_want(prog)


def test_bridge_upload_exhausted_falls_back_to_host_tier():
    rt, lp, prog = _ema_runtime("torch")
    bridge = lp.fn
    with FaultInjector().plan("bridge_upload", prob=1.0) as inj:
        assert bridge(make_ctx("tuner").buf) == 0
        assert inj.stats()["bridge_upload"]["fires"] == \
            1 + bridge.upload_retries
    assert bridge.stats.host_fallbacks == 1
    assert bridge.kernel.launches == 0
    assert rt.maps.get("ema_stats").lookup_u64(0) == _ema_want(prog)


def test_bridge_download_failure_defers_to_flush():
    rt, lp, prog = _ema_runtime("torch")
    bridge = lp.fn
    with FaultInjector().plan("bridge_download", count=1):
        bridge(make_ctx("tuner").buf)
    assert bridge.stats.download_failures == 1
    assert rt.maps.get("ema_stats").lookup_u64(0) == 0
    assert bridge.flush() == 1
    assert rt.maps.get("ema_stats").lookup_u64(0) == _ema_want(prog)


def test_bridge_flush_failure_is_contained():
    rt, _, _ = _ema_runtime("torch")
    rt.invoke("tuner", make_ctx("tuner"))
    with FaultInjector().plan("bridge_flush", prob=1.0):
        rt.detach("tuner")
    assert rt.stats.flush_failures >= 1
    assert not rt.is_attached("tuner")


def test_out_of_domain_decisions_counted_and_drained_at_flush():
    @policy(section="tuner", maps=[])
    def out_of_domain(ctx):
        ctx.algorithm = 9
        ctx.protocol = 1
        ctx.n_channels = 700
        return 0

    rt = PolicyRuntime(tier="torch")
    bridge = rt.load(out_of_domain.program).fn
    for _ in range(3):
        rt.invoke("tuner", make_ctx("tuner"))
    assert bridge.stats.domain_faults == 0
    bridge.flush()
    assert bridge.stats.domain_faults == 3
    bridge.flush()
    assert bridge.stats.domain_faults == 3


def test_replace_atomic_under_compile_fault():
    rt = PolicyRuntime(tier="torch")
    rt.load(T.static_override.program)
    link = rt.chain("tuner")[0]
    epoch = rt.epoch
    with pytest.raises(InjectedFault):
        with FaultInjector().plan("compile", prob=1.0):
            link.replace(T.size_aware.program)
    assert rt.epoch == epoch
    assert rt.stats.compile_failures >= 1
    assert rt.attached("tuner").program.name == "static_override"
    ctx = make_ctx("tuner", msg_size=1 << 20)
    assert rt.invoke("tuner", ctx) == 0
    assert ctx["algorithm"] == Algo.RING


def test_kernel_build_failure_is_a_load_time_rejection(monkeypatch):
    """A kernel that does not build rejects the load with the verifier's
    atomicity: the old chain keeps running and the epoch stays."""
    from repro_torch.core import bridge as B
    from repro_torch.core.cudac import CudacError

    rt = PolicyRuntime(tier="torch")
    link = rt.attach(bucket_tuner.program)
    epoch = rt.epoch

    def broken(*a, **kw):
        raise CudacError("nvcc failed (1): injected")

    monkeypatch.setattr(B, "compile_host", broken)
    with pytest.raises(CudacError):
        link.replace(T.static_override.program)
    assert rt.epoch == epoch
    assert rt.stats.compile_failures == 1
    assert rt.attached("tuner").program.name == "bucket_tuner"
