"""The slice as a whole: authoring -> verifier -> runtime -> bridge ->
policy kernel -> ``CollectiveDispatcher.decide()``, port against
reference.

A seeded 256-decision stream over the §5.3 closed loop (bucket_tuner and
adapt_tuner on the tuner chain, adapt_profiler and bucket_profiler fed
between decisions, a ``link.replace()`` half way) runs through the
reference ``CollectiveDispatcher(runtime=PolicyRuntime(tier="pallas"))``
(the Pallas policy kernel, interpret mode) and through the port on
``tier="torch"`` and ``tier="interp"``.  The ``Decision`` sequences and
every final map must be identical.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

N_DECISIONS = 256


def _stream(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    return list(zip(rng.choice([0, 1, 2], n).tolist(),
                    np.left_shift(1, rng.integers(12, 31, n)).tolist(),
                    rng.choice(["dp", "tp", "ep"], n).tolist(),
                    rng.integers(2_000, 3_000_000, n).tolist()))


def _drive(PolicyRuntime, CollectiveDispatcher, pols, tier, stream):
    rt = PolicyRuntime(tier=tier)
    disp = CollectiveDispatcher(runtime=rt)
    tune = rt.attach(pols.bucket_tuner.program, priority=0)
    rt.attach(pols.adapt_tuner.program, priority=1)
    rt.attach(pols.adapt_profiler.program)
    rt.attach(pols.bucket_profiler.program)
    out = []
    for i, (coll, size, axis, lat) in enumerate(stream):
        if i == len(stream) // 2:
            tune.replace(pols.bucket_tuner.program)
        d = disp.decide(coll, size, 8, axis_name=axis)
        out.append(dataclasses.astuple(d))
        disp.profiler_feed(d.comm_id, lat, coll=d.coll,
                           msg_size=d.size_bytes, channels=d.channels,
                           algo=d.algo)
    rt.flush_bridges()
    maps = {n: rt.maps.get(n).to_device().tobytes()
            for n in sorted(rt.maps.names())}
    return out, maps, rt


def test_decision_stream_matches_reference_pallas():
    from repro.compat import have_x64
    if not have_x64():
        pytest.skip("jax build lacks a working enable_x64")
    import repro.policies as ref_pols
    from repro.collectives import CollectiveDispatcher as RefDispatcher
    from repro.core import PolicyRuntime as RefRuntime

    import repro_torch.policies as pols
    from repro_torch.collectives import CollectiveDispatcher
    from repro_torch.core import PolicyRuntime

    stream = _stream(N_DECISIONS)
    want, want_maps, _ = _drive(RefRuntime, RefDispatcher, ref_pols,
                                "pallas", stream)
    for tier in ("torch", "interp"):
        got, got_maps, rt = _drive(PolicyRuntime, CollectiveDispatcher,
                                   pols, tier, stream)
        assert got == want, tier
        assert got_maps == want_maps, tier
    assert rt.maps.pinned_names() == ["adapt_map"]
    assert sum(row[-1] for row in want) == N_DECISIONS   # all from policy


def _package(reference: bool) -> types.SimpleNamespace:
    """One package's decide-path surface: the reference on its
    interpreter, or the port on its plain PyTorch kernel behind the
    bridge."""
    if reference:
        import repro.policies as pols
        from repro.collectives import dispatch
        from repro.core import (BreakerConfig, FaultInjector, PolicyRuntime,
                                policy)
        tier = "interp"
    else:
        import repro_torch.policies as pols
        from repro_torch.collectives import dispatch
        from repro_torch.core import (BreakerConfig, FaultInjector,
                                      PolicyRuntime, policy)
        tier = "torch"
    return types.SimpleNamespace(
        pols=pols, dispatch=dispatch, BreakerConfig=BreakerConfig,
        FaultInjector=FaultInjector, PolicyRuntime=PolicyRuntime,
        policy=policy, tier=tier)


def _guarded(ns, tuner, **cfg):
    rt = ns.PolicyRuntime(tier=ns.tier,
                          breaker=ns.BreakerConfig(enabled=False))
    rt.load(tuner)
    cfg.setdefault("enable_decision_cache", False)
    disp = ns.dispatch.CollectiveDispatcher(
        runtime=rt, config=ns.dispatch.DispatchConfig(**cfg))
    return rt, disp


def _decide(disp, size=8 << 20, n_ranks=8):
    return dataclasses.astuple(disp.decide(0, size, n_ranks, axis_name="dp"))


def _safe_mode(ns):
    rt, disp = _guarded(ns, ns.pols.size_aware.program, safe_mode_threshold=3,
                        safe_mode_window=50, safe_mode_cooldown=4)
    out = []
    with ns.FaultInjector().plan("decide", prob=1.0):
        out += [_decide(disp) for _ in range(3)]
    out.append(disp.safe_mode)
    out += [_decide(disp) for _ in range(4)]     # cooldown, then re-probe
    out.append((disp.safe_mode, rt.stats.invocations))
    with ns.FaultInjector().plan("decide", prob=1.0):
        out += [_decide(disp) for _ in range(3)]
    disp.clear_safe_mode()
    out += [disp.safe_mode, _decide(disp)]
    return out + [dataclasses.asdict(disp.fault_stats)]


def _sanitize(ns):
    _, disp = _guarded(ns, ns.pols.size_aware.program)
    out = [_decide(disp, size=float("nan")), _decide(disp, float("inf"), -3),
           _decide(disp, -5.0, 0)]
    return out + [dataclasses.asdict(disp.fault_stats), disp.safe_mode]


def _out_of_domain(ns):
    def broken_choice(ctx):
        ctx.algorithm = 250
        ctx.protocol = 1
        ctx.n_channels = 4
        return 0

    rt, disp = _guarded(ns, ns.policy(section="tuner", maps=[])(
        broken_choice).program)
    out = [_decide(disp) for _ in range(3)]
    rt.flush_bridges()
    return out + [dataclasses.asdict(disp.fault_stats),
                  rt.chain("tuner")[0].faults]


def _net_hook(ns):
    rt, disp = _guarded(ns, ns.pols.size_aware.program)
    rt.load(ns.pols.net_accounting.program)
    out = [_decide(disp, size=1 << s) for s in range(12, 31, 3)]
    rt.flush_bridges()
    return out + [{n: rt.maps.get(n).to_device().tobytes()
                   for n in sorted(rt.maps.names())}]


def _sync_telemetry(ns):
    _, disp = _guarded(ns, ns.pols.size_aware.program,
                       telemetry_sync_every=3)
    calls = []
    disp.register_mesh_sync(lambda: calls.append(len(calls)))
    out = [_decide(disp, size=(1 + i % 2) << 20) for i in range(7)]
    out.append((list(calls), disp.telemetry_syncs))
    out.append((disp.sync_telemetry(), disp.telemetry_syncs))
    return out


@pytest.mark.parametrize("scenario", [_safe_mode, _sanitize, _out_of_domain,
                                      _net_hook, _sync_telemetry],
                         ids=lambda f: f.__name__.strip("_"))
def test_guarded_decide_path_matches_reference(scenario):
    """Guards, safe mode, out-of-domain accounting, the net hook and the
    telemetry sync give the reference's decisions and counters."""
    assert scenario(_package(False)) == scenario(_package(True))


def test_cuda_tier_without_a_device_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.collectives import CollectiveDispatcher
    from repro_torch.collectives import dispatch
    from repro_torch.core import PolicyRuntime, runtime
    from repro_torch.device import DeviceError

    with pytest.raises(DeviceError, match="CUDA device"):
        PolicyRuntime()
    with pytest.raises(DeviceError, match="tier='torch'"):
        PolicyRuntime(tier="cuda")
    with pytest.raises(DeviceError, match="cuda32"):
        PolicyRuntime(tier="cuda32")
    with pytest.raises(DeviceError):
        CollectiveDispatcher(tier="cuda")
    runtime.reset_global_runtime()
    with pytest.raises(DeviceError):
        dispatch.reset_dispatcher()          # default: the global runtime
    with pytest.raises(ValueError,
                       match="valid tiers: cuda, cuda32, torch, interp"):
        PolicyRuntime(tier="pallas")


def test_pure_chain_decisions_are_memoized_per_epoch():
    from repro_torch.collectives import CollectiveDispatcher
    from repro_torch.core import PolicyRuntime
    from repro_torch.policies import table1 as T

    rt = PolicyRuntime(tier="torch")
    disp = CollectiveDispatcher(runtime=rt)
    rt.load(T.static_override.program)
    bridge = rt.attached("tuner").fn
    first = [disp.decide(0, 1 << 20, 8) for _ in range(4)]
    assert disp.cache_hits == 3 and bridge.stats.calls == 1
    assert all(d == first[0] for d in first) and first[0].from_policy
    rt.reload(T.static_override.program)     # epoch bump: miss, re-run
    disp.decide(0, 1 << 20, 8)
    assert disp.cache_misses == 2


def test_env_chain_sets_dispatcher_defaults():
    from repro_torch.collectives import CollectiveDispatcher, DispatchConfig
    from repro_torch.core import PolicyRuntime
    from repro_torch.policies import env_defaults

    rt = PolicyRuntime(tier="torch")
    rt.load(env_defaults.program)
    disp = CollectiveDispatcher(runtime=rt, config=DispatchConfig())
    assert disp.apply_env(n_pods=2)
    assert disp.config.default_channels == 4
    assert disp.config.max_channels == 16
