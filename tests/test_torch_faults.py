"""Fault containment end-to-end on the port (the reference's
``tests/test_faults.py`` run on ``repro_torch``; the reference's
in-graph tiers become ``torch`` here and ``cuda``/``cuda32`` on the card,
marked ``cuda``): the deterministic injector itself,
per-link circuit breakers, dispatcher safe mode, device-bridge
retry/host-fallback, in-graph clamp + fault-flag drain, and hot-reload
atomicity under injected tier-compile failures.

The contract under test (ISSUE 6): no fault at any trust boundary ever
escapes ``decide()``; the decision under fault is always in-domain and
degrades to the cost-model default; tripped links are visible in
``health()``; hot reload keeps the old chain on ANY load-time failure.
"""

import pytest
import torch

import torch_ref
from repro.core import PolicyRuntime as RefRuntime
from repro.core import make_ctx as ref_make_ctx
from repro_torch.collectives.dispatch import (CollectiveDispatcher,
                                              DispatchConfig)
from repro_torch.core import (BreakerConfig, FaultInjector, InjectedFault,
                              MapRegistry, PolicyRuntime, make_ctx, map_decl,
                              policy)
from repro_torch.core import faults as faults_mod
from repro_torch.core.cc import have_cc
from repro_torch.core.context import Algo, CollType, Proto
from repro_torch.policies import table1 as T

MiB = 1 << 20
# every host tier and the policy kernel's plain version; native is
# skipped at run time without a C toolchain, the card tiers below
ALL_TIERS = ["interp", "jit", "torch", "native"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import have_nvcc
    if not have_nvcc():
        pytest.skip("needs nvcc")


def _decide(disp, size=8 * MiB):
    return disp.decide(CollType.ALL_REDUCE, size, 8, axis_name="dp")


def _disp(rt, **cfg):
    cfg.setdefault("enable_decision_cache", False)
    return CollectiveDispatcher(runtime=rt, config=DispatchConfig(**cfg))


# ---------------------------------------------------------------------------
# the injector itself
# ---------------------------------------------------------------------------

def test_fire_without_injector_is_noop():
    faults_mod.fire("helper", "anything")     # must not raise


def test_injector_probability_is_seed_deterministic():
    def trace(seed):
        out = []
        with FaultInjector(seed=seed).plan("helper", prob=0.5):
            for _ in range(64):
                try:
                    faults_mod.fire("helper")
                    out.append(0)
                except InjectedFault:
                    out.append(1)
        return out
    assert trace(11) == trace(11)
    assert trace(11) != trace(12)


def test_injector_count_every_max_fires_and_match():
    inj = FaultInjector().plan("helper", count=2) \
                         .plan("compile", every=2, max_fires=2,
                               match="cuda")
    hits = []
    with inj:
        for _ in range(5):
            try:
                faults_mod.fire("helper")
                hits.append(0)
            except InjectedFault:
                hits.append(1)
        # match filter: non-matching details are not even evaluated
        for _ in range(4):
            faults_mod.fire("compile", "jit")
        comp = []
        for _ in range(8):
            try:
                faults_mod.fire("compile", "cuda32")
                comp.append(0)
            except InjectedFault:
                comp.append(1)
    assert hits == [1, 1, 0, 0, 0]            # first `count` evals fire
    assert comp == [0, 1, 0, 1, 0, 0, 0, 0]   # every 2nd, capped at 2
    st = inj.stats()
    assert st["helper"] == {"evals": 5, "fires": 2}
    assert st["compile"]["fires"] == 2


def test_injector_custom_exception_class():
    with FaultInjector().plan("decide", count=1, exc=TimeoutError):
        with pytest.raises(TimeoutError):
            faults_mod.fire("decide")


def test_injector_unknown_point_rejected():
    with pytest.raises(ValueError):
        FaultInjector().plan("not_a_point", prob=1.0)


# ---------------------------------------------------------------------------
# guarded dispatch
# ---------------------------------------------------------------------------

def test_depth1_policy_exception_falls_back_to_default():
    rt = PolicyRuntime(tier="jit", breaker=BreakerConfig(enabled=False))
    rt.load(T.size_aware.program)
    disp = _disp(rt, safe_mode_threshold=1 << 30)
    base = _decide(CollectiveDispatcher(runtime=PolicyRuntime(tier="jit")))
    with FaultInjector().plan("helper", prob=1.0):
        d = _decide(disp)
    assert d.key() == base.key() and not d.from_policy
    assert disp.fault_stats.policy_exceptions == 1
    assert rt.stats.link_faults == 1
    link = rt.chain("tuner")[0]
    assert link.faults == 1 and link.last_fault is not None
    # healthy again once the injector is gone
    d2 = _decide(disp)
    assert d2.from_policy and d2.algo == Algo.RING


def test_multi_link_chain_contains_faulting_link():
    rt = PolicyRuntime(tier="jit", breaker=BreakerConfig(enabled=False))
    flaky = rt.attach(T.size_aware.program, priority=0)     # uses helpers
    steady = rt.attach(T.static_override.program, priority=10)  # pure
    disp = _disp(rt, safe_mode_threshold=1 << 30)
    with FaultInjector().plan("helper", prob=1.0):
        d = _decide(disp)
    # the surviving link decided; the fault was charged to the right one
    assert d.from_policy and d.algo == Algo.RING and d.channels == 8
    assert flaky.faults == 1 and steady.faults == 0
    assert rt.last_decider("tuner") is steady
    # contained chain faults still feed the dispatcher's fault window
    assert disp.fault_stats.total == 0   # not a policy_exception...
    assert rt.stats.link_faults == 1     # ...but recorded at the runtime


def test_invalid_decision_counts_fault_and_falls_back():
    @policy(section="tuner", maps=[])
    def broken_choice(ctx):
        ctx.algorithm = 250
        ctx.protocol = 1
        ctx.n_channels = 4
        return 0

    rt = PolicyRuntime(tier="jit", breaker=BreakerConfig(enabled=False))
    rt.load(broken_choice.program)
    disp = _disp(rt, safe_mode_threshold=1 << 30)
    d = _decide(disp)
    assert d.algo == Algo.DEFAULT and not d.from_policy
    assert disp.fault_stats.invalid_decisions == 1
    assert rt.chain("tuner")[0].faults == 1


def test_nan_inf_negative_inputs_sanitized():
    rt = PolicyRuntime(tier="jit")
    rt.load(T.size_aware.program)
    disp = _disp(rt)
    d = _decide(disp, size=float("nan"))
    assert disp.fault_stats.invalid_inputs == 1
    assert 0 <= d.algo < Algo.COUNT and 1 <= d.channels <= 32
    disp.decide(CollType.ALL_REDUCE, float("inf"), -3, axis_name="dp")
    assert disp.fault_stats.invalid_inputs == 3
    # sanitization is not a policy fault: never trips safe mode
    assert disp.fault_stats.total == 0 and not disp.safe_mode


def test_guards_off_exceptions_escape():
    rt = PolicyRuntime(tier="jit")
    rt.load(T.size_aware.program)
    disp = _disp(rt, enable_runtime_guards=False)
    with FaultInjector().plan("decide", prob=1.0):
        with pytest.raises(InjectedFault):
            _decide(disp)


def test_faulted_decision_never_enters_cache():
    rt = PolicyRuntime(tier="jit", breaker=BreakerConfig(enabled=False))
    rt.load(T.static_override.program)      # pure -> cacheable
    disp = CollectiveDispatcher(runtime=rt, config=DispatchConfig(
        safe_mode_threshold=1 << 30))
    with FaultInjector().plan("decide", count=1):
        d1 = _decide(disp)
    assert not d1.from_policy and disp.decision_cache_len == 0
    d2 = _decide(disp)                      # healthy, now cacheable
    assert d2.from_policy and d2.algo == Algo.RING
    assert disp.decision_cache_len == 1


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------

def test_breaker_trips_quarantines_and_resets():
    rt = PolicyRuntime(tier="jit",
                       breaker=BreakerConfig(window=1000, threshold=3))
    rt.load(T.size_aware.program)
    link = rt.chain("tuner")[0]
    disp = _disp(rt, safe_mode_threshold=1 << 30)
    epoch0 = rt.epoch
    with FaultInjector().plan("helper", prob=1.0):
        for _ in range(3):
            _decide(disp)
    assert link.is_quarantined and link.state == "quarantined"
    assert rt.stats.quarantines == 1
    assert rt.epoch > epoch0                # cache-coherence bump
    assert link in rt.chain("tuner")        # still in the tuple...
    assert not rt.is_attached("tuner")      # ...but skipped by dispatch
    h = rt.health()
    assert h["quarantined"] == 1
    assert h["sections"]["tuner"][0]["state"] == "quarantined"
    # quarantined link -> pure defaults, no more faults charged
    d = _decide(disp)
    assert not d.from_policy and link.faults == 3
    # reset re-arms the link and the chain
    link.reset()
    assert link.state == "attached" and rt.is_attached("tuner")
    d = _decide(disp)
    assert d.from_policy and d.algo == Algo.RING


def test_breaker_window_slides_spaced_faults_dont_trip():
    rt = PolicyRuntime(tier="jit",
                       breaker=BreakerConfig(window=2, threshold=2))
    rt.load(T.size_aware.program)
    link = rt.chain("tuner")[0]
    disp = _disp(rt, safe_mode_threshold=1 << 30)
    with FaultInjector().plan("helper", every=5):
        for _ in range(20):
            _decide(disp)
    # 4 faults landed, but 5 invocations apart — outside the window
    assert link.faults == 4 and not link.is_quarantined


def test_dispatcher_health_merges_runtime_and_dispatcher_views():
    rt = PolicyRuntime(tier="jit")
    rt.load(T.static_override.program)
    disp = _disp(rt)
    h = disp.health()
    assert h["tier"] == "jit" and "sections" in h
    assert h["dispatcher"]["safe_mode"] is False
    assert h["dispatcher"]["fault_stats"]["policy_exceptions"] == 0


# ---------------------------------------------------------------------------
# safe mode
# ---------------------------------------------------------------------------

def test_safe_mode_entry_cooldown_and_reprobe():
    rt = PolicyRuntime(tier="jit", breaker=BreakerConfig(enabled=False))
    rt.load(T.size_aware.program)
    disp = _disp(rt, safe_mode_threshold=3, safe_mode_window=50,
                 safe_mode_cooldown=4)
    with FaultInjector().plan("decide", prob=1.0):
        for _ in range(3):
            d = _decide(disp)
            assert not d.from_policy
    assert disp.safe_mode
    assert disp.fault_stats.safe_mode_entries == 1
    # while safe: pure defaults, and the policy chain never runs
    inv = rt.stats.invocations
    for _ in range(3):
        d = _decide(disp)
        assert not d.from_policy
    assert rt.stats.invocations == inv
    assert disp.fault_stats.safe_mode_decisions == 3
    # cooldown elapsed: half-open re-probe goes back to the policy
    d = _decide(disp)
    assert not disp.safe_mode and d.from_policy and d.algo == Algo.RING


def test_clear_safe_mode_is_operator_override():
    rt = PolicyRuntime(tier="jit", breaker=BreakerConfig(enabled=False))
    rt.load(T.size_aware.program)
    disp = _disp(rt, safe_mode_threshold=1, safe_mode_cooldown=1 << 30)
    with FaultInjector().plan("decide", count=1):
        _decide(disp)
    assert disp.safe_mode
    disp.clear_safe_mode()
    assert not disp.safe_mode
    d = _decide(disp)
    assert d.from_policy


# ---------------------------------------------------------------------------
# device bridge: retry, host fallback, flush containment
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
    """ema_stats[0] after one call on the port's interp, which the
    reference's interp must equal."""
    rt_ref = PolicyRuntime(use_interpreter=True)
    rt_ref.load(prog)
    rt_ref.invoke("tuner", make_ctx("tuner"))
    want = rt_ref.maps.get("ema_stats").lookup_u64(0)
    rt_jax = RefRuntime(use_interpreter=True)
    rt_jax.load(torch_ref.program(prog))
    rt_jax.invoke("tuner", ref_make_ctx("tuner"))
    assert rt_jax.maps.get("ema_stats").lookup_u64(0) == want
    return want


def test_bridge_upload_retries_then_succeeds():
    rt, lp, prog = _ema_runtime("torch")
    want = _ema_want(prog)

    bridge = lp.fn
    with FaultInjector().plan("bridge_upload", count=1):
        ret = bridge(make_ctx("tuner").buf)
    assert ret == 0
    assert bridge.stats.upload_retries == 1
    assert bridge.stats.host_fallbacks == 0
    assert rt.maps.get("ema_stats").lookup_u64(0) == want


def test_bridge_upload_exhausted_falls_back_to_host_tier():
    rt, lp, prog = _ema_runtime("torch")
    want = _ema_want(prog)

    bridge = lp.fn
    with FaultInjector().plan("bridge_upload", prob=1.0) as inj:
        ret = bridge(make_ctx("tuner").buf)
        # initial attempt + every retry fired
        assert inj.stats()["bridge_upload"]["fires"] == \
            1 + bridge.upload_retries
    assert ret == 0
    assert bridge.stats.host_fallbacks == 1
    # the host-VM fallback wrote the HOST map directly
    assert rt.maps.get("ema_stats").lookup_u64(0) == want


def test_bridge_flush_failure_is_contained():
    rt, lp, _ = _ema_runtime("torch")
    rt.invoke("tuner", make_ctx("tuner"))
    with FaultInjector().plan("bridge_flush", prob=1.0):
        rt.detach("tuner")                   # T3 flush fires inside
    assert rt.stats.flush_failures >= 1
    assert not rt.is_attached("tuner")       # detach still completed


# ---------------------------------------------------------------------------
# in-graph tiers: clamp in the kernel's graph + fault-flag drain
# ---------------------------------------------------------------------------

def test_ingraph_out_of_domain_clamped_and_drained():
    from repro_torch.collectives.ingraph import FAULT_KEY, InGraphSelector

    @policy(section="tuner", maps=[])
    def out_of_domain(ctx):
        ctx.algorithm = 9
        ctx.protocol = 1
        ctx.n_channels = 700
        return 0

    sel = InGraphSelector(out_of_domain.program, tier="torch")
    state = sel.init_state()
    assert FAULT_KEY in state
    algo, ch, state = sel.decide(state, coll=CollType.ALL_REDUCE,
                                 msg_bytes=1 * MiB, n=8)
    assert int(algo) == 3 and int(ch) == 32   # clamped, in-domain
    n, state = sel.drain_faults(state)
    assert n == 1
    n2, _ = sel.drain_faults(state)
    assert n2 == 0                            # drain is read-and-zero


def test_ingraph_in_domain_decision_raises_no_flag():
    from repro_torch.collectives.ingraph import InGraphSelector

    @policy(section="tuner", maps=[])
    def fine(ctx):
        ctx.algorithm = 1
        ctx.protocol = 0
        ctx.n_channels = 4
        return 0

    sel = InGraphSelector(fine.program, tier="torch")
    state = sel.init_state()
    algo, ch, state = sel.decide(state, coll=CollType.ALL_REDUCE,
                                 msg_bytes=1 * MiB, n=8)
    assert int(algo) == 1 and int(ch) == 4
    n, _ = sel.drain_faults(state)
    assert n == 0


# ---------------------------------------------------------------------------
# hot-reload atomicity under injected compile faults, every tier
# ---------------------------------------------------------------------------

def _replace_atomic_under_compile_fault(tier):
    rt = PolicyRuntime(tier=tier)
    rt.load(T.static_override.program)
    link = rt.chain("tuner")[0]
    epoch = rt.epoch
    with pytest.raises(InjectedFault):
        with FaultInjector().plan("compile", prob=1.0):
            link.replace(T.size_aware.program)
    assert rt.epoch == epoch
    assert rt.stats.compile_failures >= 1
    assert rt.attached("tuner").program.name == "static_override"
    ctx = make_ctx("tuner", msg_size=1 * MiB)
    assert rt.invoke("tuner", ctx) == 0
    assert ctx["algorithm"] == Algo.RING     # old chain still deciding


@pytest.mark.parametrize("tier", ALL_TIERS)
def test_replace_atomic_under_compile_fault(tier):
    if tier == "native" and not have_cc():
        pytest.skip("native tier needs a C toolchain (have_cc)")
    _replace_atomic_under_compile_fault(tier)


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["cuda", "cuda32"])
def test_replace_atomic_under_compile_fault_on_the_card(tier, card):
    _replace_atomic_under_compile_fault(tier)


def test_try_reload_returns_compile_errors_instead_of_raising():
    rt = PolicyRuntime(tier="jit")
    rt.load(T.static_override.program)
    with FaultInjector().plan("compile", prob=1.0):
        err = rt.try_reload(T.size_aware.program)
    assert isinstance(err, InjectedFault)
    assert rt.attached("tuner").program.name == "static_override"


def test_load_bundle_atomic_under_mid_bundle_compile_fault():
    from repro_torch.policies import net_accounting
    rt = PolicyRuntime(tier="jit")
    rt.load(T.static_override.program)
    epoch = rt.epoch
    with pytest.raises(InjectedFault):
        # every=2: the bundle's FIRST member compiles, the second faults
        with FaultInjector().plan("compile", every=2):
            rt.load_bundle([T.size_aware.program,
                            net_accounting.program])
    assert rt.epoch == epoch                  # nothing swapped
    assert rt.attached("tuner").program.name == "static_override"
    assert not rt.is_attached("net")


# ---------------------------------------------------------------------------
# JIT map-pointer stores and version tracking
# ---------------------------------------------------------------------------

def test_v1_pointer_store_bumps_map_version():
    """A store through a looked-up map value pointer bumps the map's
    content version on every call of the host JIT's closure."""
    from repro_torch.core.jit import compile_program

    vmap = map_decl("pm", kind="array", value_size=16, max_entries=4)

    @policy(section="tuner", maps=[vmap])
    def bump(ctx):
        st = vmap.lookup(0)
        if st is None:
            return 1
        st[0] = st[0] + 1
        return 0

    reg = MapRegistry()
    m = reg.create("pm", "array", key_size=4, value_size=16,
                   max_entries=4)
    fn = compile_program(bump.program, {"pm": m})
    v0 = m.version
    assert fn(make_ctx("tuner").buf) == 0
    assert m.version > v0                    # pointer store touched the map
    assert m.lookup_u64(0) == 1
    # device bridges key upload skipping on version: a second store
    # must bump again (no plateau)
    v1 = m.version
    fn(make_ctx("tuner").buf)
    assert m.version > v1 and m.lookup_u64(0) == 2
