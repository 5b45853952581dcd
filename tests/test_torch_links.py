"""Link-based attachment API of the port (the reference's
``tests/test_links.py`` run on ``repro_torch``, on the ``jit`` tier the
reference defaults to): per-hook chains, composition semantics, pinned
cross-plugin maps, and transactional bundle reload.

Pins the redesigned runtime surface:
  * attach() -> PolicyLink, ordered by (priority, attach order)
  * tuner chains: first-non-deferring-wins; env: last-writer-wins;
    net/profiler: invoke-all
  * link.replace(): verify-then-CAS (old program survives rejection)
  * load_bundle(): all-or-nothing multi-section swap, ONE epoch bump
  * MapRegistry pinned namespace + shared=True declarations
"""

import pytest

from repro_torch.core import (LinkError, MapRegistry, PolicyRuntime,
                              VerifierError, make_ctx, map_decl, policy)
from repro_torch.core.maps import MapError
from repro_torch.policies import (UNSAFE_PROGRAMS, adapt_profiler,
                                  adapt_tuner, bad_channels, env_defaults,
                                  ring_mid_v2, static_override)

MiB = 1 << 20


def _tuner_channels(rt, msg_size):
    ctx = make_ctx("tuner", msg_size=msg_size)
    rt.invoke("tuner", ctx)
    return ctx["n_channels"]


# ---------------------------------------------------------------------------
# chain ordering + composition
# ---------------------------------------------------------------------------

def test_chain_orders_by_priority_then_attach_order():
    rt = PolicyRuntime(tier="jit")
    lo = rt.attach(static_override.program, priority=10)
    hi = rt.attach(bad_channels.program, priority=0)
    mid = rt.attach(ring_mid_v2.program, priority=10)  # ties after `lo`
    assert [l.name for l in rt.chain("tuner")] == [
        "bad_channels", "static_override", "ring_mid_v2"]
    assert rt.chain("tuner") == (hi, lo, mid)


def test_tuner_first_non_deferring_wins():
    rt = PolicyRuntime(tier="jit")
    rt.attach(ring_mid_v2.program, priority=0)     # defers below 4 MiB
    rt.attach(static_override.program, priority=1)  # always 8 channels
    # ring_mid decides for 8 MiB (32 channels), shadowing static_override
    assert _tuner_channels(rt, 8 * MiB) == 32
    # ring_mid defers for 1 MiB -> falls through to static_override
    assert _tuner_channels(rt, 1 * MiB) == 8


def test_tuner_all_defer_falls_to_framework_default():
    rt = PolicyRuntime(tier="jit")
    rt.attach(ring_mid_v2.program)
    # 1 MiB: the only link defers; outputs stay zero for the dispatcher
    assert _tuner_channels(rt, 1 * MiB) == 0


def test_priority_zero_shadows_regardless_of_attach_order():
    rt = PolicyRuntime(tier="jit")
    rt.attach(static_override.program, priority=5)
    rt.attach(bad_channels.program, priority=0)    # attached later, runs first
    assert _tuner_channels(rt, 8 * MiB) == 1


def test_reused_ctx_does_not_leak_previous_decision_into_defer_check():
    """first-non-deferring-wins zeroes outputs at chain entry: stale
    outputs from a previous invoke on the same ctx must not make a
    deferring link look like the decider."""
    rt = PolicyRuntime(tier="jit")
    rt.attach(ring_mid_v2.program, priority=0)     # defers below 4 MiB
    rt.attach(bad_channels.program, priority=1)    # always 1 channel
    ctx = make_ctx("tuner", msg_size=8 * MiB)
    rt.invoke("tuner", ctx)
    assert ctx["n_channels"] == 32                 # ring_mid decided
    ctx["msg_size"] = 1 * MiB                      # reuse the same ctx
    rt.invoke("tuner", ctx)
    assert ctx["n_channels"] == 1                  # fell through correctly


def test_invoke_all_sections_run_every_program():
    counts_a = map_decl("net_counts_a", value_size=8, max_entries=4)
    counts_b = map_decl("net_counts_b", value_size=8, max_entries=4)

    @policy(section="net", maps=[counts_a])
    def net_a(ctx):
        st = counts_a.lookup(0)
        if st is None:
            return 0
        st[0] = st[0] + 1
        return 0

    @policy(section="net", maps=[counts_b])
    def net_b(ctx):
        st = counts_b.lookup(0)
        if st is None:
            return 0
        st[0] = st[0] + 1
        return 0

    rt = PolicyRuntime(tier="jit")
    rt.attach(net_a.program, priority=0)
    rt.attach(net_b.program, priority=1)
    for _ in range(3):
        rt.invoke("net", make_ctx("net", op=0, bytes=1024, peer=1))
    # invoke-all: both observability programs saw all 3 events
    assert rt.maps.get("net_counts_a").lookup_u64(0) == 3
    assert rt.maps.get("net_counts_b").lookup_u64(0) == 3
    # chain invocations count once per event, not per program
    assert rt.stats.invocations == 3


def test_env_last_writer_wins_with_layering():
    @policy(section="env", maps=[])
    def env_override(ctx):
        ctx.max_channels = 16          # contests env_defaults
        return 0                       # leaves default_channels alone

    rt = PolicyRuntime(tier="jit")
    rt.attach(env_defaults.program, priority=10)   # writes both knobs
    rt.attach(env_override.program, priority=0)    # higher precedence
    ctx = make_ctx("env", n_pods=1)
    rt.invoke("env", ctx)
    # contested field: the priority-0 link wrote last and wins
    assert ctx["max_channels"] == 16
    # uncontested field: the lower-precedence program's write survives
    assert ctx["default_channels"] == 8


# ---------------------------------------------------------------------------
# link lifecycle: detach / replace / epochs
# ---------------------------------------------------------------------------

def test_link_detach_restores_fallthrough():
    rt = PolicyRuntime(tier="jit")
    top = rt.attach(bad_channels.program, priority=0)
    rt.attach(static_override.program, priority=1)
    assert _tuner_channels(rt, 8 * MiB) == 1
    e0 = rt.epoch
    top.detach()
    assert rt.epoch == e0 + 1
    assert not top.is_attached
    assert [l.name for l in rt.chain("tuner")] == ["static_override"]
    assert _tuner_channels(rt, 8 * MiB) == 8


def test_double_detach_raises():
    rt = PolicyRuntime(tier="jit")
    link = rt.attach(static_override.program)
    link.detach()
    with pytest.raises(LinkError):
        link.detach()


def test_replace_swaps_in_place_one_epoch():
    rt = PolicyRuntime(tier="jit")
    link = rt.attach(static_override.program, priority=3)
    rt.attach(ring_mid_v2.program, priority=7)
    e0 = rt.epoch
    link.replace(bad_channels.program)
    assert rt.epoch == e0 + 1
    assert link.name == "bad_channels"
    assert link.priority == 3                      # position preserved
    assert [l.name for l in rt.chain("tuner")] == [
        "bad_channels", "ring_mid_v2"]
    assert _tuner_channels(rt, 8 * MiB) == 1
    assert rt.stats.replaces == 1


def test_replace_rejection_keeps_old_program_and_epoch():
    rt = PolicyRuntime(tier="jit")
    link = rt.attach(static_override.program)
    e0 = rt.epoch
    bad, _ = UNSAFE_PROGRAMS["null_deref"]
    with pytest.raises(VerifierError):
        link.replace(bad)
    assert rt.epoch == e0                          # no swap happened
    assert link.name == "static_override"
    assert _tuner_channels(rt, 8 * MiB) == 8       # old policy still running
    assert rt.stats.rejected == 1


def test_replace_wrong_section_raises():
    rt = PolicyRuntime(tier="jit")
    link = rt.attach(static_override.program)
    with pytest.raises(LinkError):
        link.replace(adapt_profiler.program)


def test_replace_after_detach_raises():
    rt = PolicyRuntime(tier="jit")
    link = rt.attach(static_override.program)
    link.detach()
    with pytest.raises(LinkError):
        link.replace(bad_channels.program)


def test_legacy_load_replaces_single_slot_not_chains():
    """Old API keeps single-slot semantics: load() twice = second wins,
    and explicit links attached alongside survive a legacy reload."""
    rt = PolicyRuntime(tier="jit")
    rt.load(static_override.program)
    rt.load(bad_channels.program)                  # replaces, not stacks
    assert len(rt.chain("tuner")) == 1
    assert _tuner_channels(rt, 8 * MiB) == 1

    extra = rt.attach(ring_mid_v2.program, priority=-1)
    rt.reload(static_override.program)             # swaps only the legacy slot
    assert [l.name for l in rt.chain("tuner")] == [
        "ring_mid_v2", "static_override"]
    assert extra.is_attached


# ---------------------------------------------------------------------------
# section validation satellites
# ---------------------------------------------------------------------------

def test_sections_listed():
    assert PolicyRuntime.sections() == ["tuner", "profiler", "net", "env"]


def test_unknown_section_raises_helpful_keyerror():
    rt = PolicyRuntime(tier="jit")
    for method in (rt.detach, rt.attached, rt.chain, rt.invoke_fn,
                   rt.is_attached, rt.chain_fingerprint):
        with pytest.raises(KeyError, match="valid sections: tuner"):
            method("tunerr")
    with pytest.raises(KeyError, match="valid sections: tuner"):
        rt.invoke("tunerr", make_ctx("tuner"))


def test_invoke_fn_counts_invocations():
    """Satellite: raw-closure callers land in stats.invocations too."""
    rt = PolicyRuntime(tier="jit")
    rt.load(static_override.program)
    fn = rt.invoke_fn("tuner")
    buf = make_ctx("tuner", msg_size=8 * MiB).buf
    for _ in range(5):
        fn(buf)
    rt.invoke("tuner", make_ctx("tuner", msg_size=8 * MiB))
    assert rt.stats.invocations == 6


def test_printk_log_is_bounded():
    @policy(section="profiler", maps=[])
    def chatty(ctx):
        trace_printk(ctx.latency_ns)  # noqa: F821 — restricted-Python builtin
        return 0

    rt = PolicyRuntime(tier="jit", printk_log_max=8)
    rt.load(chatty.program)
    for i in range(100):
        rt.invoke("profiler", make_ctx("profiler", latency_ns=i))
    log = rt.printk_log()
    assert len(log) == 8
    assert log == list(range(92, 100))             # ring: newest survive


# ---------------------------------------------------------------------------
# pinned cross-plugin maps
# ---------------------------------------------------------------------------

def test_shared_map_pins_and_links_profiler_to_tuner():
    rt = PolicyRuntime(tier="jit")
    rt.attach(adapt_profiler.program)
    rt.attach(adapt_tuner.program)
    # adapt_map is declared shared=True -> pinned at load
    assert rt.maps.is_pinned("adapt_map")
    ema = rt.maps.get_pinned("adapt_map")

    # drive the closed loop: profiler writes EMA, tuner reads it
    for _ in range(4):
        rt.invoke("profiler", make_ctx(
            "profiler", event_type=1, comm_id=5, latency_ns=2_000_000))
    ctx = make_ctx("tuner", comm_id=5, msg_size=8 * MiB, n_ranks=8)
    rt.invoke("tuner", ctx)
    # contention path: EMA over 1ms forces back-off to 2 channels
    assert ctx["n_channels"] == 2
    # host-side tooling reads the same object through the pin
    assert ema.lookup_u64(5, slot=0) > 1_000_000


def test_get_pinned_requires_pin():
    reg = MapRegistry()
    reg.create("private", "array")
    with pytest.raises(MapError, match="not pinned"):
        reg.get_pinned("private")
    reg.pin("private")
    assert reg.get_pinned("private") is reg.get("private")
    reg.unpin("private")
    with pytest.raises(MapError):
        reg.get_pinned("private")


def test_pin_unknown_map_raises():
    reg = MapRegistry()
    with pytest.raises(MapError, match="cannot pin"):
        reg.pin("ghost")


def test_registry_validate_is_non_mutating():
    reg = MapRegistry()
    reg.validate("fresh", "array", value_size=8, max_entries=4)
    assert "fresh" not in reg                      # dry run created nothing
    reg.create("fresh", "array", value_size=8, max_entries=4)
    with pytest.raises(MapError, match="different shape"):
        reg.validate("fresh", "array", value_size=16, max_entries=4)


# ---------------------------------------------------------------------------
# transactional bundles
# ---------------------------------------------------------------------------

def test_load_bundle_swaps_sections_under_one_epoch():
    rt = PolicyRuntime(tier="jit")
    old = rt.attach(bad_channels.program)
    e0 = rt.epoch
    links = rt.load_bundle([adapt_profiler.program, adapt_tuner.program])
    assert rt.epoch == e0 + 1                      # ONE bump for both sections
    assert [l.section for l in links] == ["profiler", "tuner"]
    assert not old.is_attached                     # previous chain replaced
    assert [l.name for l in rt.chain("tuner")] == ["adapt_tuner"]
    assert [l.name for l in rt.chain("profiler")] == ["adapt_profiler"]
    assert rt.stats.bundles == 1


def test_load_bundle_all_or_nothing_on_one_bad_program():
    rt = PolicyRuntime(tier="jit")
    keep = rt.attach(static_override.program)
    e0 = rt.epoch
    bad, _ = UNSAFE_PROGRAMS["null_deref"]
    with pytest.raises(VerifierError):
        rt.load_bundle([adapt_profiler.program, bad, adapt_tuner.program])
    # no partial swap: previous chain fully attached, epoch untouched
    assert rt.epoch == e0
    assert keep.is_attached
    assert [l.name for l in rt.chain("tuner")] == ["static_override"]
    assert rt.chain("profiler") == ()
    assert _tuner_channels(rt, 8 * MiB) == 8


def test_load_bundle_rejects_map_shape_conflicts_atomically():
    clash = map_decl("adapt_map", kind="array", value_size=8, max_entries=2)

    @policy(section="tuner", maps=[clash])
    def conflicting(ctx):
        st = clash.lookup(0)
        if st is None:
            return 0
        ctx.n_channels = st[0]
        return 0

    rt = PolicyRuntime(tier="jit")
    rt.attach(adapt_profiler.program)              # creates adapt_map 24B
    e0 = rt.epoch
    with pytest.raises(MapError, match="different shape"):
        rt.load_bundle([conflicting.program])
    assert rt.epoch == e0
    assert [l.name for l in rt.chain("profiler")] == ["adapt_profiler"]


def test_load_bundle_rejects_intra_bundle_map_conflicts_without_side_effects():
    """Two bundle programs declaring the same (not-yet-created) map with
    different shapes must abort in the dry-run phase: no chain swap, no
    epoch bump, and crucially no map left behind in the registry."""
    narrow = map_decl("fresh_shared", kind="array", value_size=8)
    wide = map_decl("fresh_shared", kind="array", value_size=16)

    @policy(section="profiler", maps=[narrow])
    def writes_narrow(ctx):
        st = narrow.lookup(0)
        if st is None:
            return 0
        st[0] = ctx.latency_ns
        return 0

    @policy(section="tuner", maps=[wide])
    def reads_wide(ctx):
        st = wide.lookup(0)
        if st is None:
            return 0
        ctx.n_channels = st[1]
        return 0

    rt = PolicyRuntime(tier="jit")
    e0 = rt.epoch
    with pytest.raises(MapError, match="different shapes"):
        rt.load_bundle([writes_narrow.program, reads_wide.program])
    assert rt.epoch == e0
    assert rt.chain("profiler") == () and rt.chain("tuner") == ()
    assert "fresh_shared" not in rt.maps       # dry run created nothing


def test_load_bundle_respects_explicit_priorities():
    rt = PolicyRuntime(tier="jit")
    rt.load_bundle([static_override.program, bad_channels.program],
                   priorities=[5, 0])
    assert [l.name for l in rt.chain("tuner")] == [
        "bad_channels", "static_override"]
    assert _tuner_channels(rt, 8 * MiB) == 1


def test_empty_bundle_is_a_noop():
    rt = PolicyRuntime(tier="jit")
    e0 = rt.epoch
    assert rt.load_bundle([]) == []
    assert rt.epoch == e0


# ---------------------------------------------------------------------------
# chains x decision cache (dispatch integration)
# ---------------------------------------------------------------------------

def test_pure_chain_decisions_cached_and_fingerprint_invalidates():
    from repro_torch.collectives.dispatch import CollectiveDispatcher
    from repro_torch.core.context import CollType

    rt = PolicyRuntime(tier="jit")
    rt.attach(ring_mid_v2.program, priority=0)
    rt.attach(static_override.program, priority=1)
    disp = CollectiveDispatcher(runtime=rt)

    d1 = disp.decide(CollType.ALL_REDUCE, 8 * MiB, 8, axis_name="dp")
    d2 = disp.decide(CollType.ALL_REDUCE, 8 * MiB, 8, axis_name="dp")
    assert d2 is d1                                # pure depth-2 chain: cached
    assert disp.cache_hits == 1

    # chain mutation (attach) invalidates: next decide re-runs the chain
    rt.attach(bad_channels.program, priority=-1)
    d3 = disp.decide(CollType.ALL_REDUCE, 8 * MiB, 8, axis_name="dp")
    assert d3.channels == 1


def test_stateful_link_anywhere_in_chain_disables_cache():
    from repro_torch.collectives.dispatch import CollectiveDispatcher
    from repro_torch.core.context import CollType

    rt = PolicyRuntime(tier="jit")
    rt.attach(ring_mid_v2.program, priority=0)     # pure
    rt.attach(adapt_tuner.program, priority=1)     # map helpers -> stateful
    disp = CollectiveDispatcher(runtime=rt)
    for _ in range(3):
        disp.decide(CollType.ALL_REDUCE, 8 * MiB, 8, axis_name="dp")
    assert disp.cache_hits == 0
    assert rt.stats.invocations == 3
