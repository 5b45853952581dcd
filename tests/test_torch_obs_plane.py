"""Observability plane of the port: ringbuf/perdev/LRU map semantics +
flight recorder (the reference's ``tests/test_obs_plane.py`` run on
``repro_torch``).

Four layers of coverage:

* host-map state-machine tests for the three new map kinds (FIFO drains,
  overflow drop accounting, drain-then-write row reuse, LRU eviction
  order, per-device sharding/merge) including a scripted golden of the
  ringbuf cursor state and a seeded multi-writer stress run;
* policy-level differentials: a ringbuf writer policy driven through
  every host tier (interp / jit v1 / jit v2 / native) plus the policy
  kernel's tiers (``torch`` here, ``cuda``/``cuda32`` on the card, marked
  ``cuda``; behind the device bridge, flush-then-drain), asserting
  bit-identical (returns, drained records, drop counters) against the
  vm.py ground truth and the reference's interpreter;
* the flight recorder + JSON-lines exporter fed through the dispatcher's
  ``profiler_feed`` hook, schema-validated;
* the unified health surfaces: bridge stats + observability loss
  accounting in ``PolicyRuntime.health`` / decision-log ring counters in
  ``CollectiveDispatcher.health``, and the ring-backed printk log.
"""

import io
import json
import random
import struct
import threading

import pytest
import torch

import torch_ref
from repro.core import PolicyRuntime as RefRuntime
from repro.core import make_ctx as ref_make_ctx
from repro_torch.core.cc import have_cc
from repro_torch.core.context import make_ctx
from repro_torch.core.frontend import map_decl, policy
from repro_torch.core.maps import (LruHashMap, MapError, PerDeviceArrayMap,
                                   RingBufMap, RingView)
from repro_torch.core.runtime import PolicyRuntime
from repro_torch.core.vm import VM
from repro_torch.obs import Exporter, FlightRecorder
from repro_torch.obs.exporter import validate_export
from repro_torch.policies import profiler as prof

U64 = struct.Struct("<Q")


def _rec(*vals):
    return b"".join(U64.pack(v) for v in vals)


# ---------------------------------------------------------------------------
# host-map semantics: RingBufMap
# ---------------------------------------------------------------------------

def test_ringbuf_fifo_drain():
    rb = RingBufMap("rb", 8, 4)
    for i in range(3):
        assert rb.output(_rec(i)) == 0
    assert len(rb) == 3
    assert rb.drain() == [_rec(0), _rec(1), _rec(2)]
    assert len(rb) == 0


def test_ringbuf_overflow_drop_accounting():
    rb = RingBufMap("rb", 8, 4)
    for i in range(7):
        rb.output(_rec(i))
    # drop-on-full: records 4..6 rejected, oldest four retained
    assert (len(rb), rb.drops) == (4, 3)
    assert rb.drain() == [_rec(i) for i in range(4)]

    ow = RingBufMap("ow", 8, 4, overwrite=True)
    for i in range(7):
        assert ow.output(_rec(i)) == 0
    # overwrite: oldest evicted (counted), newest four retained
    assert (len(ow), ow.drops) == (4, 3)
    assert ow.drain() == [_rec(i) for i in range(3, 7)]


def test_ringbuf_drain_then_write_reuse():
    rb = RingBufMap("rb", 8, 4)
    for i in range(4):
        rb.output(_rec(i))
    assert rb.drain() == [_rec(i) for i in range(4)]
    # rows are reused after a drain; cursors keep free-running
    for i in range(10, 13):
        assert rb.output(_rec(i)) == 0
    assert (len(rb), rb.drops) == (3, 0)
    assert rb.drain() == [_rec(10), _rec(11), _rec(12)]
    assert (rb.head, rb.tail) == (7, 7)


def test_ringbuf_reserve_submit_discard():
    rb = RingBufMap("rb", 8, 2)
    e = rb.reserve_ref()
    e[:] = _rec(1)
    rb.submit()
    e = rb.reserve_ref()
    e[:] = _rec(2)
    rb.discard()                      # abandoned: row reused
    e = rb.reserve_ref()
    e[:] = _rec(3)
    rb.submit()
    assert rb.drain() == [_rec(1), _rec(3)]
    # a forgotten submit is implicitly committed by the next reserve
    e = rb.reserve_ref()
    e[:] = _rec(4)
    e2 = rb.reserve_ref()
    e2[:] = _rec(5)
    rb.submit()
    assert rb.drain() == [_rec(4), _rec(5)]


def test_ringbuf_cursor_golden():
    """Scripted golden of the full cursor state (the same state machine
    every in-graph tier replicates on the device control words)."""
    rb = RingBufMap("rb", 16, 4)
    script = []
    for i in range(6):
        script.append(rb.output(_rec(i, i * i)))
    drained = rb.drain(2)
    for i in range(6, 9):
        script.append(rb.output(_rec(i, i * i)))
    assert script == [0, 0, 0, 0, -1, -1, 0, 0, -1]
    assert drained == [_rec(0, 0), _rec(1, 1)]
    assert (rb.head, rb.tail, rb.drops, len(rb)) == (6, 2, 3, 4)
    assert rb.peek() == [_rec(2, 4), _rec(3, 9), _rec(6, 36), _rec(7, 49)]


def test_ringbuf_seeded_multi_writer_stress():
    """4 seeded writer threads + concurrent drainer: conservation holds
    (produced == drained + live + dropped) and each writer's surviving
    records drain in its own submission order."""
    rb = RingBufMap("rb", 16, 32)
    N_WRITERS, N_OPS = 4, 300
    oks = [0] * N_WRITERS
    drained = []
    stop = threading.Event()

    def writer(w):
        rng = random.Random(1000 + w)
        seq = 0
        for _ in range(N_OPS):
            if rng.random() < 0.5:
                if rb.output(_rec(w, seq)) == 0:
                    oks[w] += 1
                seq += 1
            else:
                with rb.lock:       # reserve/submit is one producer op
                    e = rb.reserve_ref()
                    if e is not None:
                        e[:] = _rec(w, seq)
                        rb.submit()
                        oks[w] += 1
                seq += 1

    def drainer():
        rng = random.Random(7)
        while not stop.is_set():
            drained.extend(rb.drain(rng.randint(1, 8)))

    threads = [threading.Thread(target=writer, args=(w,))
               for w in range(N_WRITERS)]
    dt = threading.Thread(target=drainer)
    dt.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    dt.join()
    drained.extend(rb.drain())

    assert sum(oks) == len(drained)
    assert sum(oks) + rb.drops == N_WRITERS * N_OPS
    per_writer = {w: [] for w in range(N_WRITERS)}
    for raw in drained:
        w, seq = U64.unpack(raw[:8])[0], U64.unpack(raw[8:])[0]
        per_writer[w].append(seq)
    for w, seqs in per_writer.items():
        assert seqs == sorted(seqs), f"writer {w} records out of order"


# ---------------------------------------------------------------------------
# host-map semantics: LruHashMap / PerDeviceArrayMap / RingView
# ---------------------------------------------------------------------------

def _k(v):
    return v.to_bytes(4, "little")


def test_lru_eviction_order():
    m = LruHashMap("lru", 4, 8, 3)
    for i in range(3):
        m.update(_k(i), _rec(i * 10))
    m.lookup_ref(_k(0))               # refresh 0 — victim becomes 1
    m.update(_k(9), _rec(90))
    assert m.peek_ref(_k(1)) is None
    assert {int.from_bytes(k, "little") for k in m.keys()} == {0, 2, 9}
    # peek must NOT refresh: 2 is now the victim despite the peeks
    m.peek_ref(_k(2))
    m.peek_ref(_k(2))
    m.update(_k(8), _rec(80))
    assert m.peek_ref(_k(2)) is None
    assert m.peek_ref(_k(0)) is not None


def test_lru_delete_and_snapshot():
    m = LruHashMap("lru", 4, 8, 2)
    m.update(_k(1), _rec(11))
    m.update(_k(2), _rec(22))
    assert m.delete(_k(1)) == 0
    assert m.delete(_k(1)) == -1
    assert len(m) == 1
    snap = m.snapshot()
    assert snap == {_k(2): _rec(22)}
    m.update(_k(3), _rec(33))         # freed row claimed before eviction
    assert m.peek_ref(_k(2)) is not None


def test_perdev_sharding_and_merge():
    m = PerDeviceArrayMap("pd", 8, 4)
    for dev in range(3):
        m.set_device(dev)
        v = m.lookup_ref(_k(1))
        v[:] = _rec(dev + 1)
    assert [m.device_u64(d, 1) for d in range(4)] == [1, 2, 3, 0]
    assert m.aggregate_u64(1) == 6
    assert m.aggregate_u64(0) == 0


def test_ringview_deque_surface():
    enc = lambda v: _rec(v)
    dec = lambda b: U64.unpack(b)[0]
    rv = RingView(4, 8, enc, dec)
    assert rv.maxlen == 4 and len(rv) == 0 and not rv
    for i in range(6):
        rv.append(i)
    assert (len(rv), rv.drops) == (4, 2)
    assert rv[-1] == 5 and rv[0] == 2
    assert list(rv) == [2, 3, 4, 5]
    assert rv[1:3] == [3, 4]
    rv.clear()
    assert len(rv) == 0 and rv.drops == 2
    # capacity None maps to the historical 4096 default, echoed as None
    assert RingView(None, 8, enc, dec).maxlen is None
    # capacity 0 logs nothing
    rv0 = RingView(0, 8, enc, dec)
    rv0.append(1)
    assert len(rv0) == 0 and rv0.maxlen == 0


# ---------------------------------------------------------------------------
# policy-level tier differentials
# ---------------------------------------------------------------------------

stress_rb = map_decl("stress_rb", kind="ringbuf", value_size=16,
                     max_entries=8)


@policy(section="profiler", maps=[stress_rb])
def rb_writer(ctx):
    e = stress_rb.reserve()
    if e is None:
        return 0
    e[0] = ctx.comm_id
    e[1] = ctx.latency_ns
    stress_rb.submit()
    return 1


def _drive_rb_writer(rt, *, n=14, drain_at=(9,)):
    """Scripted overflow-then-drain-then-reuse schedule; returns the
    full observable trace (rets, drained batches, final drops/len)."""
    ref = isinstance(rt, RefRuntime)
    rt.attach(torch_ref.program(rb_writer.program) if ref
              else rb_writer.program)
    rets, batches = [], []
    for i in range(n):
        ctx = (ref_make_ctx if ref else make_ctx)(
            "profiler", event_type=1, coll_type=0, msg_size=0, comm_id=i,
            latency_ns=i * 1000, n_channels=0, algorithm=0, timestamp_ns=i)
        rets.append(rt.invoke("profiler", ctx))
        if i in drain_at:
            rt.flush_bridges("profiler")
            batches.append(rt.maps.get("stress_rb").drain())
    rt.flush_bridges("profiler")
    rb = rt.maps.get("stress_rb")
    batches.append(rb.drain())
    return rets, batches, rb.drops, len(rb)


def _rb_ground_truth():
    want = _drive_rb_writer(PolicyRuntime(use_interpreter=True))
    assert _drive_rb_writer(RefRuntime(use_interpreter=True)) == want
    return want


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import have_nvcc
    if not have_nvcc():
        pytest.skip("needs nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["cuda", "cuda32"])
def test_rb_writer_tier_differential_on_the_card(tier, card):
    assert _drive_rb_writer(PolicyRuntime(tier=tier)) == _rb_ground_truth()


@pytest.mark.parametrize("tier", ["jit", "interp", "native", "torch"])
def test_rb_writer_tier_differential(tier):
    """Every tier produces the identical trace: 8 accepted writes, 2
    drop-on-full rejections, FIFO drain, then rows reused for 4 more
    accepted writes after the drain — including the bridge tiers'
    device write cursor drained at flush()."""
    if tier == "native" and not have_cc():
        pytest.skip("native tier needs a C toolchain (have_cc)")
    want = _rb_ground_truth()
    got = _drive_rb_writer(PolicyRuntime(tier=tier))
    assert got == want
    rets, batches, drops, live = want
    assert rets == [1] * 8 + [0] * 2 + [1] * 4
    assert drops == 2 and live == 0
    assert [len(b) for b in batches] == [8, 4]
    assert batches[0] == [_rec(i, i * 1000) for i in range(8)]
    assert batches[1] == [_rec(i, i * 1000) for i in range(10, 14)]


def test_rb_writer_v1_v2_codegen_differential():
    """The host JIT and, where the host has a C toolchain, the native
    tier against the raw VM, same scripted schedule."""
    from repro_torch.core.cc import compile_native, have_cc
    from repro_torch.core.jit import compile_program
    from repro_torch.core.maps import MapRegistry
    from repro_torch.core.verifier import verify_with_info

    progm = rb_writer.program
    vinfo = verify_with_info(progm)

    def run(make_fn):
        reg = MapRegistry()
        maps = {d.name: reg.create(d.name, d.kind, value_size=d.value_size,
                                   max_entries=d.max_entries)
                for d in progm.maps}
        fn = make_fn(maps)
        trace = []
        for i in range(12):
            ctx = make_ctx("profiler", event_type=1, coll_type=0,
                           msg_size=0, comm_id=i, latency_ns=i,
                           n_channels=0, algorithm=0, timestamp_ns=i)
            trace.append(fn(ctx.buf))
        rb = maps["stress_rb"]
        return trace, rb.drain(), rb.drops

    want = run(lambda m: VM(progm.insns, m).run)
    legs = {"jit": lambda m: compile_program(progm, m, info=vinfo)}
    if have_cc():
        legs["native"] = lambda m: compile_native(progm, m, vinfo)
    for leg, make_fn in legs.items():
        assert run(make_fn) == want, leg


def test_profiler_suite_tier_differential():
    """The shipped profiler policies (histogram + straggler trap) agree
    across interp / jit / native / torch and the reference's interp
    end-to-end: histogram buckets, straggler events, ring drops."""
    def run(rt):
        ref = isinstance(rt, RefRuntime)
        for i, p in enumerate(prof.PROFILER_POLICIES):
            rt.attach(torch_ref.program(p.program) if ref else p.program,
                      priority=i)
        rng = random.Random(42)
        rets = []
        for i in range(50):
            lat = rng.randrange(600, 4_000_000)
            if i % 6 == 0:
                lat *= 8
            ctx = (ref_make_ctx if ref else make_ctx)(
                "profiler", event_type=1, coll_type=1, msg_size=1 << 20,
                comm_id=rng.randrange(1, 5), latency_ns=lat, n_channels=8,
                algorithm=1, timestamp_ns=i)
            rets.append(rt.invoke("profiler", ctx))
        rt.flush_bridges("profiler")
        ev = rt.maps.get("events")
        hist = rt.maps.get("lat_hist")
        return (rets, ev.peek(), ev.drops,
                [hist.aggregate_u64(b) for b in range(prof.N_BUCKETS)])

    want = run(PolicyRuntime(use_interpreter=True))
    assert sum(want[3]) == 50                 # every event bucketed
    assert len(want[1]) > 0                   # stragglers fired
    assert run(RefRuntime(use_interpreter=True)) == want
    tiers = ["jit", "torch"] + (["native"] if have_cc() else [])
    for tier in tiers:
        assert run(PolicyRuntime(tier=tier)) == want, tier


# ---------------------------------------------------------------------------
# flight recorder + exporter through the dispatcher hook
# ---------------------------------------------------------------------------

def _profiler_dispatcher():
    from repro_torch.collectives.dispatch import CollectiveDispatcher
    rt = PolicyRuntime(tier="jit")
    for i, p in enumerate(prof.PROFILER_POLICIES):
        rt.attach(p.program, priority=i)
    return CollectiveDispatcher(runtime=rt), rt


def _feed(disp, n=80, seed=11):
    rng = random.Random(seed)
    for i in range(n):
        lat = rng.randrange(1_000, 2_000_000)
        if i % 7 == 0:
            lat *= 10
        disp.profiler_feed(comm_id=rng.randrange(1, 4), latency_ns=lat,
                           coll=1, msg_size=1 << 16, channels=8, algo=1,
                           ts_ns=i)


def test_flight_recorder_ingest_and_counters():
    disp, rt = _profiler_dispatcher()
    rec = FlightRecorder(rt, capacity=8)
    _feed(disp)
    n = rec.poll()
    assert n > 0 and rec.events_seen == n
    c = rec.counters()
    assert c["records_stored"] == min(n, 8)
    assert c["host_overflow"] == max(n - 8, 0)
    assert c["device_pending"] == 0           # poll drained the ring
    assert sum(rec.histogram()) == 80
    for r in rec.records():
        assert r.latency_ns > r.ema_ns        # only stragglers recorded


def test_exporter_schema_and_exactly_once():
    disp, rt = _profiler_dispatcher()
    rec = FlightRecorder(rt, capacity=64)
    buf = io.StringIO()
    ex = Exporter(rec, stream=buf)
    _feed(disp, n=40)
    ex.snapshot()
    _feed(disp, n=40, seed=12)
    ex.snapshot()
    lines = buf.getvalue().splitlines()
    assert validate_export(lines) == []
    recs = [json.loads(l) for l in lines]
    kinds = [r["kind"] for r in recs]
    assert kinds.count("histogram") == 2 and kinds.count("counters") == 2
    stragglers = [r for r in recs if r["kind"] == "straggler"]
    assert len(stragglers) > 0
    # exactly-once: no straggler record repeats across snapshots
    ids = [(r["comm_id"], r["latency_ns"], r["timestamp_ns"])
           for r in stragglers]
    assert len(ids) == len(set(ids))
    # second histogram is cumulative over both feeds
    hists = [r for r in recs if r["kind"] == "histogram"]
    assert hists[0]["total"] == 40 and hists[1]["total"] == 80
    assert ex.path is None and ex.lines_written == len(lines)


def test_exporter_file_roundtrip(tmp_path):
    disp, rt = _profiler_dispatcher()
    rec = FlightRecorder(rt, capacity=64)
    path = tmp_path / "flight.jsonl"
    ex = Exporter(rec, str(path))
    _feed(disp, n=30)
    ex.snapshot()
    lines = path.read_text().splitlines()
    assert validate_export(lines) == []
    with pytest.raises(ValueError):
        Exporter(rec)                         # neither path nor stream


def test_recorder_without_a_runtime_takes_the_process_runtime():
    """``FlightRecorder()`` falls back to ``global_runtime()``, as in the
    reference; in the port that is the ``cuda`` tier, which refuses to
    construct without a card (no CPU fallback)."""
    from repro_torch.core.runtime import reset_global_runtime
    from repro_torch.device import DeviceError
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    reset_global_runtime()
    try:
        with pytest.raises(DeviceError):
            FlightRecorder()
    finally:
        reset_global_runtime()


def test_recorder_tolerates_missing_maps():
    rt = PolicyRuntime(tier="jit")
    rec = FlightRecorder(rt, register=False)
    assert rec.poll() == 0
    assert rec.histogram() == []
    assert rec.counters()["device_drops"] == 0


# ---------------------------------------------------------------------------
# unified health surfaces + ring-backed printk
# ---------------------------------------------------------------------------

def test_runtime_health_observability_sections():
    rt = PolicyRuntime(tier="jit")
    h = rt.health()
    assert h["bridge"]["n_bridges"] == 0
    assert h["observability"]["printk"]["drops"] == 0
    assert "recorder" not in h["observability"]
    rec = FlightRecorder(rt, capacity=4)      # register=True default
    h = rt.health()
    assert h["observability"]["recorder"] == rec.counters()
    rt.attach_recorder(None)
    assert "recorder" not in rt.health()["observability"]


def test_runtime_health_aggregates_bridge_stats():
    rt = PolicyRuntime(tier="torch")
    rt.attach(rb_writer.program)
    ctx = make_ctx("profiler", event_type=1, coll_type=0, msg_size=0,
                   comm_id=1, latency_ns=5, n_channels=0, algorithm=0,
                   timestamp_ns=0)
    rt.invoke("profiler", ctx)
    b = rt.health()["bridge"]
    assert b["n_bridges"] == 1 and b["calls"] == 1 and b["map_uploads"] >= 1


def test_dispatcher_health_decision_log_ring():
    from repro_torch.collectives.dispatch import (CollectiveDispatcher,
                                                  DispatchConfig)
    disp = CollectiveDispatcher(
        runtime=PolicyRuntime(tier="jit"),
        config=DispatchConfig(decision_log_max=4))
    for i in range(6):
        disp.decide(0, (i + 1) << 10, 8)
    dh = disp.health()["dispatcher"]
    assert dh["decision_log"] == {"stored": 4, "capacity": 4, "drops": 2}
    assert disp.decisions[-1].size_bytes == 6 << 10
    assert len(disp.decisions) == 4


def test_printk_ring_bounded_with_drops():
    rt = PolicyRuntime(tier="jit", printk_log_max=4)
    for v in range(10):
        rt._printk_log.append(v)
    assert rt.printk_log() == [6, 7, 8, 9]
    obs = rt.health()["observability"]["printk"]
    assert obs == {"stored": 4, "capacity": 4, "drops": 6}
