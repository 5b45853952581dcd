"""The port's span store (``repro_torch.obs.trace``) on the CPU: spans
record only while a ``torch.profiler`` session runs, with the names,
parents and ids the instrumented layers give them (the dispatcher, the
device bridge on tier ``torch``, the trainer and the data pipeline's
prefetch thread); a new session drops the older one; spans past the cap
are counted; the clock anchor maps a span onto the profiler's timeline.
"""

import importlib.util
import threading
import time
from pathlib import Path

import numpy as np
import pytest
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

import repro_torch.policies as pol
from repro_torch.collectives import dispatch as dispatch_mod
from repro_torch.collectives.dispatch import CollectiveDispatcher
from repro_torch.configs import get_smoke_config
from repro_torch.core.runtime import PolicyRuntime
from repro_torch.data import DataConfig, make_dataset
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models.layers import MeshAxes
from repro_torch.obs import trace
from repro_torch.train import Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
MIB = 1 << 20


@pytest.fixture(autouse=True)
def _empty_store():
    trace.clear()
    yield
    trace.clear()


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def rows():
    """Every stored span as (name, parent, id), in the order they
    ended."""
    t = trace.STORE._tree()
    return [(trace.NAMES[n], int(p), int(i))
            for n, p, i in zip(t["name"], t["parent"], t["id"])]


def _dispatcher(tier="jit", programs=("ring_mid_v2",)):
    rt = PolicyRuntime(tier=tier)
    for name in programs:
        rt.attach(getattr(pol, name).program, priority=0)
    return CollectiveDispatcher(runtime=rt)


def _trainer(monkeypatch, steps=2):
    """A smoke-size trainer on the CPU whose process-wide dispatcher runs
    ``adapt_profiler`` on the bridge's tier ``torch``."""
    disp = _dispatcher("torch", ("adapt_profiler",))
    monkeypatch.setattr(dispatch_mod, "_DISPATCHER", disp)
    tcfg = TrainerConfig(steps=steps, log_every=100,
                         data=DataConfig(seq_len=16, global_batch=2))
    return Trainer(get_smoke_config("tinyllama-1.1b"),
                   MeshAxes(tp=1, dp=1, fsdp=False), None, tcfg,
                   device="cpu")


def _wait_for_batch(step, timeout=30.0):
    deadline = time.monotonic() + timeout
    while step not in trace.spans("data.batch")["id"]:
        assert time.monotonic() < deadline, "no data.batch span stored"
        time.sleep(0.01)


# -- the profiler off: nothing is stored --------------------------------------

def test_decide_and_feed_record_nothing_with_the_profiler_off():
    disp = _dispatcher()
    for _ in range(3):
        d = disp.decide(0, 8 * MIB, 8, axis_name="dp")
        disp.profiler_feed(d.comm_id, 5000)
    assert disp.cache_hits == 2
    assert trace.counters() == {"stored": 0, "drops": 0, "sessions": 0}
    assert trace.STORE.off


def test_bridge_call_records_nothing_with_the_profiler_off():
    disp = _dispatcher("torch", ("adapt_tuner", "adapt_profiler"))
    d = disp.decide(0, 8 * MIB, 8, axis_name="dp")
    disp.profiler_feed(d.comm_id, 5000)
    assert disp.runtime.chain("tuner")[0].fn.stats.calls == 1
    assert trace.counters()["stored"] == 0


def test_trainer_step_and_batch_record_nothing_with_the_profiler_off(
        monkeypatch):
    tr = _trainer(monkeypatch)
    assert len(tr.run()) == 2
    assert trace.counters() == {"stored": 0, "drops": 0, "sessions": 0}


# -- under the profiler: names, parents and ids -------------------------------

def test_decide_records_its_spans_on_the_miss_and_the_hit_path():
    disp = _dispatcher()
    disp.decide(0, 4 * MIB, 8, axis_name="dp")            # seq 1, off
    with profiled():
        disp.decide(0, 8 * MIB, 8, axis_name="dp")        # seq 2, a miss
        disp.decide(0, 8 * MIB, 8, axis_name="dp")        # seq 3, a hit
    assert (disp.cache_misses, disp.cache_hits) == (2, 1)
    assert rows() == [
        ("dispatch.lookup", 2, 2), ("dispatch.log", 2, 2),
        ("dispatch.decide", -1, 2),
        ("dispatch.lookup", 5, 3), ("dispatch.log", 5, 3),
        ("dispatch.decide", -1, 3)]
    assert list(trace.spans("dispatch.decide")["id"]) == [2, 3]
    kids = trace.spans("dispatch.lookup")["dur_ns"] + \
        trace.spans("dispatch.log")["dur_ns"]
    np.testing.assert_array_equal(
        trace.self_ns("dispatch.decide"),
        trace.spans("dispatch.decide")["dur_ns"] - kids)
    assert (trace.self_ns("dispatch.decide") > 0).all()


def test_decide_counts_its_sequence_without_guards():
    disp = _dispatcher()
    disp.config.enable_runtime_guards = False
    with profiled():
        for _ in range(3):
            disp.decide(0, 8 * MIB, 8, axis_name="dp")
    assert list(trace.spans("dispatch.decide")["id"]) == [1, 2, 3]


def test_bridge_spans_sit_under_the_decision_that_called_it():
    disp = _dispatcher("torch")
    with profiled():
        disp.decide(0, 8 * MIB, 8, axis_name="dp")        # a miss: B1 runs
        disp.decide(0, 8 * MIB, 8, axis_name="dp")        # a hit
    assert rows() == [
        ("dispatch.lookup", 7, 1), ("bridge.upload", 5, 1),
        ("bridge.enqueue", 5, 1), ("bridge.wait", 5, 1),
        ("bridge.writeback", 5, 1), ("bridge.call", 7, 1),
        ("dispatch.log", 7, 1), ("dispatch.decide", -1, 1),
        ("dispatch.lookup", 10, 2), ("dispatch.log", 10, 2),
        ("dispatch.decide", -1, 2)]
    call = trace.spans("bridge.call")["dur_ns"]
    parts = sum(trace.spans(n)["dur_ns"] for n in (
        "bridge.upload", "bridge.enqueue", "bridge.wait",
        "bridge.writeback"))
    np.testing.assert_array_equal(trace.self_ns("bridge.call"),
                                  call - parts)


def test_a_feeds_bridge_call_is_a_root_without_an_id():
    disp = _dispatcher("torch", ("adapt_tuner", "adapt_profiler"))
    with profiled():
        disp.profiler_feed(1234, 5000)
    assert rows() == [
        ("bridge.upload", 4, -1), ("bridge.enqueue", 4, -1),
        ("bridge.wait", 4, -1), ("bridge.writeback", 4, -1),
        ("bridge.call", -1, -1)]


def test_trainer_records_its_waits_for_a_batch(monkeypatch):
    tr = _trainer(monkeypatch)
    with profiled():
        tr.run()
        _wait_for_batch(1)
    # the producer's batches interleave with the main thread's spans:
    # compare the main thread's in order, their parents renumbered
    main = [i for i, r in enumerate(rows()) if not r[0].startswith("data.")]
    renum = {old: new for new, old in enumerate(main)}
    got = [(n, renum.get(p, p), i) for n, p, i in
           (rows()[k] for k in main)]
    want = []
    for i in range(2):
        b = len(want)                   # this step's first span
        want += [("trainer.data_wait", -1, i)]
        # the step's feed: adapt_profiler's bridge call, a root
        want += [(n, b + 5, -1) for n in (
            "bridge.upload", "bridge.enqueue", "bridge.wait",
            "bridge.writeback")]
        want += [("bridge.call", -1, -1)]
    assert got == want
    assert list(trace.spans("trainer.data_wait")["id"]) == [0, 1]


def test_prefetch_thread_stores_its_batches():
    with profiled():
        ds = make_dataset(get_smoke_config("tinyllama-1.1b"),
                          DataConfig(seq_len=16, global_batch=2))
        try:
            it = iter(ds)
            next(it)
            next(it)
            _wait_for_batch(1)
        finally:
            ds.stop()
    got = rows()
    assert got[:2] == [("data.batch", -1, 0), ("data.batch", -1, 1)]
    assert all(r[0] == "data.batch" and r[1] == -1 for r in got)
    assert (trace.spans("data.batch")["dur_ns"] > 0).all()


# -- sessions, the cap, the clock anchor --------------------------------------

def test_a_new_session_drops_the_older_one():
    disp = _dispatcher()
    with profiled():
        disp.decide(0, 8 * MIB, 8, axis_name="dp")        # seq 1
        disp.decide(0, 8 * MIB, 8, axis_name="dp")        # seq 2
    disp.decide(0, 8 * MIB, 8, axis_name="dp")            # seq 3, off
    with profiled():
        disp.decide(0, 8 * MIB, 8, axis_name="dp")        # seq 4
    assert list(trace.spans("dispatch.decide")["id"]) == [4]
    assert trace.counters() == {"stored": 3, "drops": 0, "sessions": 2}


def test_a_span_open_across_two_sessions_is_not_written_into_the_second():
    store = trace.STORE
    for k in range(3):
        store.add(trace.DATA_BATCH, store.start(), k)
    outer = store.start()
    store.off = True                # an instrumented call saw the flag off
    store.add(trace.BRIDGE_CALL, store.start(), 7)        # a new session
    store.add(trace.DATA_BATCH, outer, 3)
    assert rows() == [("bridge.call", -1, 7)]
    assert trace.counters() == {"stored": 1, "drops": 0, "sessions": 2}


def test_a_span_ending_after_the_flag_was_seen_off_stays_in_its_session():
    store = trace.STORE
    s = store.start()
    store.off = True                # the profiler stopped meanwhile
    store.add(trace.DATA_BATCH, s, 0)
    assert rows() == [("data.batch", -1, 0)]
    assert trace.counters() == {"stored": 1, "drops": 0, "sessions": 1}


def test_a_batch_begun_under_the_profiler_is_stored_when_it_ends_after(
        monkeypatch):
    begun, release = threading.Event(), threading.Event()
    real = SyntheticLMDataset.batch

    def held(self, step):
        begun.set()
        assert release.wait(30)
        return real(self, step)

    monkeypatch.setattr(SyntheticLMDataset, "batch", held)
    with profiled():
        ds = make_dataset(get_smoke_config("tinyllama-1.1b"),
                          DataConfig(seq_len=16, global_batch=2))
        assert begun.wait(30)       # batch 0 began under the profiler
    release.set()                   # and ends after it stopped
    try:
        next(iter(ds))
        _wait_for_batch(0)
    finally:
        ds.stop()
    assert rows() == [("data.batch", -1, 0)]


def test_spans_past_the_cap_count_as_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    disp = _dispatcher()
    with profiled():
        for _ in range(4):
            disp.decide(0, 8 * MIB, 8, axis_name="dp")
    assert trace.counters() == {"stored": 3, "drops": 9, "sessions": 1}
    assert [r[0] for r in rows()] == ["dispatch.lookup", "dispatch.log",
                                      "dispatch.decide"]
    trace.clear()
    with profiled():
        for k in range(7):
            with trace.span(trace.DATA_BATCH, k):
                pass
    assert trace.counters() == {"stored": 5, "drops": 2, "sessions": 1}
    assert list(trace.spans("data.batch")["id"]) == [0, 1, 2, 3, 4]


def test_the_clock_anchor_places_a_span_inside_its_profiler_range():
    disp = _dispatcher()
    with profiled() as prof:
        disp.decide(0, 4 * MIB, 8, axis_name="dp")        # anchors the store
        with record_function("test.around"):
            time.sleep(0.001)
            disp.decide(0, 8 * MIB, 8, axis_name="dp")
            time.sleep(0.001)
    ev = {e.name: e.time_range for e in prof.events()
          if e.name in (trace.CLOCK, "test.around")}
    a, b = trace.clock_anchor()
    assert a < b
    # host ns -> profiler us, the reading after the range at its end
    offset_us = b / 1e3 - ev[trace.CLOCK].end
    sp = trace.spans("dispatch.decide")
    start = sp["start_ns"][1] / 1e3 - offset_us
    end = start + sp["dur_ns"][1] / 1e3
    around = ev["test.around"]
    assert around.start - 50 <= start and end <= around.end + 50
    assert start - around.start >= 1000 - 50


def test_chip_smoke_breakdown_reads_the_bridge_spans():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_trace", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    disp = _dispatcher("torch", ("adapt_tuner",))
    disp.decide(0, 8 * MIB, 8, axis_name="dp")
    bridge = disp.runtime.chain("tuner")[0].fn
    calls = bridge.stats.calls
    parts = smoke.bridge_breakdown(bridge, reps=20)
    assert bridge.stats.calls == calls + 20
    assert list(parts) == ["call", "upload", "enqueue", "wait", "writeback"]
    assert all(v > 0 for v in parts.values())
    assert parts["call"] > sum(v for k, v in parts.items() if k != "call")


def test_threads_store_aligned_spans():
    """Many threads storing nested spans at once, with a short switch
    interval: every span stored once, its row whole (a child's parent is
    its thread's enclosing span, whose id it took)."""
    import sys
    import threading
    threads, reps = 16, 300
    store = trace.STORE

    def work(t):
        for k in range(reps):
            s = store.start()
            store.add(trace.DISPATCH_LOOKUP, store.start())
            store.add(trace.DISPATCH_DECIDE, s, t * reps + k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(t,))
              for t in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    got = rows()
    assert trace.counters()["stored"] == len(got) == 2 * threads * reps
    for name, parent, rid in got:
        if name == "dispatch.decide":
            assert parent == -1
        else:
            assert got[parent][0] == "dispatch.decide"
            assert got[parent][2] == rid
    assert sorted(trace.spans("dispatch.decide")["id"]) == \
        list(range(threads * reps))


# ---------------------------------------------------------------------------
# the held-expert layer: the moe.dispatch span and its two counters
# ---------------------------------------------------------------------------

def _moe_step(steps=1):
    """Train steps of the Moonlight smoke config (two expert layers,
    remat on) on the CPU."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.step import TrainStepConfig, make_train_step
    from repro_torch.collectives.dispatch import reset_dispatcher
    reset_dispatcher(runtime=PolicyRuntime(tier="jit"))
    cfg = get_smoke_config("moonlight-16b-a3b").with_overrides(
        dtype="float32", remat=True)
    params, specs = init_params(0, cfg, MeshAxes(), device="cpu")
    step, _ = make_train_step(cfg, MeshAxes(), None, specs,
                              TrainStepConfig())
    opt = adamw_init(params)
    tok = np.random.RandomState(0).randint(0, cfg.vocab, (2, 17))
    for _ in range(steps):
        params, opt, _ = step(params, opt, {"tokens": tok[:, :-1],
                                            "labels": tok[:, 1:]})
    return cfg


def test_expert_layer_records_nothing_with_the_profiler_off():
    _moe_step()
    assert trace.counters()["stored"] == 0
    assert trace.counter("moe.host_syncs") is None
    assert trace.counter("moe.pairs_held") is None


def test_expert_layer_records_its_dispatch_and_counts_under_a_session():
    with profiled():
        cfg = _moe_step(steps=2)
    n_moe = cfg.n_layers - cfg.first_k_dense
    # forward and recompute each read the group sizes once a layer
    assert len(trace.spans("moe.dispatch")["dur_ns"]) == 2 * 2 * n_moe
    assert trace.counter("moe.host_syncs") == {"total": 2 * 2 * n_moe,
                                               "additions": 2 * 2 * n_moe}
    held = trace.counter("moe.pairs_held")
    assert held["additions"] == 2 and held["total"].shape == (4,)
    # each step's pairs on the held experts, counted once a step
    assert 0 < held["total"].sum() <= 2 * n_moe * 2 * 16 * cfg.top_k
    # a new session begins with nothing counted
    _moe_step()
    with profiled():
        trace.bump(trace.MOE_HOST_SYNCS)
    assert trace.counter("moe.host_syncs")["total"] == 1
    assert trace.counter("moe.pairs_held") is None
