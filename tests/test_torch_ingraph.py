"""In-graph policy selection, port against reference.

``repro_torch.collectives.ingraph.InGraphSelector`` on ``tier="torch"``
(the plain PyTorch policy kernel on the CPU), on ``tier="cuda32"``'s
pair path (the same selector with its device pinned to the CPU, where
the pair-form kernel's wrapper runs its plain version) and on
``tier="torchc"`` with ``device="cpu"`` (the predicated lowering) against the
reference's ``InGraphSelector`` on ``tier="pallas32"`` and ``"pallas"``
(the Pallas kernels in interpret mode, jitted as the reference's tests
run them).  A seeded 200-step loop of ``adaptive_ingraph``
(``tests/test_ingraph_dispatch.py``) and ``bucket_tuner``: every step's
``algo`` and ``channels``, the fault flag, the cursor and every map leaf
must be equal.  Latencies are float32, some above 2**32 ns, so the
32-bit path's hi/lo split is exercised.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as ref_core
import repro.policies.telemetry as ref_tel
import repro_torch.core as port_core
import repro_torch.policies.telemetry as port_tel
from repro.collectives.ingraph import InGraphSelector as RefSelector
from repro.compat import enable_x64
from repro.core.shardmerge import pairs_to_u64
from repro_torch.collectives import ingraph
from repro_torch.core import graphs
from repro_torch.collectives.ingraph import (CURSOR_KEY, FAULT_KEY,
                                             InGraphSelector)
from repro_torch.core.cudac import CudacError
from repro_torch.core.torchc import TorchcError
from repro_torch.device import DeviceError

N_STEPS = 200
MiB = 1 << 20


def _adaptive(ns):
    """``adaptive_ingraph`` of tests/test_ingraph_dispatch.py, built with
    one package's frontend."""
    lat_map = ns.map_decl("lat_map", kind="array", value_size=16,
                          max_entries=4)

    @ns.policy(section="tuner", maps=[lat_map])
    def adaptive_ingraph(ctx):
        st = lat_map.lookup(0)
        if st is None:
            ctx.algorithm = 0
            return 0
        if st[0] == 0:
            st[0] = ctx.dtype_bytes
        else:
            st[0] = (st[0] * 3 + ctx.dtype_bytes) // 4
        st[1] = st[1] + 1
        if st[0] > 1000000:
            ctx.algorithm = 2          # tree: latency-optimized
            ctx.n_channels = 2
        else:
            ctx.algorithm = 0          # default
            ctx.n_channels = 8
        return 0

    return adaptive_ingraph.program


def _out_of_domain(ns):
    """Decides an algorithm and a channel count outside the domain."""
    @ns.policy(section="tuner", maps=[])
    def wild(ctx):
        ctx.algorithm = 7
        ctx.n_channels = 40
        return 0

    return wild.program


PROGRAMS = {
    "adaptive_ingraph": (lambda: _adaptive(ref_core),
                         lambda: _adaptive(port_core)),
    "bucket_tuner": (lambda: ref_tel.bucket_tuner.program,
                     lambda: port_tel.bucket_tuner.program),
}


def _stream(name: str):
    rng = np.random.default_rng(17)
    if name == "adaptive_ingraph":
        # fast, a slow burst (some latencies above 2**32 ns), recovery
        lats = np.concatenate([
            rng.uniform(500, 5_000, 50),
            rng.choice([5e6, 6.123456789e9], 50),
            rng.uniform(500, 5_000, 100)]).astype(np.float32)
        sizes = np.full(N_STEPS, MiB)
    else:   # three sizes: the reference compiles one step per size
        lats = rng.choice(np.array([900.0, 2.5e5, 5e6, 6.123456789e9],
                                   dtype=np.float32), N_STEPS)
        sizes = rng.choice([4 << 10, MiB, 1 << 30], N_STEPS)
    return [(int(s), np.float32(t)) for s, t in zip(sizes, lats)]


def _u64(arr, pairs: bool) -> np.ndarray:
    a = np.asarray(arr)
    return pairs_to_u64(a) if pairs else a.astype("<u8")


def _port_leaves(sel, state) -> dict:
    out = {}
    for k, v in state.items():
        a = v.numpy()
        if k in (FAULT_KEY, CURSOR_KEY):
            out[k] = a.view("<u4").astype("<u8")
        else:
            out[k] = _u64(a.view("<u4"), True) if sel.word_width == 32 \
                else a.view("<u8")
    return out


@functools.lru_cache(maxsize=None)
def _reference_run(name: str, tier: str):
    """Per step: (algo, channels, {leaf: u64 image}) of the reference."""
    prog = PROGRAMS[name][0]()
    sel = RefSelector(prog, tier=tier)
    state = sel.init_state()
    steps = {}

    def step_fn(size):
        if size not in steps:
            steps[size] = jax.jit(lambda st, lat: sel.decide(
                st, coll=0, msg_bytes=size, n=8, latency_ns=lat))
        return steps[size]

    out = []
    for size, lat in _stream(name):
        if tier == "pallas":
            with enable_x64(True):
                algo, ch, state = step_fn(size)(state, jnp.float32(lat))
        else:
            algo, ch, state = step_fn(size)(state, jnp.float32(lat))
        leaves = {}
        for k, v in state.items():
            if k in (FAULT_KEY, CURSOR_KEY):
                leaves[k] = np.asarray(v).astype("<u8")
            else:
                leaves[k] = _u64(v, tier == "pallas32")
        out.append((int(algo), int(ch), leaves))
    return out


def _port_selector(prog, tier: str, monkeypatch) -> InGraphSelector:
    if tier == "torchc@cpu":
        # the predicated lowering, asked for on the CPU
        return InGraphSelector(prog, tier="torchc", device="cpu")
    if tier == "cuda32@cpu":
        # the cuda32 selector with its device pinned to the CPU: its
        # pair-form path runs, through the wrapper's plain version
        monkeypatch.setattr(ingraph, "require_cuda",
                            lambda what: torch.device("cpu"))
        return InGraphSelector(prog, tier="cuda32")
    return InGraphSelector(prog, tier=tier)


@pytest.mark.parametrize("port_tier", ["torch", "cuda32@cpu", "torchc@cpu"])
@pytest.mark.parametrize("ref_tier", ["pallas32", "pallas"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_decisions_and_state_match_reference(name, ref_tier, port_tier,
                                             monkeypatch):
    want = _reference_run(name, ref_tier)
    sel = _port_selector(PROGRAMS[name][1](), port_tier, monkeypatch)
    state = sel.init_state()
    algos = set()
    for i, (size, lat) in enumerate(_stream(name)):
        algo, ch, state = sel.decide(state, coll=0, msg_bytes=size, n=8,
                                     latency_ns=torch.tensor(lat))
        w_algo, w_ch, w_leaves = want[i]
        assert (int(algo), int(ch)) == (w_algo, w_ch), i
        got = _port_leaves(sel, state)
        assert sorted(got) == sorted(w_leaves)
        for k in got:
            assert np.array_equal(got[k], w_leaves[k]), (i, k)
        algos.add(int(algo))
    assert int(state[CURSOR_KEY][0]) == N_STEPS
    assert sel.kernel.launches + sel.kernel.launches32 == 0   # plain only
    if name == "adaptive_ingraph":
        assert algos == {0, 2}


@pytest.mark.parametrize("tier", ["torch", "cuda32@cpu", "torchc@cpu"])
def test_decide_leaves_the_old_state_unchanged(tier, monkeypatch):
    sel = _port_selector(port_tel.bucket_tuner.program, tier, monkeypatch)
    base = sel.init_state()
    snap = {k: v.clone() for k, v in base.items()}
    _, _, new = sel.decide(base, coll=0, msg_bytes=MiB, n=8)
    _, _, new = sel.decide(new, coll=0, msg_bytes=MiB, n=8)
    for k in base:
        assert torch.equal(base[k], snap[k]), k
    assert "bucket_tune_state" in sel.written_names
    assert not torch.equal(new["bucket_tune_state"],
                           base["bucket_tune_state"])
    assert new["bucket_tune_state"] is not base["bucket_tune_state"]
    # a lookup-only leaf is shared with the old state, not copied
    from repro_torch.policies.loops import latency_argmin_tuner
    sel2 = _port_selector(latency_argmin_tuner.program, tier, monkeypatch)
    st = sel2.init_state()
    _, _, st2 = sel2.decide(st, coll=0, msg_bytes=MiB, n=8)
    assert not sel2.written_names
    assert st2["config_lat_map"] is st["config_lat_map"]


@pytest.mark.parametrize("tier", ["torch", "cuda32@cpu", "torchc@cpu"])
def test_float_latency_above_2_32_reaches_the_policy_exactly(tier,
                                                             monkeypatch):
    """The 32-bit path splits a float latency into hi/lo lanes in
    float32 arithmetic, as the reference does: the map holds the float32
    value's integer, bit for bit."""
    lat = np.float32(6.123456789e9)
    sel = _port_selector(_adaptive(port_core), tier, monkeypatch)
    reg = port_core.MapRegistry()
    reg.create("lat_map", "array", value_size=16, max_entries=4)
    state = sel.init_state(reg)
    _, _, state = sel.decide(state, coll=0, msg_bytes=MiB, n=8,
                             latency_ns=torch.tensor(lat))
    got = _port_leaves(sel, state)["lat_map"]
    assert int(got[0, 0]) == int(lat) > 2 ** 32

    ref = RefSelector(_adaptive(ref_core), tier="pallas32")
    _, _, rst = ref.decide(ref.init_state(), coll=0, msg_bytes=MiB, n=8,
                           latency_ns=jnp.float32(lat))
    assert np.array_equal(got, _u64(rst["lat_map"], True))


@pytest.mark.parametrize("tier", ["torch", "cuda32@cpu", "torchc@cpu"])
def test_clamp_counts_faults_and_counters_wrap_like_reference(tier,
                                                              monkeypatch):
    sel = _port_selector(_out_of_domain(port_core), tier, monkeypatch)
    ref = RefSelector(_out_of_domain(ref_core), tier="pallas32")
    state = sel.init_state()
    rstate = ref.init_state()
    # uint32 wrap-around: 2**31 - 1 -> 2**31, 2**32 - 1 -> 0
    state[FAULT_KEY] = torch.tensor([0x7FFFFFFF], dtype=torch.int32)
    state[CURSOR_KEY] = torch.tensor([-1], dtype=torch.int32)
    rstate[FAULT_KEY] = jnp.asarray([0x7FFFFFFF], jnp.uint32)
    rstate[CURSOR_KEY] = jnp.asarray([0xFFFFFFFF], jnp.uint32)
    algo, ch, state = sel.decide(state, coll=0, msg_bytes=MiB, n=8)
    ralgo, rch, rstate = ref.decide(rstate, coll=0, msg_bytes=MiB, n=8)
    assert (int(algo), int(ch)) == (int(ralgo), int(rch)) == (3, 32)
    got = _port_leaves(sel, state)
    for k in (FAULT_KEY, CURSOR_KEY):
        assert np.array_equal(got[k], np.asarray(rstate[k]).astype("<u8"))
    assert int(got[FAULT_KEY][0]) == 0x80000000
    assert int(got[CURSOR_KEY][0]) == 0
    n, state = sel.drain_faults(state)
    rn, _ = ref.drain_faults(rstate)
    assert n == rn == 0x80000000
    assert int(state[FAULT_KEY][0]) == 0
    assert sel.drain_faults({"x": 1}) == (0, {"x": 1})


def test_tiers_and_errors():
    assert InGraphSelector.TIERS == ("torch", "cuda", "cuda32", "torchc")
    with pytest.raises(ValueError, match="unknown in-graph tier"):
        InGraphSelector(port_tel.bucket_tuner.program, tier="pallas")
    from repro_torch.policies.profiler import straggler_trap
    with pytest.raises(CudacError) as ei:
        InGraphSelector(straggler_trap.program, tier="cuda32")
    msg = str(ei.value)
    assert "lru_hash" in msg and "'ema_map'" in msg and "cuda32" in msg
    assert 'kind="hash"' in msg and "word_width=64" in msg
    assert "host tier" in msg
    # the 64-bit selector takes the LRU program
    InGraphSelector(straggler_trap.program, tier="torch")


def test_cuda_tiers_without_a_device_raise():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for tier in ("cuda", "cuda32"):
        with pytest.raises(DeviceError, match=tier):
            InGraphSelector(port_tel.bucket_tuner.program, tier=tier)
    with pytest.raises(DeviceError):
        InGraphSelector(port_tel.bucket_tuner.program)   # default: cuda


@pytest.fixture
def one_rank_group():
    """A 1-rank gloo group in this process."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("tier", ["torch", "torchc@cpu"])
def test_all_reduce_reads_one_decision_per_step(one_rank_group, tier,
                                                monkeypatch):
    sel = _port_selector(_adaptive(port_core), tier, monkeypatch)
    state = sel.init_state()
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    picks = []
    for lat in [1_000.0] * 3 + [5e6] * 4:
        y, algo, state = sel.all_reduce(x, "data", state,
                                        group=one_rank_group,
                                        latency_ns=torch.tensor(lat))
        assert torch.equal(y, x)             # one rank: the sum is x
        picks.append(int(algo))
    assert picks[0] == 0 and picks[-1] == 2
    assert sel.host_syncs == 7
    assert int(state[CURSOR_KEY][0]) == 7


def test_torchc_tier_needs_a_device_or_the_cpu():
    prog = port_tel.bucket_tuner.program
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError, match="torchc"):
            InGraphSelector(prog, tier="torchc")
    assert InGraphSelector(prog, tier="torchc", device="cpu").device \
        == torch.device("cpu")
    with pytest.raises(ValueError, match="device= is for tier='torchc'"):
        InGraphSelector(prog, tier="torch", device="cpu")


def test_torchc_tier_rejects_what_jaxc_rejects():
    """The reference's jaxc tier and the port's torchc tier refuse a
    wall-clock helper with one message."""
    from repro.core import assemble as ref_assemble
    from repro.core.jaxc import JaxcError
    from repro_torch.core import assemble
    text = """
        call   ktime_get_ns
        mov64  r0, 0
        exit
    """
    with pytest.raises(JaxcError) as ref:
        RefSelector(ref_assemble(text, name="clock", section="tuner"),
                    tier="jaxc")
    with pytest.raises(TorchcError) as got:
        InGraphSelector(assemble(text, name="clock", section="tuner"),
                        tier="torchc", device="cpu")
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("tier", ["torch", "cuda32@cpu", "torchc@cpu"])
def test_the_reference_tests_adaptive_stream(tier, monkeypatch):
    """The stream of tests/test_ingraph_dispatch.py's
    ``test_decisions_adapt_without_retrace``: fast, slow, recovered; the
    reference's decisions and ``lat_map`` (its jaxc tier)."""
    lats = [1_000] * 4 + [5_000_000] * 6 + [1_000] * 8
    ref = RefSelector(_adaptive(ref_core))
    rstate = ref.init_state()
    step = jax.jit(lambda st, lat: ref.decide(
        st, coll=0, msg_bytes=1 << 20, n=8, latency_ns=lat))
    want = []
    with enable_x64(True):
        for lat in lats:
            algo, _, rstate = step(rstate, jnp.uint32(lat))
            want.append(int(algo))
    sel = _port_selector(_adaptive(port_core), tier, monkeypatch)
    state = sel.init_state()
    seen = []
    for lat in lats:
        algo, _, state = sel.decide(state, coll=0, msg_bytes=1 << 20, n=8,
                                    latency_ns=torch.tensor(lat))
        seen.append(int(algo))
    assert seen == want
    assert seen[0] == 0 and 2 in seen and seen[-1] == 0
    got = _port_leaves(sel, state)["lat_map"]
    assert int(got[0, 1]) == len(seen)
    assert np.array_equal(got, np.asarray(rstate["lat_map"]).astype("<u8"))


@pytest.mark.parametrize("tier", ["torch", "cuda32@cpu", "torchc@cpu"])
def test_the_capture_path_builds_the_eager_ctx(tier, monkeypatch):
    """Inside a capture the ctx words are fills on the device, not a copy
    from host memory: the same words as the eager path, and the same
    decision and state."""
    sel = _port_selector(_adaptive(port_core), tier, monkeypatch)
    for lat in (np.float32(6.123456789e9), torch.tensor(np.float32(5e6)),
                12_345, torch.tensor(7), (1 << 64) - 5):
        fields = {"coll_type": 2, "msg_size": 1 << 30, "n_ranks": 8,
                  "comm_id": 3, "max_channels": 32, "dtype_bytes": lat}
        eager = sel._ctx_vec(fields)
        state = sel.init_state()
        e_out = sel.decide(state, coll=2, msg_bytes=1 << 30, n=8,
                           latency_ns=lat)
        with monkeypatch.context() as m:
            m.setattr(graphs, "capturing", lambda: True)
            captured = sel._ctx_vec(fields)
            c_out = sel.decide(state, coll=2, msg_bytes=1 << 30, n=8,
                               latency_ns=lat)
        assert torch.equal(captured, eager), lat
        assert [int(t) for t in c_out[:2]] == [int(t) for t in e_out[:2]]
        for k in state:
            assert torch.equal(c_out[2][k], e_out[2][k]), (lat, k)


CPU_SPELLINGS = ["cpu", "cpu:0", torch.device("cpu"), torch.device("cpu", 0)]
CPU_IDS = ["cpu", "cpu:0", "device(cpu)", "device(cpu, 0)"]


@pytest.mark.parametrize("device", CPU_SPELLINGS, ids=CPU_IDS)
def test_a_captured_step_takes_every_spelling_of_its_device(device,
                                                            monkeypatch):
    """ROADMAP C10: a ``torchc`` selector built with any spelling of the
    CPU holds the device its tensors report, so a captured step fed a
    tensor made there decides.  Over the reference test's stream, the
    captured ``_ctx_vec`` and ``decide`` give the eager run's ctx words,
    decisions and state, byte for byte, and the same as the selector
    built with ``"cpu"``."""
    prog = _adaptive(port_core)
    sel = InGraphSelector(prog, tier="torchc", device=device)
    ref = InGraphSelector(prog, tier="torchc", device="cpu")
    assert sel.device == ref.device == torch.empty(0, device=device).device
    eager, captured, base = (sel.init_state(), sel.init_state(),
                             ref.init_state())
    for lat in [1_000] * 4 + [5_000_000] * 6 + [1_000] * 8:
        fields = {"coll_type": 0, "msg_size": MiB, "n_ranks": 8,
                  "comm_id": 0, "max_channels": 32,
                  "dtype_bytes": torch.tensor(lat, device=device)}
        e_vec = sel._ctx_vec(fields)
        e_algo, e_ch, eager = sel.decide(eager, coll=0, msg_bytes=MiB, n=8,
                                         latency_ns=fields["dtype_bytes"])
        with monkeypatch.context() as m:
            m.setattr(graphs, "capturing", lambda: True)
            c_vec = sel._ctx_vec(fields)
            c_algo, c_ch, captured = sel.decide(
                captured, coll=0, msg_bytes=MiB, n=8,
                latency_ns=fields["dtype_bytes"])
        b_algo, b_ch, base = ref.decide(base, coll=0, msg_bytes=MiB, n=8,
                                        latency_ns=torch.tensor(lat))
        assert c_vec.numpy().tobytes() == e_vec.numpy().tobytes(), lat
        assert (int(c_algo), int(c_ch)) == (int(e_algo), int(e_ch)) \
            == (int(b_algo), int(b_ch)), lat
        for k in base:
            assert captured[k].numpy().tobytes() \
                == eager[k].numpy().tobytes() \
                == base[k].numpy().tobytes(), (lat, k)
    assert int(base["lat_map"][0, 1]) == 18


def test_a_captured_step_refuses_a_tensor_on_another_device(monkeypatch):
    """The compare stays strict: a tensor that really lies elsewhere
    would be read once, at capture, so a captured step refuses it — a
    meta tensor fed to a CPU step, a CPU tensor fed to a card step."""
    from repro_torch import device as devmod
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    sel = InGraphSelector(_adaptive(port_core), tier="torchc", device="cpu:0")
    with pytest.raises(ValueError, match="on cpu, got one on meta"):
        sel._ctx_vec({"dtype_bytes": torch.zeros((), dtype=torch.int64,
                                                 device="meta")})
    # a card selector, with the card faked: the refusal comes before
    # anything is made on the device
    monkeypatch.setattr(devmod, "have_cuda", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(graphs, "build", lambda: None)
    for device in (None, "cuda", "cuda:0"):
        sel = InGraphSelector(_adaptive(port_core), tier="torchc",
                              device=device)
        with pytest.raises(ValueError, match="on cuda:0, got one on cpu"):
            sel._ctx_vec({"dtype_bytes": torch.tensor(7)})


def test_a_capture_with_a_gloo_group_raises(one_rank_group, monkeypatch):
    """gloo's collectives run on the host, so a captured step over a gloo
    group is refused before it decides, with the backend named."""
    sel = InGraphSelector(_adaptive(port_core), tier="torch")
    state = sel.init_state()
    monkeypatch.setattr(graphs, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="backend is 'gloo'"):
        sel.all_reduce(torch.ones(4), "data", state, group=one_rank_group,
                       latency_ns=torch.tensor(1_000.0))
    assert sel.host_syncs == 0
