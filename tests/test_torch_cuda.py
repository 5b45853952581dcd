"""The CUDA policy kernel on the card.

Marked ``cuda``; every test skips without a CUDA device and nvcc.  Run
them on the card with::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

(``chip_smoke.py`` drives the same kernels through the full main path.)
"""

import numpy as np
import pytest
import torch

import torch_samples as samples
from repro_torch.core import PolicyRuntime, cudac, make_ctx, torchc
from repro_torch.core.vm import VM
from repro_torch.policies import (ALL_POLICIES, adapt_profiler, adapt_tuner,
                                  bucket_profiler, bucket_tuner)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import have_nvcc
    if not have_nvcc():
        pytest.skip("needs nvcc")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("pol", ALL_POLICIES, ids=lambda p: p.program.name)
def test_kernel_matches_plain_version_and_vm(card, pol):
    prog = pol.program
    k = cudac.PolicyKernel(prog).build()
    host = samples.make_maps(prog, np.random.default_rng(31))
    dev = {n: torchc.map_to_array(m, card) for n, m in host.items()}
    plain = {n: t.clone() for n, t in dev.items()}
    vm = VM(prog.insns, host, subprogs=prog.subprogs)
    rng = np.random.default_rng(32)
    for _ in range(6):
        buf = samples.make_ctx(prog, rng)
        ctx = torchc.ctx_to_vec(buf, card)
        ret = torch.zeros(1, dtype=torch.int64, device=card)
        k.launch(ctx, ret, dev)
        p_ret, p_ctx, plain = torchc.run(prog, k.vinfo,
                                         torchc.ctx_to_vec(buf, card), plain)
        v_buf = bytearray(buf)
        v_ret = vm.run(v_buf)
        torch.cuda.synchronize()
        assert int(ret[0]) == int(p_ret)
        assert int(ret[0]) & (2**64 - 1) == v_ret & (2**64 - 1)
        assert torchc.vec_to_bytes(ctx) == torchc.vec_to_bytes(p_ctx) \
            == bytes(v_buf)
        for n, m in host.items():
            assert torch.equal(dev[n], plain[n]), n
            assert np.array_equal(dev[n].cpu().numpy(),
                                  m.to_device().view("<i8")), n
    assert k.launches == 6


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    prog = bucket_tuner.program
    k = cudac.PolicyKernel(prog)
    maps = {n: torch.zeros(k.shapes[n], dtype=torch.int64, device=card)
            for n in k.names}
    ret = torch.zeros(1, dtype=torch.int64, device=card)
    ctx = torch.zeros(k.n_fields, dtype=torch.int64, device=card)
    with pytest.raises(cudac.CudacError, match="int64"):
        k.launch(ctx.to(torch.int32), ret, maps)
    with pytest.raises(cudac.CudacError, match="on cuda"):
        k.launch(ctx, ret, {n: t.cpu() for n, t in maps.items()})
    with pytest.raises(cudac.CudacError, match="contiguous"):
        k.launch(torch.zeros(2 * k.n_fields, dtype=torch.int64,
                             device=card)[::2], ret, maps)
    assert k.launches == 0


def test_cuda_closed_loop_matches_interp(card):
    def run(tier):
        from repro_torch.collectives import CollectiveDispatcher
        rt = PolicyRuntime(tier=tier)
        disp = CollectiveDispatcher(runtime=rt)
        link = rt.attach(bucket_tuner.program, priority=0)
        rt.attach(adapt_tuner.program, priority=1)
        rt.attach(adapt_profiler.program)
        rt.attach(bucket_profiler.program)
        rng = np.random.default_rng(9)
        out = []
        for i in range(300):
            if i == 150:
                link.replace(bucket_tuner.program)
            d = disp.decide(int(rng.integers(0, 3)),
                            1 << int(rng.integers(12, 31)), 8)
            out.append(d)
            disp.profiler_feed(d.comm_id, int(rng.integers(2_000, 3_000_000)),
                               coll=d.coll, msg_size=d.size_bytes)
        rt.flush_bridges()
        return out, {n: rt.maps.get(n).to_device().tobytes()
                     for n in rt.maps.names()}, rt

    builds = cudac.cache_stats()["builds"]
    got, got_maps, rt = run("cuda")
    want, want_maps, _ = run("interp")
    assert got == want and got_maps == want_maps
    stats = rt.bridge_stats()
    assert stats["host_fallbacks"] == 0
    # the first run may build; the warm replace never does
    rt2 = PolicyRuntime(tier="cuda")
    link = rt2.attach(bucket_tuner.program)
    before = cudac.cache_stats()["builds"]
    link.replace(bucket_tuner.program)
    assert cudac.cache_stats()["builds"] == before
    assert before - builds <= 4
    rt2.invoke("tuner", make_ctx("tuner", msg_size=1 << 20))
    assert rt2.attached("tuner").fn.kernel.launches == 1


# ---------------------------------------------------------------------------
# the pair-form kernel (B2, tier="cuda32") and the in-graph selector
# ---------------------------------------------------------------------------

PAIR_POLICIES = [p for p in ALL_POLICIES if cudac.supports_pairs(p.program)]


@pytest.mark.parametrize("pol", PAIR_POLICIES, ids=lambda p: p.program.name)
def test_pair_kernel_matches_plain_version_and_vm(card, pol):
    from repro_torch.core import pair
    prog = pol.program
    k = cudac.PolicyKernel(prog).build()
    host = samples.make_maps(prog, np.random.default_rng(41))
    dev = {n: pair.map_to_array32(m, card) for n, m in host.items()}
    plain = {n: t.clone() for n, t in dev.items()}
    vm = VM(prog.insns, host, subprogs=prog.subprogs)
    rng = np.random.default_rng(42)
    for _ in range(6):
        buf = samples.make_ctx(prog, rng)
        ctx = pair.ctx_to_vec32(buf, card)
        ret = torch.zeros(2, dtype=torch.int32, device=card)
        k.launch32(ctx, ret, dev)
        p_ret, p_ctx, plain = torchc.run32(prog, k.vinfo,
                                           pair.ctx_to_vec32(buf, card),
                                           plain)
        v_buf = bytearray(buf)
        v_ret = vm.run(v_buf) & (2**64 - 1)
        torch.cuda.synchronize()
        assert pair.ret32_to_int(ret) == pair.ret32_to_int(p_ret) == v_ret
        assert pair.vec32_to_bytes(ctx) == pair.vec32_to_bytes(p_ctx) \
            == bytes(v_buf)
        for n, m in host.items():
            assert torch.equal(dev[n], plain[n]), n
            assert dev[n].cpu().numpy().tobytes() == \
                m.to_device().tobytes(), n
    assert k.launches32 == 6 and k.launches == 0


def test_cuda32_runtime_closed_loop_matches_interp(card):
    def run(tier):
        from repro_torch.collectives import CollectiveDispatcher
        rt = PolicyRuntime(tier=tier)
        disp = CollectiveDispatcher(runtime=rt)
        rt.attach(bucket_tuner.program, priority=0)
        rt.attach(adapt_tuner.program, priority=1)
        rt.attach(adapt_profiler.program)
        rt.attach(bucket_profiler.program)
        rng = np.random.default_rng(19)
        out = []
        for _ in range(200):
            d = disp.decide(int(rng.integers(0, 3)),
                            1 << int(rng.integers(12, 31)), 8)
            out.append(d)
            disp.profiler_feed(d.comm_id, int(rng.integers(2_000, 3_000_000)),
                               coll=d.coll, msg_size=d.size_bytes)
        rt.flush_bridges()
        return out, {n: rt.maps.get(n).to_device().tobytes()
                     for n in rt.maps.names()}, rt

    got, got_maps, rt = run("cuda32")
    want, want_maps, _ = run("interp")
    assert got == want and got_maps == want_maps
    assert rt.bridge_stats()["host_fallbacks"] == 0
    launches = [l.fn.kernel.launches32 for s in rt.sections()
                for l in rt.chain(s)]
    assert all(n > 0 for n in launches)


def test_mesh_bridge_1_vs_8_shards_on_the_card(card):
    from repro_torch.core.bridge import compile_host
    from repro_torch.core.maps import MapRegistry

    def bridge(n_shards):
        prog = bucket_tuner.program
        reg = MapRegistry()
        maps = {d.name: reg.create(d.name, d.kind, key_size=d.key_size,
                                   value_size=d.value_size,
                                   max_entries=d.max_entries)
                for d in prog.maps}
        return compile_host(prog, maps, tier="cuda32", sync="deferred",
                            n_shards=n_shards), maps["bucket_tune_state"]

    b1, m1 = bridge(1)
    for _ in range(24):
        b1(make_ctx("tuner", msg_size=1 << 20, n_ranks=8,
                    max_channels=32).buf)
    b1.flush()
    b8, m8 = bridge(8)
    for _ in range(3):
        for s in (5, 2, 7, 0, 3, 6, 1, 4):
            b8.set_shard(s)
            b8(make_ctx("tuner", msg_size=1 << 20, n_ranks=8,
                        max_channels=32).buf)
    b8.flush()
    assert np.array_equal(m1.to_device(), m8.to_device())
    assert b8.stats.shard_merges == 1 and b8.kernel.launches32 == 24


@pytest.mark.parametrize("tier", ["cuda32", "cuda"])
def test_ingraph_selector_on_the_card_matches_torch(card, tier):
    from repro_torch.collectives.ingraph import (CURSOR_KEY, FAULT_KEY,
                                                 InGraphSelector)
    from repro_torch.core.pair import pairs_to_words
    sel = InGraphSelector(bucket_tuner.program, tier=tier)
    ref = InGraphSelector(bucket_tuner.program, tier="torch")
    state, rstate = sel.init_state(), ref.init_state()
    first = state
    base = {k: v.clone() for k, v in state.items()}
    rng = np.random.default_rng(23)
    for _ in range(100):
        size = 1 << int(rng.integers(12, 31))
        lat = torch.tensor(float(rng.choice([900.0, 5e6, 6.1e9])),
                           dtype=torch.float32)
        lat_card = lat.to(card)
        torch.cuda.set_sync_debug_mode("error")     # decide never syncs
        try:
            algo, ch, new = sel.decide(state, coll=0, msg_bytes=size, n=8,
                                       latency_ns=lat_card)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ralgo, rch, rstate = ref.decide(rstate, coll=0, msg_bytes=size,
                                        n=8, latency_ns=lat)
        assert (int(algo), int(ch)) == (int(ralgo), int(rch))
        state = new
    for k, v in state.items():
        got = v.cpu()
        if tier == "cuda32" and k not in (FAULT_KEY, CURSOR_KEY):
            got = pairs_to_words(got)
        assert torch.equal(got, rstate[k]), k
    for k in base:                      # decide never wrote the seed
        assert torch.equal(base[k], first[k]), k
    launched = sel.kernel.launches32 if tier == "cuda32" \
        else sel.kernel.launches
    assert launched == 100


# ---------------------------------------------------------------------------
# the sync-free in-graph step: torchc's predicated lowering and the
# captured all_reduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pol", ALL_POLICIES, ids=lambda p: p.program.name)
def test_predicated_on_the_card_equals_the_kernel(card, pol):
    """compile_predicated on the card, eagerly under sync-debug "error"
    and as replays of one capture, equals B1 bit for bit."""
    prog = pol.program
    k = cudac.PolicyKernel(prog).build()
    fn, names = torchc.compile_predicated(prog, k.vinfo)
    host = samples.make_maps(prog, np.random.default_rng(33))
    start = {n: torchc.map_to_array(m, card) for n, m in host.items()}
    rng = np.random.default_rng(34)
    ctxs = [torchc.ctx_to_vec(samples.make_ctx(prog, rng), card)
            for _ in range(3)]
    k_maps = {n: t.clone() for n, t in start.items()}
    p_maps = {n: t.clone() for n, t in start.items()}
    s_ctx = ctxs[0].clone()
    s_maps = {n: t.clone() for n, t in start.items()}
    fn(s_ctx, s_maps)                       # warm-up before the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        g_ret, g_ctx, g_maps = fn(s_ctx, s_maps)
    for c in ctxs:
        kc = c.clone()
        kr = torch.zeros(1, dtype=torch.int64, device=card)
        torch.cuda.set_sync_debug_mode("error")
        try:
            k.launch(kc, kr, k_maps)
            ret, ctx, p_maps = fn(c, p_maps)
            s_ctx.copy_(c)
            g.replay()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert int(ret) == int(kr[0]) == int(g_ret)
        assert torch.equal(ctx, kc) and torch.equal(g_ctx, kc)
        for n in names:
            assert torch.equal(p_maps[n], k_maps[n]), n
            assert torch.equal(g_maps[n], k_maps[n]), n
            s_maps[n].copy_(g_maps[n])


@pytest.fixture
def nccl_and_gloo(card):
    """A 1-rank NCCL group on the card (the default group) and a 1-rank
    gloo group beside it."""
    import socket

    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD, dist.new_group(backend="gloo")
    finally:
        dist.destroy_process_group()


def _adaptive_program():
    import repro_torch.core as core
    lat_map = core.map_decl("lat_map", kind="array", value_size=16,
                            max_entries=4)

    @core.policy(section="tuner", maps=[lat_map])
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
            ctx.algorithm = 2
            ctx.n_channels = 2
        else:
            ctx.algorithm = 0
            ctx.n_channels = 8
        return 0

    return adaptive_ingraph.program


@pytest.mark.parametrize("tier,device", [
    pytest.param("cuda", None, id="cuda"),
    pytest.param("cuda32", None, id="cuda32"),
    pytest.param("torchc", None, id="torchc"),
    pytest.param("torchc", "cuda", id="torchc-cuda"),
    pytest.param("torchc", "cuda:0", id="torchc-cuda:0")])
def test_captured_step_picks_the_branch_on_the_card(card, nccl_and_gloo,
                                                    tier, device):
    """sel.all_reduce captured once over a 1-rank NCCL group: its replays
    make no host read and give the eager run's algos and state.  The
    ``torchc`` selector is built with each spelling of the card (ROADMAP
    C10); its latency is a card tensor, which reports ``cuda:N``."""
    from repro_torch.collectives.ingraph import CURSOR_KEY, InGraphSelector
    nccl, gloo = nccl_and_gloo
    lats = [1_000] * 4 + [5_000_000] * 6 + [1_000] * 8
    kw = {} if device is None else {"device": device}
    sel = InGraphSelector(_adaptive_program(), tier=tier, **kw)
    assert sel.device == card
    x = torch.arange(1 << 16, dtype=torch.float32, device=card)
    lat = torch.zeros((), dtype=torch.int64, device=card)
    state, eager = sel.init_state(), []
    for v in lats:
        lat.fill_(v)
        y, algo, state = sel.all_reduce(x, "data", state, group=nccl,
                                        latency_ns=lat)
        eager.append(int(algo))
    assert eager[0] == 0 and 2 in eager and eager[-1] == 0
    syncs = sel.host_syncs
    static = sel.init_state()
    log = torch.full((len(lats),), -1, dtype=torch.int32, device=card)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        cur = static[CURSOR_KEY].to(torch.int64)
        y, algo, new = sel.all_reduce(x, "data", static, group=nccl,
                                      latency_ns=lat)
        log.index_copy_(0, cur, algo.reshape(1))
        for key in static:
            static[key].copy_(new[key])
    torch.cuda.set_sync_debug_mode("error")
    try:
        for v in lats:
            lat.fill_(v)
            g.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert log.tolist() == eager
    assert sel.host_syncs == syncs
    assert torch.equal(y, x)
    for key in static:
        assert torch.equal(static[key], state[key]), key


def test_a_switch_capture_when_the_stream_pool_comes_round(card,
                                                           nccl_and_gloo):
    """torch hands out its pool's streams in turn: with the capture on a
    pool stream, the draw for the switch node's bodies lands on that
    stream once per turn of the pool.  The capture still takes it, and
    its replays pick the branch."""
    import torch.distributed as dist

    from repro_torch.collectives.ingraph import InGraphSelector
    nccl, _ = nccl_and_gloo
    sel = InGraphSelector(_adaptive_program(), tier="cuda")
    x = torch.arange(1 << 10, dtype=torch.float32, device=card)
    lat = torch.full((), 5_000_000, dtype=torch.int64, device=card)
    dist.all_reduce(x.clone(), group=nccl)      # NCCL's communicator, eagerly
    torch.cuda.synchronize()
    main = torch.cuda.Stream()
    period = 1
    while torch.cuda.Stream().cuda_stream != main.cuda_stream:
        period += 1
    for _ in range(period - 1):     # the next draw is the capture stream
        torch.cuda.Stream()
    static = sel.init_state()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=main):
        y, algo, new = sel.all_reduce(x, "data", static, group=nccl,
                                      latency_ns=lat)
        for key in static:
            static[key].copy_(new[key])
    for _ in range(3):
        g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, x)
    assert int(algo) == 2                           # tree: slow latency


def test_a_capture_over_a_gloo_group_raises(card, nccl_and_gloo):
    from repro_torch.collectives.ingraph import InGraphSelector
    _, gloo = nccl_and_gloo
    sel = InGraphSelector(_adaptive_program(), tier="cuda")
    state = sel.init_state()
    x = torch.ones(8, device=card)
    with pytest.raises(RuntimeError, match="backend is 'gloo'"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            sel.all_reduce(x, "data", state, group=gloo,
                           latency_ns=torch.zeros((), dtype=torch.int64,
                                                  device=card))


def _run_views(k, prog, host, bufs, card, misalign: bool) -> None:
    """Each ctx buffer through ``k`` on the card, ctx and maps in views
    that start 8 bytes past a 16-byte bound with ``misalign``, held to
    the plain version and the interpreter, maps carried along."""
    def view(t):
        buf = torch.zeros(t.numel() + 2, dtype=torch.int64, device=card)
        off = (-buf.data_ptr() % 16) // 8 + (1 if misalign else 0)
        v = buf[off:off + t.numel()].view(t.shape)
        v.copy_(t)
        assert (v.data_ptr() % 16 == 8) == misalign
        return v

    dev = {n: view(torchc.map_to_array(m, card)) for n, m in host.items()}
    plain = {n: t.clone() for n, t in dev.items()}
    vm = VM(prog.insns, host, subprogs=prog.subprogs)
    for buf in bufs:
        ctx = view(torchc.ctx_to_vec(buf, card))
        ret = view(torch.zeros(1, dtype=torch.int64, device=card))
        k.launch(ctx, ret, dev)
        p_ret, p_ctx, plain = torchc.run(prog, k.vinfo,
                                         torchc.ctx_to_vec(buf, card), plain)
        v_buf = bytearray(buf)
        v_ret = vm.run(v_buf) & (2**64 - 1)
        torch.cuda.synchronize()
        assert int(ret[0]) & (2**64 - 1) == int(p_ret) & (2**64 - 1) == v_ret
        assert torchc.vec_to_bytes(ctx) == bytes(v_buf)
        for n, m in host.items():
            assert torch.equal(dev[n], plain[n]), n
            assert np.array_equal(dev[n].cpu().numpy(),
                                  m.to_device().view("<i8")), n


_DESIGNS = {"shipped": {}, "memory": {"route": "memory"}}


@pytest.mark.parametrize("misalign", [False, True], ids=["aligned16",
                                                         "aligned8"])
@pytest.mark.parametrize("design", list(_DESIGNS))
def test_designs_bit_exact_on_views(card, design, misalign):
    """The shipped kernels and the memory route, with ctx and every map
    16-byte aligned or only 8-byte aligned (views of a larger buffer):
    bit-exact for every shipped policy."""
    ks = cudac.build_bundle(
        cudac.PolicyKernel(pol.program, prefix=f"v{i}_", **_DESIGNS[design])
        for i, pol in enumerate(ALL_POLICIES))
    for i, k in enumerate(ks):
        prog = k.prog
        assert set(k.source.routes) == ({"memory"} if design == "memory"
                                        else {"regs"})
        host = samples.make_maps(prog, np.random.default_rng(100 + i))
        rng = np.random.default_rng(101 + i)
        bufs = [samples.make_ctx(prog, rng) for _ in range(4)]
        _run_views(k, prog, host, bufs, card, misalign)


def test_hash_chains_on_the_card(card):
    """Hash tables of 100, 2,100 and 10,000 rows whose chains wrap past
    the last row, probed by the warp: bit-exact on the card, with no
    local memory; the 2,100-row kernel also captured in a CUDA graph and
    replayed against eager launches."""
    for rows in (100, 2100, 10_000):
        prog, host, bufs = samples.hash_chain_case(rows)
        k = cudac.PolicyKernel(prog, prefix=f"c{rows}_").build()
        assert k.source.threads == 32
        assert k.attributes()["kernel"]["local_bytes"] == 0
        _run_views(k, prog, host, bufs, card, misalign=False)
    prog, host, bufs = samples.hash_chain_case(2100)
    k = cudac.PolicyKernel(prog, prefix="g2100_").build()
    maps = {n: torchc.map_to_array(m, card) for n, m in host.items()}
    eager = {n: t.clone() for n, t in maps.items()}
    ctx = torchc.ctx_to_vec(bufs[0], card)
    ret = torch.zeros(1, dtype=torch.int64, device=card)
    e_ctx, e_ret = ctx.clone(), ret.clone()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=side):
            k.launch(ctx, ret, maps)
    for buf in bufs:
        c = torchc.ctx_to_vec(buf, card)
        ctx.copy_(c)
        e_ctx.copy_(c)
        g.replay()
        k.launch(e_ctx, e_ret, eager)
        torch.cuda.synchronize()
        assert torch.equal(ret, e_ret) and torch.equal(ctx, e_ctx)
    for n in maps:
        assert torch.equal(maps[n], eager[n]), n


@pytest.mark.parametrize("g", samples.loop_chain_goldens(),
                         ids=lambda g: g.id)
def test_loop_chains_build_in_time(card, g, monkeypatch):
    """A 65-step chain through a map cell, a stack slot or a register
    builds within two minutes of nvcc (a full unroll of such a loop can
    take more than ten), and both entries agree with the interpreter."""
    import repro_torch.core as C
    from repro_torch.core import pair

    monkeypatch.setattr(cudac, "NVCC_TIMEOUT_S", 120)
    prog = g.program(C)
    k = cudac.PolicyKernel(prog, prefix="chain_").build()
    assert k.attributes()["kernel"]["local_bytes"] == 0
    buf = C.make_ctx("tuner", **samples.PAIR_CTX).buf
    host = g.host_maps(C)
    v_buf = bytearray(buf)
    v_ret = VM(prog.insns, host).run(v_buf) & (2**64 - 1)
    for pairs in (False, True):
        h = g.host_maps(C)
        if pairs:
            maps = {n: pair.map_to_array32(m, card) for n, m in h.items()}
            ctx = pair.ctx_to_vec32(buf, card)
            ret = torch.zeros(2, dtype=torch.int32, device=card)
            k.launch32(ctx, ret, maps)
            torch.cuda.synchronize()
            assert pair.ret32_to_int(ret) == v_ret
            words = {n: t.cpu().numpy().reshape(-1).view("<i8")
                     for n, t in maps.items()}
            ctx_bytes = ctx.cpu().numpy().tobytes()
        else:
            maps = {n: torchc.map_to_array(m, card) for n, m in h.items()}
            ctx = torchc.ctx_to_vec(buf, card)
            ret = torch.zeros(1, dtype=torch.int64, device=card)
            k.launch(ctx, ret, maps)
            torch.cuda.synchronize()
            assert int(ret[0]) & (2**64 - 1) == v_ret
            words = {n: t.cpu().numpy().reshape(-1) for n, t in maps.items()}
            ctx_bytes = torchc.vec_to_bytes(ctx)
        assert ctx_bytes == bytes(v_buf)
        for n, m in host.items():
            assert np.array_equal(words[n],
                                  m.to_device().view("<i8").reshape(-1)), n
