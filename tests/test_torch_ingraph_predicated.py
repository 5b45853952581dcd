"""``torchc``'s predicated lowering against the reference's ``jaxc``.

``repro_torch.core.torchc.compile_predicated`` is the port of
``repro.core.jaxc``'s if-conversion: the sync-free form that the
in-graph selector's ``tier="torchc"`` runs and a CUDA graph can capture.
On the CPU it is held, bit for bit (ret, the ctx words and every map
word; no tolerance), to

* the reference's ``jaxc.compile_jax`` (jitted under the x64 scope, as
  ``tests/test_jaxc.py`` runs it) and the host-driven ``torchc.run``,
  over seeded maps and ctx samples of ``tests/torch_samples.py``, for
  every shipped policy (``check_supported`` admits them all), map state
  carried from sample to sample on every side;
* the cases of ``tests/test_jaxc.py``, against the port's interpreter
  and the reference's ``jaxc``;
* the interpreter and ``torchc.run`` on the seeded soups of
  ``tests/test_torch_property_tiers.py`` (straight-line boundary soups,
  hash soups, call soups);
* ROADMAP C2 (a hash chain that wraps past the last row) and a loop cut
  below its trip count (the function returns 0, as ``torchc.run``).

No host read: a ``TorchDispatchMode`` counts ``aten._local_scalar_dense``
(what ``.item()`` and ``bool(tensor)`` reach) during every predicated
call: 0, where the host-driven ``_Machine`` makes one per taken branch.
"""

import random

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import test_torch_property_tiers as soups
import torch_ref
import torch_samples as samples
import repro_torch.core as port_core
from repro_torch.core import PolicyRuntime, make_ctx, torchc
from repro_torch.core.context import POLICY_CONTEXT
from repro_torch.core.verifier import verify_with_info
from repro_torch.core.vm import VM
from repro_torch.policies import (ALL_POLICIES, adapt_tuner,
                                  adaptive_channels, bad_channels,
                                  ring_mid_v2, size_aware)

N_SAMPLES = 2
MiB = 1 << 20
FIELDS = list(POLICY_CONTEXT.fields)
M64 = (1 << 64) - 1


class ScalarReads(TorchDispatchMode):
    """Counts the ATen op every host read of a tensor's value reaches."""

    def __init__(self):
        super().__init__()
        self.reads = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


def _jax():
    from repro.compat import have_x64
    if not have_x64():
        pytest.skip("jax build lacks a working enable_x64")
    import jax

    from repro.compat import enable_x64
    from repro.core import jaxc
    return jax, enable_x64, jaxc


def _u64(ret) -> int:
    return int(ret) & M64


@pytest.mark.parametrize("pol", ALL_POLICIES, ids=lambda p: p.program.name)
def test_predicated_equals_jaxc_and_host_driven(pol):
    jax, enable_x64, jaxc = _jax()
    import jax.numpy as jnp

    prog = pol.program
    vinfo = verify_with_info(prog)
    torchc.check_supported(prog)
    seed = sum(map(ord, prog.name))
    host = samples.make_maps(prog, np.random.default_rng(seed))
    arrays = {n: m.to_device() for n, m in host.items()}      # u64 images
    pmaps = {n: torch.from_numpy(a.view("<i8").copy())
             for n, a in arrays.items()}
    hmaps = {n: t.clone() for n, t in pmaps.items()}
    fn, names = torchc.compile_predicated(prog, vinfo)
    jfn = jax.jit(jaxc.compile_jax(torch_ref.program(prog))[0])
    rng = np.random.default_rng(seed + 1)
    probe = ScalarReads()
    with enable_x64(True):
        jmaps = {n: jnp.asarray(a, jnp.uint64) for n, a in arrays.items()}
        for _ in range(N_SAMPLES):
            buf = samples.make_ctx(prog, rng)
            jret, jctx, jmaps = jfn(
                jnp.asarray(np.frombuffer(bytes(buf), "<u8")), jmaps)
            with probe:
                ret, ctx, pmaps = fn(torchc.ctx_to_vec(buf), pmaps)
            hret, hctx, hmaps = torchc.run(prog, vinfo,
                                           torchc.ctx_to_vec(buf), hmaps)
            assert _u64(ret) == int(jret) == _u64(hret)
            assert torchc.vec_to_bytes(ctx) == \
                np.asarray(jctx, "<u8").tobytes() == torchc.vec_to_bytes(hctx)
            for n in names:
                assert pmaps[n].numpy().tobytes() == \
                    np.asarray(jmaps[n], "<u8").tobytes() == \
                    hmaps[n].numpy().tobytes(), n
    assert probe.reads == 0, f"{probe.reads} host reads"
    assert probe.ops > 0


def test_the_probe_sees_the_host_driven_reads():
    """``item()`` and ``bool()`` reach the counted op, so its 0 above
    means no host read; the host-driven lowering makes one per taken
    branch."""
    t = torch.tensor(3)
    with ScalarReads() as probe:
        t.item()
        bool(t > 2)
    assert probe.reads == 2
    prog = adapt_tuner.program
    vinfo = verify_with_info(prog)
    maps = {n: torchc.map_to_array(m) for n, m in
            samples.make_maps(prog, np.random.default_rng(3)).items()}
    buf = samples.make_ctx(prog, np.random.default_rng(4))
    with ScalarReads() as host:
        torchc.run(prog, vinfo, torchc.ctx_to_vec(buf), maps)
    fn, _ = torchc.compile_predicated(prog, vinfo)
    with ScalarReads() as pred:
        fn(torchc.ctx_to_vec(buf), maps)
    assert host.reads > 0
    assert pred.reads == 0


def test_inputs_are_not_written():
    prog = adapt_tuner.program
    fn, names = torchc.compile_predicated(prog)
    maps = {n: torchc.map_to_array(m) for n, m in
            samples.make_maps(prog, np.random.default_rng(5)).items()}
    ctx = torchc.ctx_to_vec(make_ctx("tuner", comm_id=3, msg_size=MiB).buf)
    before = (ctx.clone(), {n: t.clone() for n, t in maps.items()})
    _, ctx_out, maps_out = fn(ctx, maps)
    assert torch.equal(ctx, before[0])
    for n in names:
        assert torch.equal(maps[n], before[1][n])
    assert not torch.equal(maps_out["adapt_map"], maps["adapt_map"])


# ---------------------------------------------------------------------------
# tests/test_jaxc.py, mirrored: the host interpreter, the reference's jaxc
# ---------------------------------------------------------------------------

def _seeded_map(prog, name, seed_maps):
    from repro_torch.core.maps import MapRegistry
    d = next(d for d in prog.maps if d.name == name)
    m = MapRegistry().create(name, d.kind, key_size=d.key_size,
                             value_size=d.value_size,
                             max_entries=d.max_entries)
    for k, slots in (seed_maps or {}).get(name, {}).items():
        for si, v in enumerate(slots):
            m.update_u64(k, v, slot=si)
    return m


def _three_ways(pol, ctx_kwargs, seed_maps=None):
    """(host ctx, predicated ctx words, host ret, predicated ret), the
    reference's jaxc held equal to the predicated lowering on the way."""
    jax, enable_x64, jaxc = _jax()
    prog = pol.program
    rt = PolicyRuntime(tier="interp")
    rt.load(prog)
    for mname, entries in (seed_maps or {}).items():
        m = rt.maps.get(mname)
        for k, slots in entries.items():
            for si, v in enumerate(slots):
                m.update_u64(k, v, slot=si)
    hctx = make_ctx("tuner", **ctx_kwargs)
    hret = rt.invoke("tuner", hctx)

    fn, names = torchc.compile_predicated(prog)
    buf = make_ctx("tuner", **ctx_kwargs).buf
    maps = {n: torchc.map_to_array(_seeded_map(prog, n, seed_maps))
            for n in names}
    ret, vec, maps_out = fn(torchc.ctx_to_vec(buf), maps)
    jfn = jaxc.compile_jax(torch_ref.program(prog))[0]
    with enable_x64(True):
        jret, jvec, jmaps = jax.jit(jfn)(
            np.frombuffer(bytes(buf), "<u8"),
            {n: _seeded_map(prog, n, seed_maps).to_device() for n in names})
        assert _u64(ret) == int(jret)
        assert torchc.vec_to_bytes(vec) == np.asarray(jvec, "<u8").tobytes()
        for n in names:
            assert maps_out[n].numpy().tobytes() == \
                np.asarray(jmaps[n], "<u8").tobytes()
    return hctx, vec.numpy().view("<u8"), int(hret), _u64(ret)


@pytest.mark.parametrize("msg_size", [1 * MiB, 8 * MiB, 64 * MiB, 256 * MiB])
def test_ring_mid_v2_matches_host(msg_size):
    hctx, vec, hret, ret = _three_ways(ring_mid_v2, dict(msg_size=msg_size))
    assert hret == ret
    for i, f in enumerate(FIELDS):
        assert int(vec[i]) == hctx[f], f"field {f} differs"


def test_bad_channels_matches_host():
    hctx, vec, hret, ret = _three_ways(bad_channels, dict(msg_size=MiB))
    assert hret == ret
    assert int(vec[FIELDS.index("n_channels")]) == 1


def test_array_map_policy_matches_host():
    hctx, vec, hret, ret = _three_ways(
        size_aware, dict(msg_size=16 * 1024, comm_id=0),
        {"chan_map": {0: [12]}})
    assert hret == ret
    assert int(vec[FIELDS.index("n_channels")]) == hctx["n_channels"] == 12


def test_adaptive_policy_state_evolves_in_graph():
    """adapt_tuner three times, the map state threaded through the
    predicated calls, beside the host runtime on a parallel copy."""
    prog = adapt_tuner.program
    fn, _ = torchc.compile_predicated(prog)
    rt = PolicyRuntime(tier="interp")
    rt.load(prog)
    m = rt.maps.get("adapt_map")
    m.update_u64(5, 2_000_000, slot=0)
    m.update_u64(5, 10, slot=1)
    m.update_u64(5, 1, slot=2)
    maps = {"adapt_map": torchc.map_to_array(m)}
    for step in range(3):
        vec = torchc.ctx_to_vec(make_ctx("tuner", comm_id=5).buf)
        _, vec, maps = fn(vec, maps)
        hctx = make_ctx("tuner", comm_id=5)
        rt.invoke("tuner", hctx)
        assert int(vec[FIELDS.index("n_channels")]) == hctx["n_channels"], \
            f"step {step}"
    # contention backoff: 10 -> 8 -> 6 -> 4
    assert int(maps["adapt_map"][5, 1]) == 4
    assert maps["adapt_map"].numpy().view("<u8").tobytes() == \
        m.to_device().tobytes()


def test_hash_map_policy_runs_predicated():
    seed = {"latency_map": {5: [2_000_000, 7]}}
    hctx, vec, hret, ret = _three_ways(
        adaptive_channels, dict(msg_size=MiB, comm_id=5), seed)
    assert hret == ret
    for i, f in enumerate(FIELDS):
        assert int(vec[i]) == hctx[f], f"field {f} differs"
    assert hctx["n_channels"] == 8          # st[1] + 1 on the hit path
    hctx, vec, hret, ret = _three_ways(
        adaptive_channels, dict(msg_size=MiB, comm_id=9), seed)
    assert hret == ret
    assert int(vec[FIELDS.index("n_channels")]) == hctx["n_channels"] == 2


# ---------------------------------------------------------------------------
# C2, and a loop cut below its trip count
# ---------------------------------------------------------------------------

c2_map = port_core.map_decl("c2_map", kind="hash", key_size=8,
                            value_size=8, max_entries=100)


@port_core.policy(section="tuner", maps=[c2_map])
def c2_probe(ctx):
    st = c2_map.lookup(199)
    if st is None:
        return 7
    v = st[0] + 1
    st[0] = v
    c2_map.update(299, (v,))
    return v


def test_a_hash_chain_past_the_last_row_c2():
    """ROADMAP C2: in a 100-row table, key 99 sits at its home row 99 and
    key 199 (home 99 too) wraps to row 0.  The predicated lowering
    probes linearly, as the host map packs: it finds 199, as
    ``torchc.run`` and the interpreter do, and inserts 299 at row 1.  The
    reference's jaxc misses 199 (its probe distance wraps in u64)."""
    jax, enable_x64, jaxc = _jax()
    prog = c2_probe.program
    vinfo = verify_with_info(prog)

    def fresh():
        m = _seeded_map(prog, "c2_map", {"c2_map": {99: [11], 199: [40]}})
        return m, torchc.map_to_array(m)

    m, arr = fresh()
    assert int(arr[0, 1]) == 199 and int(arr[99, 1]) == 99
    buf = make_ctx("tuner").buf
    vm_buf = bytearray(buf)
    want = VM(prog.insns, {"c2_map": m}).run(vm_buf)
    fn, _ = torchc.compile_predicated(prog, vinfo)
    ret, ctx, maps = fn(torchc.ctx_to_vec(buf), {"c2_map": fresh()[1]})
    hret, hctx, hmaps = torchc.run(prog, vinfo, torchc.ctx_to_vec(buf),
                                   {"c2_map": fresh()[1]})
    assert want == _u64(ret) == _u64(hret) == 41
    assert torch.equal(maps["c2_map"], hmaps["c2_map"])
    assert maps["c2_map"].numpy().view("<u8").tobytes() == \
        m.to_device().tobytes()
    assert int(maps["c2_map"][1, 1]) == 299
    with enable_x64(True):
        jret, _, _ = jax.jit(jaxc.compile_jax(torch_ref.program(prog))[0])(
            np.frombuffer(bytes(buf), "<u8"), {"c2_map": fresh()[0]
                                              .to_device()})
    assert int(jret) == 7                   # the reference's miss


@port_core.policy(section="tuner", maps=[])
def long_loop(ctx):
    ctx.algorithm = 3
    acc = 0
    for i in range(100):
        acc = acc + i
    ctx.n_channels = 5
    return acc


def test_a_loop_past_its_bound_returns_zero():
    """With the loop's proven bound cut to 10, no path reaches the exit:
    both lowerings return 0 and keep the writes made before the loop."""
    prog = long_loop.program
    vinfo = verify_with_info(prog)
    (h, bound), = vinfo.loop_bounds.items()
    assert bound >= 100
    buf = make_ctx("tuner").buf
    fn, _ = torchc.compile_predicated(prog, vinfo)
    ret, ctx, _ = fn(torchc.ctx_to_vec(buf), {})
    assert _u64(ret) == sum(range(100))
    vinfo.loop_bounds[h] = 10
    ret, ctx, _ = fn(torchc.ctx_to_vec(buf), {})
    hret, hctx, _ = torchc.run(prog, vinfo, torchc.ctx_to_vec(buf), {})
    assert _u64(ret) == _u64(hret) == 0
    assert torch.equal(ctx, hctx)
    assert int(ctx[FIELDS.index("algorithm")]) == 3
    assert int(ctx[FIELDS.index("n_channels")]) == 0


# ---------------------------------------------------------------------------
# the seeded soups of tests/test_torch_property_tiers.py
# ---------------------------------------------------------------------------

def _soup(prog, ctx_kw, keys, seed_state=None):
    """interp, ``torchc.run`` and the predicated lowering on one program:
    ret, ctx bytes and the decoded hash state by key, equal."""
    vinfo = verify_with_info(prog)

    def fresh():
        resolved = soups._mk_resolved(prog)
        for name, kvs in (seed_state or {}).items():
            for k, (v0, v1) in kvs.items():
                resolved[name].update_u64(k, v0, slot=0)
                resolved[name].update_u64(k, v1, slot=1)
        return resolved

    ref = fresh()
    ctx = make_ctx("tuner", **ctx_kw)
    want = VM(prog.insns, ref, subprogs=prog.subprogs).run(ctx.buf)
    want = (want, bytes(ctx.buf), soups._hash_state(ref, keys))
    fn, _ = torchc.compile_predicated(prog, vinfo)
    for run in (fn, lambda c, m: torchc.run(prog, vinfo, c, m)):
        resolved = fresh()
        buf = make_ctx("tuner", **ctx_kw).buf
        with ScalarReads() as probe:
            ret, vec, maps = run(torchc.ctx_to_vec(buf),
                                 {n: torchc.map_to_array(m)
                                  for n, m in resolved.items()})
        for n, m in resolved.items():
            torchc.array_to_map(maps[n], m)
        got = (_u64(ret), torchc.vec_to_bytes(vec),
               soups._hash_state(resolved, keys))
        assert got == want, prog.disasm()
        if run is fn:
            assert probe.reads == 0
    return want[0]


@pytest.mark.parametrize("seed", range(24))
def test_seeded_boundary_soup(seed):
    rng = random.Random(0x515ED + seed)
    prog = soups._seeded_program(rng)
    _soup(prog, soups._seeded_ctx_kwargs(rng), keys=[])


@pytest.mark.parametrize("seed", range(10))
def test_seeded_hash_soup(seed):
    prog, keys = soups._gen_hash_policy(seed)
    _soup(prog, dict(n_ranks=4 + seed, msg_size=1 << 20), keys,
          soups._hash_soup_state(seed, keys))


@pytest.mark.parametrize("seed", range(10))
def test_seeded_call_soup(seed):
    _soup(soups._gen_call_policy(seed),
          dict(msg_size=(seed + 3) << 12, n_ranks=8), keys=[])


def test_full_hash_table_e2big():
    """A capacity-2 table and three colliding keys: the third insert
    fails with E2BIG and stays absent, the resident keys update in
    place."""
    from repro_torch.core.frontend import compile_policy, map_decl
    cap = 2
    decl = map_decl("tiny_hash", kind="hash", key_size=8, value_size=16,
                    max_entries=cap)
    k0, k1, k2 = 10, 10 + cap, 10 + 2 * cap
    src = "\n".join([
        "def tiny(ctx):",
        f"    tiny_hash.update({k0}, (1, 2))",
        f"    tiny_hash.update({k1}, (3, 4))",
        f"    tiny_hash.update({k2}, (5, 6))",       # table full: E2BIG
        f"    st = tiny_hash.lookup({k0})",
        "    hit = 0",
        "    if st is not None:",
        "        st[1] = 99",
        "        hit = hit + 1",
        f"    st = tiny_hash.lookup({k2})",
        "    if st is not None:",
        "        hit = hit + 100",                   # must stay 0
        "    return hit",
    ]) + "\n"
    fn = soups._load_generated(src, "tiny", "tiny-e2big-predicated",
                               {"tiny_hash": decl})
    prog = compile_policy(fn, section="tuner", maps=[decl])
    assert _soup(prog, dict(n_ranks=2), keys=[k0, k1, k2]) == 1
