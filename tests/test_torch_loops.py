"""Bounded loops end-to-end on the port (the reference's
``tests/test_loops.py`` run on ``repro_torch``): shared CFG, verifier
bound proofs, frontend loop bytecode, VM fuel, the JIT's loop codegen,
native loop code, and the policy kernel's loops.

The differential property test generates random verified bounded-loop
programs (seeded, no hypothesis dependency) and asserts identical results
and ctx/map state across interpreter, JIT, native and the
``torch`` tier (the plain version of the policy kernel), with the
reference's own interpreter joining each comparison (``torch_ref``).
The reference's in-graph legs (jaxc, pallas, pallas32) become ``torch``
here and ``cuda``/``cuda32`` on the card (marked ``cuda``; they skip
without one).
"""

import random

import pytest
import torch

import torch_ref
from repro.core import PolicyRuntime as RefRuntime
from repro.core import make_ctx as ref_make_ctx
from repro.core.vm import VM as RefVM

from repro_torch.core import (PolicyRuntime, assemble, make_ctx, map_decl,
                              verify)
from repro_torch.core.cfg import CFG
from repro_torch.core.context import POLICY_CONTEXT
from repro_torch.core.frontend import CompileError, _MAX_UNROLL, compile_policy
from repro_torch.core.jit import compile_program
from repro_torch.core.verifier import (LOOP_FUEL_CAP, VerifierError,
                                 verify_with_info)
from repro_torch.core.vm import VM, VMError
from repro_torch.policies.loops import (LOOP_POLICIES, histogram_bucket_tuner,
                                  latency_argmin_tuner)

FIELDS = list(POLICY_CONTEXT.fields)


def _tuner(text, **kw):
    return assemble(text, section="tuner", **kw)


BOUNDED_REG = _tuner("""
    mov64  r6, 0
    mov64  r7, 0
loop:
    jge    r6, 10, done
    add64i r7, 2
    add64i r6, 1
    ja     loop
done:
    mov64  r0, r7
    exit
""")


# ---------------------------------------------------------------------------
# CFG layer
# ---------------------------------------------------------------------------

def test_cfg_detects_natural_loop():
    c = CFG(BOUNDED_REG.insns)
    assert c.has_loops
    (h, L), = c.loops.items()
    assert h == L.header
    assert L.latches and L.exit_edges
    assert all(b in L.body for b in L.latches)
    # block order is a topological order of the forward CFG
    for u, ss in enumerate(c.fwd_succs):
        assert all(s == CFG.EXIT or s > u for s in ss)


def test_cfg_loop_free_program_has_no_loops():
    from repro_torch.policies import size_aware
    c = CFG(size_aware.program.insns)
    assert not c.has_loops
    assert c.back_edges == []


# ---------------------------------------------------------------------------
# Verifier: accept / reject
# ---------------------------------------------------------------------------

def test_register_counter_loop_accepted():
    v = verify_with_info(BOUNDED_REG)
    assert list(v.loop_bounds.values()) == [10]
    assert v.max_steps > len(BOUNDED_REG.insns)


def test_slot_counter_loop_accepted():
    prog = _tuner("""
    mov64  r2, 0
    stxdw  [r10-8], r2
    mov64  r7, 0
loop:
    ldxdw  r2, [r10-8]
    jge    r2, 200, done
    add64i r7, 3
    ldxdw  r2, [r10-8]
    add64i r2, 1
    stxdw  [r10-8], r2
    ja     loop
done:
    mov64  r0, r7
    exit
    """)
    v = verify_with_info(prog)
    assert list(v.loop_bounds.values()) == [200]


def test_interval_bounded_limit_accepted():
    """The limit may be a register whose interval the verifier bounded —
    here a ctx field clamped by a branch (the ctx-field-interval form)."""
    prog = _tuner("""
    ldxdw  r8, [r1+n_ranks]
    jle    r8, 64, capped
    mov64  r8, 64
capped:
    mov64  r6, 0
    mov64  r7, 0
loop:
    jge    r6, r8, done
    add64i r7, 1
    add64i r6, 1
    ja     loop
done:
    mov64  r0, r7
    exit
    """)
    v = verify_with_info(prog)
    assert list(v.loop_bounds.values()) == [64]


def test_unclamped_ctx_limit_rejected():
    prog = _tuner("""
    ldxdw  r8, [r1+n_ranks]
    mov64  r6, 0
loop:
    jge    r6, r8, done
    add64i r6, 1
    ja     loop
done:
    mov64  r0, 0
    exit
    """)
    with pytest.raises(VerifierError, match="no finite verified upper"):
        verify(prog)


def test_unbounded_loop_rejected_with_actionable_message():
    """Golden message: names the back edge, the loop, the reason, and the
    supported form."""
    prog = _tuner("""
    mov64  r6, 0
loop:
    add64i r6, 1
    ja     loop
""")
    with pytest.raises(VerifierError) as ei:
        verify(prog)
    msg = str(ei.value)
    assert "back-edge at insn" in msg
    assert "cannot prove a bounded trip count" in msg
    assert "unbounded loops are rejected" in msg


def test_jeq_exit_rejected_with_reason():
    prog = _tuner("""
    mov64  r6, 0
loop:
    add64i r6, 1
    jeq    r6, 1000, done
    ja     loop
done:
    mov64  r0, 0
    exit
    """)
    with pytest.raises(VerifierError) as ei:
        verify(prog)
    msg = str(ei.value)
    assert "back-edge at insn" in msg
    assert "jeq" in msg


def test_non_advancing_counter_rejected():
    prog = _tuner("""
    mov64  r6, 0
    mov64  r7, 0
loop:
    jge    r6, 10, done
    add64i r7, 1
    ja     loop
done:
    mov64  r0, r7
    exit
    """)
    with pytest.raises(VerifierError, match="never advanced"):
        verify(prog)


def test_conditional_increment_rejected():
    """`if cond: i += 1` cannot prove progress on every path."""
    prog = _tuner("""
    mov64  r6, 0
    mov64  r7, 0
loop:
    jge    r6, 10, done
    jgt    r7, 100, skip
    add64i r6, 1
skip:
    add64i r7, 1
    ja     loop
done:
    mov64  r0, r7
    exit
    """)
    with pytest.raises(VerifierError, match="every path"):
        verify(prog)


def test_counter_overwrite_rejected():
    prog = _tuner("""
    mov64  r6, 0
loop:
    jge    r6, 10, done
    add64i r6, 1
    mov64i r6, 0
    ja     loop
done:
    mov64  r0, 0
    exit
    """)
    with pytest.raises(VerifierError, match="modified at insn"):
        verify(prog)


def test_fuel_cap_rejected():
    prog = _tuner(f"""
    mov64  r6, 0
loop:
    jge    r6, {LOOP_FUEL_CAP * 2}, done
    add64i r6, 1
    ja     loop
done:
    mov64  r0, 0
    exit
    """)
    with pytest.raises(VerifierError, match="fuel cap"):
        verify(prog)


def test_loop_body_still_memory_checked():
    """Widened loop state must not weaken memory safety: an OOB stack
    write inside a bounded loop still rejects."""
    prog = _tuner("""
    mov64  r6, 0
loop:
    jge    r6, 10, done
    stxdw  [r10-520], r6
    add64i r6, 1
    ja     loop
done:
    mov64  r0, 0
    exit
    """)
    with pytest.raises(VerifierError, match="stack access out of bounds"):
        verify(prog)


def test_unsafe_suite_unbounded_loop_still_golden():
    from repro_torch.policies.unsafe import UNSAFE_PROGRAMS
    prog, fragment = UNSAFE_PROGRAMS["unbounded_loop"]
    with pytest.raises(VerifierError, match=fragment):
        verify(prog)


def test_forward_multiway_merge_keeps_precise_join():
    """Widening must not fire at ordinary forward merge points: a 5-armed
    divisor that is nonzero on every arm stays provably nonzero."""
    prog = _tuner("""
    ldxdw  r3, [r1+msg_size]
    mov64  r2, 5
    jgt    r3, 400, m
    mov64  r2, 4
    jgt    r3, 300, m
    mov64  r2, 3
    jgt    r3, 200, m
    mov64  r2, 2
    jgt    r3, 100, m
    mov64  r2, 1
m:
    mov64  r0, 1000
    div64  r0, r2
    exit
    """)
    verify(prog)  # must not raise "contains 0"


def test_dead_loop_with_register_limit_verifies_cleanly():
    """A fully unreachable loop is vacuously bounded (its back edge is
    dead code); crucially the register-limit proof path must not escape
    with a raw KeyError for pcs the fixpoint never reached."""
    prog = _tuner("""
    mov64  r0, 0
    exit
loop:
    jge    r6, r7, done
    add64i r6, 1
    ja     loop
done:
    exit
    """)
    v = verify_with_info(prog)
    assert list(v.loop_bounds.values()) == [0]


@pytest.mark.slow
def test_interpreter_fuel_covers_large_verified_loops():
    """The runtime must never clamp fuel below the verifier's proven step
    bound: a verified 65535-iteration loop runs on the interpreter tier."""
    def big(ctx):
        acc = 0
        for i in range(65535):
            acc = acc + i
        return acc % 1000003

    prog = compile_policy(big, section="tuner")
    v = verify_with_info(prog)
    assert v.max_steps > 250_000  # the shape that exposed the old clamp
    rt = PolicyRuntime(use_interpreter=True)
    lp = rt.load(prog)
    assert lp.fn(make_ctx("tuner").buf) == sum(range(65535)) % 1000003


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------

def _unrolled_size_probe():
    def probe(ctx):
        acc = 0
        for i in range(200):
            acc = acc + i
        return acc
    return compile_policy(probe, section="tuner")


def test_frontend_emits_real_loop_above_unroll_limit():
    prog = _unrolled_size_probe()
    # an unrolled 200-iteration loop would exceed 400 insns; the real
    # loop stays tiny and carries exactly one back edge
    assert len(prog.insns) < 40
    v = verify_with_info(prog)
    assert list(v.loop_bounds.values()) == [200]
    ret = VM(prog.insns, {}).run(make_ctx("tuner").buf)
    assert ret == sum(range(200))


def test_frontend_still_unrolls_small_loops():
    def small(ctx):
        acc = 0
        for i in range(8):
            acc = acc + i
        return acc
    prog = compile_policy(small, section="tuner")
    assert not CFG(prog.insns).has_loops


def test_frontend_nonconstant_bound_actionable_error():
    def bad(ctx):
        total = 0
        for i in range(ctx.n_ranks):
            total = total + i
        return total
    with pytest.raises(CompileError) as ei:
        compile_policy(bad, section="tuner")
    msg = str(ei.value)
    assert "compile-time constant" in msg
    assert "ctx.n_ranks" in msg
    assert "verifier proves" in msg
    assert str(_MAX_UNROLL) in msg


def test_frontend_descending_range_actionable_error():
    def down(ctx):
        acc = 0
        for i in range(200, 0, -1):
            acc = acc + i
        return acc
    with pytest.raises(CompileError, match="descending"):
        compile_policy(down, section="tuner")


def test_loop_variable_does_not_outlive_real_loop():
    """Post-loop reads of the loop variable fail loudly (the slot holds
    the exit value, not Python's last iterate) — matching the unrolled
    path's behavior instead of silently diverging from Python."""
    def leaky(ctx):
        acc = 0
        for i in range(96):
            acc = acc + i
        return acc + i
    with pytest.raises(CompileError, match="unknown name 'i'"):
        compile_policy(leaky, section="tuner")


def test_same_name_nested_loops_rejected():
    def shadow(ctx):
        acc = 0
        for i in range(96):
            for i in range(70):
                acc = acc + 1
        return acc
    with pytest.raises(CompileError, match="distinct names"):
        compile_policy(shadow, section="tuner")


def test_sequential_loops_reuse_counter_slot():
    def twice(ctx):
        acc = 0
        for i in range(96):
            acc = acc + i
        for i in range(70):
            acc = acc + i
        return acc % 100003
    prog = compile_policy(twice, section="tuner")
    verify(prog)
    want = (sum(range(96)) + sum(range(70))) % 100003
    assert VM(prog.insns, {}).run(make_ctx("tuner").buf) == want


def test_readme_argmin_example_compiles_and_runs():
    """The README's bounded-loops quickstart must compile verbatim."""
    lat = map_decl("config_lat_map", kind="array", value_size=8,
                   max_entries=96, shared=True)

    def argmin_tuner(ctx):
        best = 0
        best_lat = 0xFFFFFFFFFFFFFFFF
        for i in range(96):
            st = lat.lookup(i)
            if st is not None:
                if st[0] > 0:
                    if st[0] < best_lat:
                        best_lat = st[0]
                        best = i
        ctx.n_channels = min(best + 1, max(ctx.max_channels, 1))
        return 0

    prog = compile_policy(argmin_tuner, section="tuner", maps=[lat])
    rt = PolicyRuntime(tier="jit")
    rt.load(prog)
    rt.maps.get("config_lat_map").update_u64(5, 42, slot=0)
    ctx = make_ctx("tuner", max_channels=32)
    rt.invoke("tuner", ctx)
    assert ctx["n_channels"] == 6


def test_loop_variable_shadowing_local_rejected_in_both_paths():
    """A loop variable shadowing an existing local is rejected loudly —
    in the unrolled path it would silently read the stale local (scalars
    shadow consts), in the real-loop path it would clobber the slot."""
    def small(ctx):
        i = 5
        acc = 0
        for i in range(10):
            acc = acc + 1
        return acc + i

    def big(ctx):
        i = 5
        acc = 0
        for i in range(100):
            acc = acc + 1
        return acc + i

    for fn in (small, big):
        with pytest.raises(CompileError, match="shadows an existing local"):
            compile_policy(fn, section="tuner")


def test_const_shadowing_loop_var_consistent_across_unroll_boundary():
    """Looping over a name that was a module const unbinds it afterward
    in BOTH compilation strategies — post-loop reads fail loudly instead
    of flipping between an error (unrolled) and the stale const (real)."""
    def shadows_small(ctx):
        acc = 0
        for K7 in range(10):
            acc = acc + K7
        return acc + K7

    def shadows_big(ctx):
        acc = 0
        for K7 in range(100):
            acc = acc + K7
        return acc + K7

    for fn in (shadows_small, shadows_big):
        with pytest.raises(CompileError, match="unknown name 'K7'"):
            compile_policy(fn, section="tuner", extra_consts={"K7": 7})


def test_nonzero_start_range_bound_uses_trip_count():
    """range(60000, 70000) has 10k trips — the prover must recover the
    constant init so the bound is the real trip count, not limit/step
    (which would spuriously trip the 65536 fuel cap)."""
    def offset_scan(ctx):
        acc = 0
        for i in range(60000, 70000):
            acc = acc + i
        return acc % 1000003

    prog = compile_policy(offset_scan, section="tuner")
    v = verify_with_info(prog)
    assert list(v.loop_bounds.values()) == [10000]
    ret = VM(prog.insns, {}).run(make_ctx("tuner").buf)
    assert ret == sum(range(60000, 70000)) % 1000003


def test_frontend_fuel_cap_error():
    def huge(ctx):
        acc = 0
        for i in range(1 << 20):
            acc = acc + 1
        return acc
    with pytest.raises(CompileError, match="fuel cap"):
        compile_policy(huge, section="tuner")


def test_loop_with_dead_latch_verifies():
    """A body that returns on every path leaves the latch unreachable;
    the dead latch must still close its natural loop (not read as
    irreducible control flow)."""
    def always_returns(ctx):
        for i in range(100):
            return 2
        return 0

    prog = compile_policy(always_returns, section="tuner")
    v = verify_with_info(prog)
    # the back edge is dead code, so the loop is vacuously bounded
    assert list(v.loop_bounds.values()) == [0]
    assert VM(prog.insns, {}).run(make_ctx("tuner").buf) == 2
    assert compile_program(prog, {}, info=v)(make_ctx("tuner").buf) == 2


def test_single_block_do_while_accepted():
    """Post-increment exit test in the same block as the increment — the
    canonical do-while — matches the documented provable form."""
    prog = _tuner("""
    mov64  r7, 0
    mov64  r8, 0
inner:
    add64i r8, 3
    add64i r7, 2
    jlt    r7, 9, inner
    mov64  r0, r8
    exit
    """)
    v = verify_with_info(prog)
    (bound,) = v.loop_bounds.values()
    assert bound >= 5  # >= the real 5 trips (ceil(9/2) is conservative)
    assert VM(prog.insns, {}).run(make_ctx("tuner").buf) == 15
    assert compile_program(prog, {}, info=v)(make_ctx("tuner").buf) == 15


# ---------------------------------------------------------------------------
# VM fuel
# ---------------------------------------------------------------------------

def test_vm_fuel_trips_on_budget():
    with pytest.raises(VMError, match="instruction budget exceeded"):
        VM(BOUNDED_REG.insns, {}, fuel=5).run(make_ctx("tuner").buf)


def test_vm_fuel_default_suffices():
    assert VM(BOUNDED_REG.insns, {}).run(make_ctx("tuner").buf) == 20


# ---------------------------------------------------------------------------
# JIT codegen
# ---------------------------------------------------------------------------

def test_v2_emits_native_while_loop():
    prog = _unrolled_size_probe()
    fn = compile_program(prog, {})
    assert fn.__bpf_structured__
    assert "while True:" in fn.__bpf_source__
    assert fn(make_ctx("tuner").buf) == sum(range(200))


def test_v2_dispatcher_fallback_on_multi_exit_loop():
    """Two distinct exit targets defeat structured reconstruction; the
    dispatcher fallback must still execute the loop correctly."""
    prog = _tuner("""
    mov64  r6, 0
    mov64  r7, 0
loop:
    jge    r6, 10, out1
    jeq    r7, 7, out2
    add64i r7, 1
    add64i r6, 1
    ja     loop
out2:
    mov64  r0, 99
    exit
out1:
    mov64  r0, r7
    exit
    """)
    want = VM(prog.insns, {}).run(make_ctx("tuner").buf)
    fn = compile_program(prog, {})
    assert not fn.__bpf_structured__
    assert "while True:" in fn.__bpf_source__  # dispatcher, not guard chain
    assert fn(make_ctx("tuner").buf) == want == 99


# ---------------------------------------------------------------------------
# Differential: the shipped loop policies across all four tiers
# ---------------------------------------------------------------------------

def _seed_maps(rt):
    for name in rt.maps.names():
        m = rt.maps.get(name)
        for k in range(0, m.max_entries, 3):
            m.update_u64(k, 100 + 17 * k, slot=0)


@pytest.fixture
def card():
    """The card legs (``cuda``, ``cuda32``) need a CUDA device and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import have_nvcc
    if not have_nvcc():
        pytest.skip("needs nvcc")


def _runtime_leg(rt, prog, ctx_kw):
    """Load ``prog`` on ``rt``, seed its maps, run one call: (ret, ctx,
    every map's slot-0 words)."""
    fn = rt.load(prog).fn
    _seed_maps(rt)
    ctx = (ref_make_ctx if isinstance(rt, RefRuntime) else make_ctx)(
        "tuner", **ctx_kw)
    ret = fn(ctx.buf)
    rt.flush_bridges()
    state = {d.name: [rt.maps.get(d.name).lookup_u64(k)
                      for k in range(rt.maps.get(d.name).max_entries)]
             for d in prog.maps}
    return ret, bytes(ctx.buf), state


@pytest.mark.parametrize("pol", LOOP_POLICIES,
                         ids=lambda p: p.program.name)
def test_loop_policy_identical_across_tiers(pol):
    prog = pol.program
    ctx_kw = dict(msg_size=8 << 20, comm_id=2, n_ranks=8, max_channels=32)
    results = {}
    for tier in ("interp", "jit", "torch"):
        results[tier] = _runtime_leg(PolicyRuntime(tier=tier), prog, ctx_kw)
    results["reference interp"] = _runtime_leg(
        RefRuntime(use_interpreter=True), torch_ref.program(prog), ctx_kw)

    from repro_torch.core.cc import have_cc
    if have_cc():
        results["native"] = _runtime_leg(PolicyRuntime(tier="native"), prog,
                                         ctx_kw)
    for tier, got in results.items():
        assert got == results["interp"], tier


@pytest.mark.cuda
@pytest.mark.parametrize("pol", LOOP_POLICIES,
                         ids=lambda p: p.program.name)
def test_loop_policy_identical_on_the_card(pol, card):
    prog = pol.program
    ctx_kw = dict(msg_size=8 << 20, comm_id=2, n_ranks=8, max_channels=32)
    want = _runtime_leg(PolicyRuntime(tier="interp"), prog, ctx_kw)
    for tier in ("cuda", "cuda32"):
        assert _runtime_leg(PolicyRuntime(tier=tier), prog, ctx_kw) == want


# ---------------------------------------------------------------------------
# Differential property test: random bounded-loop programs
# ---------------------------------------------------------------------------

_BODY_OPS = [
    ("add64i", "imm"), ("xor64i", "imm"), ("or64i", "imm"),
    ("and64i", "imm"), ("lsh64i", "shift"), ("rsh64i", "shift"),
    ("mul64i", "imm"), ("add64", "reg"), ("xor64", "reg"), ("sub64", "reg"),
]

# constant pool biased toward the 32-bit boundary — the register churn
# then exercises carry/borrow/cross-lane behavior in the pallas32 pair
# lowering on every loop iteration (negatives = high-half-set encodings)
_BOUNDARY = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 1,
             2**63, 2**64 - 1, -1, -(2**31)]


def _bconst(rng: random.Random, lo: int = 1, hi: int = 1 << 20) -> int:
    return rng.choice(_BOUNDARY) if rng.random() < 0.5 \
        else rng.randint(lo, hi)


def _random_loop_program(rng: random.Random):
    """A random but always-verifiable bounded loop: r6 counts to a random
    limit; r7/r8 churn through random ALU ops (over boundary-biased
    constants) with a random conditional region inside the body."""
    limit = rng.randint(65, 300)
    step = rng.choice([1, 1, 1, 2, 3])
    lines = [
        "    mov64  r6, 0",
        f"    lddw   r7, {_bconst(rng, 0, 1 << 30)}",
        f"    lddw   r8, {_bconst(rng, 1, 1 << 30)}",
        "loop:",
        f"    jge    r6, {limit}, done",
    ]
    n_ops = rng.randint(1, 6)
    for _ in range(n_ops):
        op, kind = rng.choice(_BODY_OPS)
        dst = rng.choice(["r7", "r8"])
        if kind == "imm":
            lines.append(f"    {op} {dst}, {_bconst(rng)}")
        elif kind == "shift":
            lines.append(f"    {op} {dst}, "
                         f"{rng.choice([1, 5, 13, 31, 32, 33, 63])}")
        else:
            src = "r8" if dst == "r7" else "r7"
            lines.append(f"    {op} {dst}, {src}")
    if rng.random() < 0.7:  # conditional region in the body
        lines.append(f"    jgt    r7, {_bconst(rng, 0, 1 << 32)}, skip")
        lines.append(f"    add64i r8, {rng.randint(1, 999)}")
        lines.append("skip:")
    lines += [
        f"    add64i r6, {step}",
        "    ja     loop",
        "done:",
        "    xor64  r7, r8",
        "    mov64  r0, r7",
        "    exit",
    ]
    return _tuner("\n".join(lines))


@pytest.mark.parametrize("seed", range(20))
def test_random_bounded_loops_identical_across_tiers(seed):
    rng = random.Random(0xBEEF + seed)
    prog = _random_loop_program(rng)
    vinfo = verify_with_info(prog)  # must verify
    assert vinfo.loop_bounds
    buf = make_ctx("tuner", msg_size=1 << 20).buf
    b0 = bytearray(buf)
    want = VM(prog.insns, {}).run(b0)
    f2 = compile_program(prog, {}, info=vinfo)
    assert f2(bytearray(buf)) == want
    assert torch_ref.interp(prog, buf) == (want, bytes(b0), {})
    from repro_torch.core.cc import compile_native, have_cc
    if have_cc():
        bn = bytearray(buf)
        assert compile_native(prog, {}, vinfo)(bn) == want
        assert bytes(bn) == bytes(b0)


def _bridge_loop(seed, tiers):
    rng = random.Random(0xFACE + seed)
    prog = _random_loop_program(rng)
    buf = make_ctx("tuner", msg_size=1 << 20).buf
    b0 = bytearray(buf)
    want = VM(prog.insns, {}).run(b0)
    assert torch_ref.interp(prog, buf)[:2] == (want, bytes(b0))
    from repro_torch.core.bridge import compile_host
    for tier in tiers:
        b = bytearray(buf)
        assert compile_host(prog, {}, tier=tier)(b) == want, tier
        assert bytes(b) == bytes(b0), tier


@pytest.mark.parametrize("seed", range(6))
def test_random_bounded_loops_match_torch(seed):
    """interp == torch (the policy kernel's plain version) == the
    reference's interp on random loop programs (the reference's jaxc
    leg)."""
    _bridge_loop(seed, ("torch",))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_random_bounded_loops_match_the_card(seed, card):
    _bridge_loop(seed, ("cuda", "cuda32"))


_rand_map = map_decl("rand_loop_map", kind="array", value_size=8,
                     max_entries=8)


def _random_map_loop_program(rng: random.Random):
    """A seeded bounded loop that also accumulates into an array-map cell
    through the looked-up value pointer, so the differential covers map
    state — not just the return value — on every tier."""
    limit = rng.randint(65, 200)
    step = rng.choice([1, 1, 2, 3])
    key = rng.randint(0, 7)
    lines = [
        f"    lddw   r7, {_bconst(rng)}",
        "    mov64  r6, 0",
        f"    stw    [r10-4], {key}",
        "    ldmap  r1, rand_loop_map",
        "    mov64  r2, r10",
        "    add64i r2, -4",
        "    call   map_lookup_elem",
        "    jeqi   r0, 0, out",
        "    mov64  r9, r0",
        "loop:",
        f"    jge    r6, {limit}, out",
    ]
    for _ in range(rng.randint(1, 3)):
        op, kind = rng.choice(_BODY_OPS)
        if kind == "imm":
            lines.append(f"    {op} r7, {_bconst(rng, 1, 1 << 16)}")
        elif kind == "shift":
            lines.append(f"    {op} r7, "
                         f"{rng.choice([1, 7, 13, 31, 32, 33, 63])}")
        else:
            lines.append(f"    {op} r7, r6")
    lines += [
        "    ldxdw  r8, [r9+0]",
        "    add64  r8, r7",
        "    stxdw  [r9+0], r8",
        f"    add64i r6, {step}",
        "    ja     loop",
        "out:",
        "    mov64  r0, r7",
        "    exit",
    ]
    return _tuner("\n".join(lines), maps=(_rand_map,))


def _seeded_loop_map(rng):
    from repro_torch.core.maps import MapRegistry
    reg = MapRegistry()
    m = reg.create("rand_loop_map", "array", value_size=8, max_entries=8)
    for k in range(8):
        m.update_u64(k, _bconst(rng, 0, 1 << 30) % 2**64)
    return m


def _bridge_map_loop(seed, tier):
    """interp == ``tier`` == the reference's interp on a seeded map-loop
    program, map state compared after the run."""
    from repro_torch.core.bridge import compile_host

    rng = random.Random(0xD00D + seed)
    prog = _random_map_loop_program(rng)
    vinfo = verify_with_info(prog)  # must verify
    assert vinfo.loop_bounds
    buf = make_ctx("tuner", msg_size=1 << 20).buf

    m = _seeded_loop_map(rng)
    m_t = _seeded_loop_map(random.Random(0))
    m_t.from_device(m.to_device())
    ref = torch_ref.interp(prog, buf, {"rand_loop_map": m})
    want = VM(prog.insns, {"rand_loop_map": m}).run(bytearray(buf))
    want_state = [m.lookup_u64(k) for k in range(8)]
    assert ref[0] == want and ref[2] == torch_ref.images(
        {"rand_loop_map": m})

    fn = compile_host(prog, {"rand_loop_map": m_t}, vinfo, tier=tier)
    assert fn(bytearray(buf)) == want
    fn.flush()
    assert [m_t.lookup_u64(k) for k in range(8)] == want_state


@pytest.mark.parametrize("seed", range(20))
def test_random_bounded_loops_match_torch_with_maps(seed):
    """interp == torch on >= 20 seeded random loop programs, map state
    compared after each run (the reference's pallas leg, with map
    writebacks in the loop body)."""
    _bridge_map_loop(seed, "torch")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(20))
@pytest.mark.parametrize("tier", ["cuda", "cuda32"])
def test_random_bounded_loops_match_the_card_with_maps(seed, tier, card):
    """The same programs on the policy kernel, u64 and pair form (the
    reference's pallas and pallas32 legs)."""
    _bridge_map_loop(seed, tier)


@pytest.mark.parametrize("seed", range(20))
def test_random_map_loops_match_native(seed):
    """interp == native on the SAME seeded map-loop programs the pallas
    legs run: return value, ctx writeback, and map state bit-identical,
    with in-loop pointer stores landing in live map storage."""
    from repro_torch.core.cc import compile_native, have_cc
    from repro_torch.core.maps import MapRegistry
    if not have_cc():
        pytest.skip("native tier needs a C toolchain (have_cc)")

    rng = random.Random(0xD00D + seed)
    prog = _random_map_loop_program(rng)
    vinfo = verify_with_info(prog)  # must verify
    assert vinfo.loop_bounds
    buf = make_ctx("tuner", msg_size=1 << 20).buf

    def seeded_map(rng_seed):
        reg = MapRegistry()
        m = reg.create("rand_loop_map", "array", value_size=8,
                       max_entries=8)
        r = random.Random(rng_seed)
        for k in range(8):
            m.update_u64(k, _bconst(r, 0, 1 << 30) % 2**64)
        return m

    m_i = seeded_map(seed)
    b_i = bytearray(buf)
    ref = torch_ref.interp(prog, buf, {"rand_loop_map": m_i})
    want = VM(prog.insns, {"rand_loop_map": m_i}).run(b_i)
    want_state = [m_i.lookup_u64(k) for k in range(8)]
    assert ref == (want, bytes(b_i), torch_ref.images(
        {"rand_loop_map": m_i}))

    m_n = seeded_map(seed)
    fn = compile_native(prog, {"rand_loop_map": m_n}, vinfo)
    b_n = bytearray(buf)
    assert fn(b_n) == want
    assert bytes(b_n) == bytes(b_i)
    assert [m_n.lookup_u64(k) for k in range(8)] == want_state


# ---------------------------------------------------------------------------
# Random REAL loops (above the unroll limit) with bpf-to-bpf calls and
# hash-map read-modify-writes in the body — the loop x call x hash
# interaction every tier must agree on (verifier proves the bound AND
# the per-call stack accounting; in-graph tiers inline the call and
# lower the hash RMW inside fori_loop)
# ---------------------------------------------------------------------------

import linecache  # noqa: E402

from repro_torch.core.maps import MapRegistry  # noqa: E402


def _load_generated_loop(src, name, tag, extra_globals):
    filename = f"<gen-{tag}>"
    linecache.cache[filename] = (len(src), None, src.splitlines(True),
                                 filename)
    ns = dict(extra_globals)
    exec(compile(src, filename, "exec"), ns)
    return ns[name]


def _random_loop_call_hash_policy(seed):
    """A random restricted-Python policy whose `for` loop exceeds
    _MAX_UNROLL (so the frontend emits a REAL back-edge, not an unroll)
    and whose body both calls a subroutine and hash-RMWs a table smaller
    than the key range (collisions + possible full-table E2BIG)."""
    rng = random.Random(0x10C0 + seed)
    n = rng.randint(_MAX_UNROLL + 1, _MAX_UNROLL + 24)
    cap = rng.choice([3, 4])
    decl = map_decl("loop_hash", kind="hash", key_size=8, value_size=16,
                    max_entries=cap)
    mul = rng.randrange(3, 1 << 12) | 1
    sh = rng.choice([1, 3, 5])
    nkeys = rng.randint(2, cap + 1)    # may exceed cap -> E2BIG in-loop
    src = "\n".join([
        "def loop_call(ctx):",
        "    def mix(a, b):",
        f"        a = (a * {mul} + b) & 0xffffffffffffffff",
        f"        a = a ^ (a >> {sh})",
        "        return a",
        "    acc = ctx.msg_size & 0xffffff",
        f"    for i in range({n}):",
        "        t = mix(acc, i)",
        "        acc = t",
        f"        k = i % {nkeys}",
        "        st = loop_hash.lookup(k)",
        "        if st is None:",
        "            loop_hash.update(k, (1, acc))",
        "        else:",
        "            st[0] = st[0] + 1",
        "            st[1] = st[1] ^ acc",
        "    return acc & 0xffffffff",
    ]) + "\n"
    fn = _load_generated_loop(src, "loop_call", f"loopcall-{seed}",
                              {"loop_hash": decl})
    return compile_policy(fn, section="tuner", maps=[decl]), nkeys


def _real_loop_all_tiers(seed, card):
    from repro_torch.core.bridge import compile_host
    from repro_torch.core.cc import compile_native, have_cc

    prog, nkeys = _random_loop_call_hash_policy(seed)
    vinfo = verify_with_info(prog)
    assert vinfo.loop_bounds          # really a loop, not an unroll
    assert prog.subprogs              # really a call, not a fold
    ctx_kw = dict(msg_size=(seed + 7) << 13, n_ranks=8)

    def mk_maps():
        reg = MapRegistry()
        return {d.name: reg.create(d.name, d.kind, key_size=d.key_size,
                                   value_size=d.value_size,
                                   max_entries=d.max_entries)
                for d in prog.maps}

    def state(resolved):
        return {nm: [(m.lookup_u64(k, 0), m.lookup_u64(k, 1))
                     for k in range(nkeys + 1)]
                for nm, m in resolved.items()}

    maps_i = mk_maps()
    ctx = make_ctx("tuner", **ctx_kw)
    want_ret = VM(prog.insns, maps_i, subprogs=prog.subprogs).run(ctx.buf)
    want = (want_ret, bytes(ctx.buf), state(maps_i))

    ref_prog, ref_maps = torch_ref.program(prog), torch_ref.maps(mk_maps())
    ctx_r = make_ctx("tuner", **ctx_kw)
    ret = RefVM(ref_prog.insns, ref_maps,
                subprogs=ref_prog.subprogs).run(ctx_r.buf)
    assert (ret, bytes(ctx_r.buf), state(ref_maps)) == want

    if card:
        builders = {t: lambda p, m, v, t=t: compile_host(p, m, v, tier=t)
                    for t in ("cuda", "cuda32")}
    else:
        builders = {
            "jit": lambda p, m, v: compile_program(p, m, info=v),
            "torch": lambda p, m, v: compile_host(p, m, v, tier="torch"),
        }
        if have_cc():
            builders["native"] = compile_native
    for tier, build in builders.items():
        maps_t = mk_maps()
        fn = build(prog, maps_t, vinfo)
        ctx_t = make_ctx("tuner", **ctx_kw)
        ret = fn(ctx_t.buf)
        if hasattr(fn, "flush"):
            fn.flush()
        got = (ret, bytes(ctx_t.buf), state(maps_t))
        assert got == want, (seed, tier, got[0], want[0])


@pytest.mark.parametrize("seed", range(6))
def test_random_real_loop_with_call_and_hash_all_tiers(seed):
    """interp == jit == native == torch == the reference's interp on
    seeded real-loop programs calling a subroutine and hash-RMWing per
    iteration: return value, ctx writeback, and decoded hash state
    (both value slots, present and absent keys) bit-identical."""
    _real_loop_all_tiers(seed, card=False)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_random_real_loop_with_call_and_hash_on_the_card(seed, card):
    """The same programs on the policy kernel, u64 and pair form."""
    _real_loop_all_tiers(seed, card=True)


# ---------------------------------------------------------------------------
# Signed-compare / wraparound trip bounds (interval-domain bugfix)
# ---------------------------------------------------------------------------

WRAP_INIT_DO_WHILE = """
    lddw   r6, -1
loop:
    add64i r6, 1
    jgei   r6, 100, done
    ja     loop
done:
    mov64  r0, r6
    exit
"""


def test_negative_init_do_while_gets_real_trip_bound():
    """A counter starting at -1 (u64 2**64-1) wraps to 0 on the first
    post-increment test and then really runs 100 more passes.  The
    pre-fix signed span reasoning proved trip bound 0 — the reference's
    jaxc would run ONE fori iteration while the VM/JIT ran 101, silently
    diverging."""
    prog = _tuner(WRAP_INIT_DO_WHILE)
    vinfo = verify_with_info(prog)
    assert vinfo.loop_bounds == {1: 100}
    want = VM(prog.insns, {}, fuel=4 * vinfo.max_steps).run(
        make_ctx("tuner").buf)
    assert want == 100                      # the loop genuinely ran


def test_negative_init_do_while_identical_across_tiers():
    from repro_torch.core.bridge import compile_host
    prog = _tuner(WRAP_INIT_DO_WHILE)
    buf = make_ctx("tuner").buf
    want = VM(prog.insns, {}).run(bytearray(buf))
    assert torch_ref.interp(prog, buf)[0] == want
    f2 = compile_program(prog, {})
    assert f2(bytearray(buf)) == want
    assert compile_host(prog, {}, tier="torch")(bytearray(buf)) == want, \
        "torch ran a different trip count than the interpreter"


def test_limit_near_u64_max_rejected_as_wraparound():
    """A limit within one iteration's advance of 2**64 (a negative-signed
    constant) could carry a passing counter across the wrap and back
    under the limit — the bound formula would undercount, so reject."""
    with pytest.raises(VerifierError) as ei:
        verify(_tuner("""
            lddw   r6, -2000
        loop:
            jgei   r6, -1000, done
            add64i r6, 3000
            ja     loop
        done:
            mov64  r0, 0
            exit
        """))
    msg = str(ei.value)
    assert "wrap around 2**64" in msg
    assert "negative-signed" in msg


@pytest.mark.parametrize("op", ["jslti", "jsgti"])
def test_signed_exit_test_rejected_with_signed_message(op):
    """Signed loop exits reject with a message that names the signed/
    unsigned hazard and the unsigned alternative, not a generic one."""
    body = f"""
        mov64  r6, 0
    loop:
        add64i r6, 1
        {op}  r6, 100, {'loop' if op == 'jslti' else 'done'}
    """ + ("""
        mov64  r0, 0
        exit
    """ if op == "jslti" else """
        ja     loop
    done:
        mov64  r0, 0
        exit
    """)
    with pytest.raises(VerifierError) as ei:
        verify(_tuner(body))
    msg = str(ei.value)
    assert "signed" in msg
    assert "large-unsigned (negative-signed)" in msg
    assert "unsigned jlt/jle" in msg


def test_nonstrict_exit_landing_exactly_on_wrap_rejected():
    """`jle` keeps the counter alive AT the limit, so a step that carries
    it from exactly `limit` to exactly 2**64 wraps to 0 <= limit and the
    loop is infinite — yet the span formula proves a small finite bound
    (65536 here, inside the fuel cap).  The wraparound guard must use
    limit (not limit-1) as the largest passing value for non-strict
    tests."""
    step = 1 << 48
    with pytest.raises(VerifierError, match="wrap around 2\\*\\*64"):
        verify(_tuner(f"""
            mov64  r6, 0
        loop:
            jlei   r6, {-step}, body
            ja     done
        body:
            add64i r6, {step}
            ja     loop
        done:
            mov64  r0, 0
            exit
        """))


def test_normal_loops_keep_exact_bounds_after_wrap_guard():
    """Regression guard: the wraparound checks must not disturb ordinary
    ascending loops' exact bounds."""
    v = verify_with_info(_tuner("""
        mov64  r6, 5
    loop:
        jge    r6, 105, done
        add64i r6, 1
        ja     loop
    done:
        mov64  r0, r6
        exit
    """))
    assert v.loop_bounds == {1: 100}


# ---------------------------------------------------------------------------
# Runtime integration
# ---------------------------------------------------------------------------

def test_loop_policy_attaches_and_decides():
    rt = PolicyRuntime(tier="jit")
    rt.load(latency_argmin_tuner.program)
    m = rt.maps.get("config_lat_map")
    m.update_u64(11, 50, slot=0)   # config 11 is fastest
    m.update_u64(3, 900, slot=0)
    ctx = make_ctx("tuner", msg_size=8 << 20, max_channels=32)
    rt.invoke("tuner", ctx)
    assert ctx["n_channels"] == 12  # argmin config + 1


def test_histogram_tuner_adapts_to_traffic_class():
    rt = PolicyRuntime(tier="jit")
    rt.load(histogram_bucket_tuner.program)
    small = make_ctx("tuner", msg_size=1 << 10, max_channels=32)
    for _ in range(5):
        rt.invoke("tuner", small)
    assert small["algorithm"] != 1  # tree for latency-bound traffic
    big = make_ctx("tuner", msg_size=64 << 20, max_channels=32)
    for _ in range(9):
        rt.invoke("tuner", big)
    assert big["algorithm"] == 1    # ring once big transfers dominate
