"""Property/fuzz tests: ALL execution tiers of the port agree on verified
programs (the reference's ``tests/test_property_tiers.py`` run on
``repro_torch``, the reference's own interpreter joining every
comparison through ``torch_ref``).

Two harnesses:

* a hypothesis harness generating random *verifiable* straight-line
  programs over the tuner ctx (ALU soup + ctx loads + output stores +
  branches), asserting interpreter == host JIT on random ctx inputs.
  The verifier itself is property-tested by construction: anything it
  accepts must run without a VM fault.
* a seeded harness (no hypothesis dependency — always collected) running
  every generated program through the FULL tier ladder:
  interp == jit == native == torch == the reference's interp
  (return value AND ctx writeback), with the constant pool deliberately
  biased toward 32-bit-boundary values (0, 2**31-1, 2**32-1, 2**32,
  2**64-1, negative-signed encodings).  The reference's in-graph legs
  (jaxc, pallas, pallas32) become the port's ``torch`` tier here and
  ``cuda``/``cuda32`` on the card (marked ``cuda``; they skip without
  one): the pair form carries the same boundary values.
"""

import random

import pytest
import torch

import torch_ref
from repro.core.vm import VM as RefVM
from repro_torch.core import VerifierError, make_ctx
from repro_torch.core.context import POLICY_CONTEXT
from repro_torch.core.isa import Insn
from repro_torch.core.program import Program
from repro_torch.core.verifier import verify
from repro_torch.core.vm import VM, VMError
from repro_torch.core.jit import compile_program

IN_FIELDS = [f for f in POLICY_CONTEXT.fields.values() if not f.writable]
OUT_FIELDS = [f for f in POLICY_CONTEXT.fields.values() if f.writable]

# registers we use for scratch (avoid r0/r1/r10)
REGS = [2, 3, 4, 5, 6, 7]

# 32-bit-boundary-heavy pool (negatives = high-half-set u64 encodings)
BOUNDARY = [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 1,
            2**63 - 1, 2**63, 2**64 - 1, -1, -(2**31), -(2**32)]


# ---------------------------------------------------------------------------
# Seeded six-tier differential harness (no hypothesis dependency)
# ---------------------------------------------------------------------------

_S_ALU = ["add64", "sub64", "mul64", "and64", "or64", "xor64",
          "add32", "sub32", "mul32", "xor32", "or32", "and32"]
_S_ALUI = ["add64i", "sub64i", "mul64i", "and64i", "or64i", "xor64i",
           "add32i", "xor32i"]
_S_SHIFTI = ["lsh64i", "rsh64i", "arsh64i", "lsh32i", "rsh32i", "arsh32i"]
_S_JUMPS = ["jeqi", "jnei", "jgti", "jgei", "jlti", "jlei", "jsgti",
            "jslti", "jsgei", "jslei", "jseti"]


def _seeded_program(rng: random.Random) -> Program:
    """Always-verifiable straight-line soup: boundary-constant inits
    (lddw), 64/32-bit ALU churn (shift amounts immediate, so the
    verifier never rejects), forward branches over small gaps, stores to
    ctx output fields."""
    insns = []
    for r in REGS:
        if rng.random() < 0.4:
            f = rng.choice(IN_FIELDS)
            insns.append(Insn("ldxdw", dst=r, src=1, off=f.offset))
        else:
            insns.append(Insn("lddw", dst=r, imm=rng.choice(BOUNDARY)))
    for _ in range(rng.randint(6, 24)):
        k = rng.random()
        if k < 0.35:
            insns.append(Insn(rng.choice(_S_ALU), dst=rng.choice(REGS),
                              src=rng.choice(REGS)))
        elif k < 0.6:
            insns.append(Insn(rng.choice(_S_ALUI), dst=rng.choice(REGS),
                              imm=rng.choice(BOUNDARY)
                              if rng.random() < 0.6
                              else rng.randint(0, 2**31 - 1)))
        elif k < 0.75:
            insns.append(Insn(rng.choice(_S_SHIFTI), dst=rng.choice(REGS),
                              imm=rng.choice([0, 1, 31, 32, 33, 63])))
        elif k < 0.9:
            # forward conditional jump over a 1-insn gap
            insns.append(Insn(rng.choice(_S_JUMPS), dst=rng.choice(REGS),
                              imm=rng.choice(BOUNDARY[:8])
                              if rng.random() < 0.5
                              else rng.randint(0, 1000), off=1))
            insns.append(Insn("mov64i", dst=rng.choice(REGS),
                              imm=rng.randint(0, 1000)))
        else:
            f = rng.choice(OUT_FIELDS)
            insns.append(Insn("stxdw", dst=1, src=rng.choice(REGS),
                              off=f.offset))
    insns.append(Insn("mov64", dst=0, src=rng.choice(REGS)))
    insns.append(Insn("exit"))
    return Program("fuzz6", "tuner", insns)


def _seeded_ctx_kwargs(rng: random.Random) -> dict:
    return {f.name: (rng.choice([v for v in BOUNDARY if v >= 0])
                     if rng.random() < 0.4 else rng.randint(0, 2**48))
            for f in IN_FIELDS}


@pytest.fixture
def card():
    """The card legs (``cuda``, ``cuda32``) need a CUDA device and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import have_nvcc
    if not have_nvcc():
        pytest.skip("needs nvcc")


def _seeded_six_tier(seed, in_graph):
    rng = random.Random(0x515ED + seed)
    prog = _seeded_program(rng)
    verify(prog)                       # generator contract: always accepted
    ctx_kwargs = _seeded_ctx_kwargs(rng)

    buf0 = bytes(make_ctx("tuner", **ctx_kwargs).buf)
    results = {}
    b = bytearray(buf0)
    results["interp"] = (VM(prog.insns, {}).run(b), bytes(b))
    b = bytearray(buf0)
    results["jit"] = (compile_program(prog, {})(b), bytes(b))
    results["reference interp"] = torch_ref.interp(prog, buf0)[:2]

    # native: compiled machine code, whenever the host has a toolchain
    from repro_torch.core.cc import compile_native, have_cc
    from repro_torch.core.verifier import verify_with_info
    if have_cc():
        fn_n = compile_native(prog, {}, verify_with_info(prog))
        b = bytearray(buf0)
        results["native"] = (fn_n(b), bytes(b))

    # the policy kernel's tiers behind the bridge: its plain version on
    # the CPU, the kernel (u64 and pair form) on the card
    from repro_torch.core.bridge import compile_host
    for tier in in_graph:
        fn = compile_host(prog, {}, verify_with_info(prog), tier=tier)
        b = bytearray(buf0)
        results[tier] = (fn(b), bytes(b))

    want = results["interp"]
    for tier, got in results.items():
        assert got == want, (
            f"tier {tier} diverged (seed {seed}):\n"
            f"  ret  {got[0]:#x} != {want[0]:#x}\n"
            f"  prog:\n{prog.disasm()}")


@pytest.mark.parametrize("seed", range(24))
def test_seeded_six_tier_differential(seed):
    """interp == jit == native == torch == the reference's interp on
    >= 20 seeded boundary-biased programs (ret AND ctx writeback), the
    native leg whenever the host has a C toolchain (have_cc)."""
    _seeded_six_tier(seed, ("torch",))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(24))
def test_seeded_six_tier_differential_on_the_card(seed, card):
    """The same programs on the policy kernel, u64 and pair form."""
    _seeded_six_tier(seed, ("cuda", "cuda32"))


# ---------------------------------------------------------------------------
# Seeded source-level harness: random hash-map and bpf-to-bpf-call
# policies through the SAME six-tier ladder (frontend -> verifier ->
# every backend), interp as ground truth.  Generated restricted-Python
# source is registered in linecache so inspect.getsource works on the
# exec'd policy function.
# ---------------------------------------------------------------------------

import linecache

from repro_torch.core.frontend import compile_policy, map_decl  # noqa: E402
from repro_torch.core.maps import MapRegistry  # noqa: E402
from repro_torch.core.verifier import verify_with_info  # noqa: E402


def _load_generated(src, name, tag, extra_globals):
    filename = f"<gen-{tag}>"
    linecache.cache[filename] = (len(src), None, src.splitlines(True),
                                 filename)
    ns = dict(extra_globals)
    exec(compile(src, filename, "exec"), ns)
    return ns[name]


def _mk_resolved(prog):
    reg = MapRegistry()
    return {d.name: reg.create(d.name, d.kind, key_size=d.key_size,
                               value_size=d.value_size,
                               max_entries=d.max_entries)
            for d in prog.maps}


def _hash_state(resolved, keys):
    """Full (slot0, slot1) value state per probed key — present AND
    absent keys, so divergence in occupancy is caught, not just values."""
    return {n: [(m.lookup_u64(k, 0), m.lookup_u64(k, 1)) for k in keys]
            for n, m in resolved.items()}


def _tier_builders(card: bool):
    """name -> fn(prog, resolved_maps, vinfo) -> callable(ctx_buf) for
    every tier available in this environment beyond the interpreter:
    the host tiers and ``torch``, or with ``card`` the policy kernel's
    ``cuda`` and ``cuda32``.  Bridge tiers come wrapped in the real
    DeviceBridge (flush() after the run reconciles device-resident hash
    state back to host maps)."""
    from repro_torch.core.bridge import compile_host
    from repro_torch.core.cc import compile_native, have_cc
    if card:
        return {t: lambda p, m, v, t=t: compile_host(p, m, v, tier=t)
                for t in ("cuda", "cuda32")}
    builders = {
        "jit": lambda p, m, v: compile_program(p, m, info=v),
        "torch": lambda p, m, v: compile_host(p, m, v, tier="torch"),
    }
    if have_cc():
        builders["native"] = compile_native
    return builders


def _run_all_tiers(prog, ctx_kw, keys, seed_state=None, card=False):
    """interp ground truth, then every tier builder; assert bit-identical
    (ret, ctx writeback, decoded hash state by key)."""
    vinfo = verify_with_info(prog)

    def fresh_maps():
        resolved = _mk_resolved(prog)
        if seed_state:
            for name, kvs in seed_state.items():
                for k, (v0, v1) in kvs.items():
                    resolved[name].update_u64(k, v0, slot=0)
                    resolved[name].update_u64(k, v1, slot=1)
        return resolved

    maps_i = fresh_maps()
    ctx = make_ctx("tuner", **ctx_kw)
    want_ret = VM(prog.insns, maps_i, subprogs=prog.subprogs).run(ctx.buf)
    want = (want_ret, bytes(ctx.buf), _hash_state(maps_i, keys))

    ref_prog, ref_maps = torch_ref.program(prog), torch_ref.maps(fresh_maps())
    ctx_r = make_ctx("tuner", **ctx_kw)
    ret = RefVM(ref_prog.insns, ref_maps,
                subprogs=ref_prog.subprogs).run(ctx_r.buf)
    assert (ret, bytes(ctx_r.buf), _hash_state(ref_maps, keys)) == want, \
        f"the reference's interpreter diverged\n{prog.disasm()}"

    for tier, build in _tier_builders(card).items():
        maps_t = fresh_maps()
        fn = build(prog, maps_t, vinfo)
        ctx_t = make_ctx("tuner", **ctx_kw)
        ret = fn(ctx_t.buf)
        if hasattr(fn, "flush"):
            fn.flush()
        got = (ret, bytes(ctx_t.buf), _hash_state(maps_t, keys))
        assert got == want, (
            f"tier {tier} diverged:\n  ret {got[0]} != {want[0]}\n"
            f"  state {got[2]} != {want[2]}\n{prog.disasm()}")
    return want_ret


def _gen_hash_policy(seed):
    """Random hash-map soup over a DELIBERATELY tiny table: keys come in
    same-residue collision clusters (k, k+cap share a probe slot), and
    more distinct keys than capacity force the full-table E2BIG path.
    Covers insert / lookup-hit / lookup-miss / in-place pointer update."""
    rng = random.Random(0xA5E + seed)
    cap = rng.choice([2, 3, 4])
    decl = map_decl("soup_hash", kind="hash", key_size=8, value_size=16,
                    max_entries=cap)
    base = [rng.randrange(1, 1 << 31) for _ in range(3)]
    keys = sorted({k + j * cap for k in base for j in range(2)})
    lines = ["def gen_hash(ctx):", "    acc = ctx.n_ranks + 1"]
    for i in range(rng.randint(5, 12)):
        r = rng.random()
        k = rng.choice(keys)
        if r < 0.40:
            lines += [f"    st = soup_hash.lookup({k})",
                      "    if st is None:",
                      f"        acc = acc + {rng.randrange(1, 50)}",
                      "    else:",
                      "        acc = acc + st[0] + st[1]"]
        elif r < 0.80:
            lines += [f"    soup_hash.update({k}, (acc, {i + 1}))"]
        else:
            lines += [f"    st = soup_hash.lookup({k})",
                      "    if st is not None:",
                      "        st[0] = st[0] + acc"]
    lines.append("    return acc & 0xffffffff")
    src = "\n".join(lines) + "\n"
    fn = _load_generated(src, "gen_hash", f"hash-{seed}",
                         {"soup_hash": decl})
    return compile_policy(fn, section="tuner", maps=[decl]), keys


_CALL_ALU = [
    "{d} = ({d} * {c} + {o}) & 0xffffffffffffffff",
    "{d} = {d} ^ ({o} << {s})",
    "{d} = ({d} + {c}) & 0xffffffff",
    "{d} = {d} >> {s}",
    "{d} = {d} | ({c} & {o})",
    "{d} = ({d} - {o}) & 0xffffffffffffffff",
]


def _gen_call_policy(seed):
    """Random bpf-to-bpf-call soup: 2-3 nested subprograms of random
    arity with ALU-soup bodies, random sub-to-sub call edges (depth > 1
    call graph), calls inside an unrolled bounded loop, and a final call
    to a random subprogram — all shapes the verifier's call-graph/stack
    accounting must prove and every backend must agree on."""
    rng = random.Random(0xCA11 + seed)
    n_subs = rng.randint(2, 3)
    arity = [rng.randint(1, 3) for _ in range(n_subs)]
    lines = ["def gen_call(ctx):"]
    for s in range(n_subs):
        params = [f"a{j}" for j in range(arity[s])]
        lines.append(f"    def s{s}({', '.join(params)}):")
        for _ in range(rng.randint(2, 4)):
            t = rng.choice(_CALL_ALU)
            d = rng.choice(params)
            o = rng.choice(params + [str(rng.randrange(1, 1 << 16))])
            lines.append("        " + t.format(
                d=d, o=o, c=rng.randrange(1, 1 << 16),
                s=rng.choice([1, 3, 7, 13, 31])))
        if s > 0 and rng.random() < 0.7:
            callee = rng.randrange(s)
            cargs = ", ".join(rng.choice(params)
                              for _ in range(arity[callee]))
            lines.append(f"        t = s{callee}({cargs})")
            lines.append(f"        {params[0]} = {params[0]} ^ t")
        ret = " + ".join(params)
        lines.append(f"        return ({ret}) & 0xffffffffffffffff")
    k = rng.randint(2, 5)
    c0 = ", ".join(["acc"] + ["i"] * (arity[0] - 1))
    lines += ["    acc = ctx.msg_size & 0xffff",
              f"    for i in range({k}):",
              f"        t = s0({c0})",
              "        acc = (acc + t + i) & 0xffffffffffffffff"]
    top = rng.randrange(n_subs)
    ctop = ", ".join(
        ["acc"] + [str(rng.randrange(1, 99))] * (arity[top] - 1))
    lines += [f"    u = s{top}({ctop})",
              "    return (acc ^ u) & 0xffffffff"]
    src = "\n".join(lines) + "\n"
    fn = _load_generated(src, "gen_call", f"call-{seed}", {})
    return compile_policy(fn, section="tuner", maps=[])


@pytest.mark.parametrize("seed", range(10))
def test_seeded_hash_soup_six_tier(seed):
    """Random hash-map programs (insert / lookup / in-place update /
    collision chains / full-table E2BIG) bit-identical across every
    tier, decoded state compared key-by-key including absent keys.
    Half the seeds start from pre-seeded host state, so the in-graph
    legs also cover the upload (host -> device) direction."""
    prog, keys = _gen_hash_policy(seed)
    _run_all_tiers(prog, dict(n_ranks=4 + seed, msg_size=1 << 20),
                   keys, _hash_soup_state(seed, keys))


def _hash_soup_state(seed, keys):
    if seed % 2:
        return {"soup_hash": {keys[0]: (7 + seed, 11),
                              keys[-1]: (3, 5 * seed + 1)}}
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(10))
def test_seeded_hash_and_call_soups_on_the_card(seed, card):
    """The hash and call soups on the policy kernel, u64 and pair form."""
    prog, keys = _gen_hash_policy(seed)
    _run_all_tiers(prog, dict(n_ranks=4 + seed, msg_size=1 << 20), keys,
                   _hash_soup_state(seed, keys), card=True)
    _run_all_tiers(_gen_call_policy(seed),
                   dict(msg_size=(seed + 3) << 12, n_ranks=8), keys=[],
                   card=True)


@pytest.mark.parametrize("seed", range(10))
def test_seeded_call_soup_six_tier(seed):
    """Random call-using programs (2-3 subprograms, random call edges,
    calls in bounded loops) bit-identical across every tier."""
    prog = _gen_call_policy(seed)
    _run_all_tiers(prog, dict(msg_size=(seed + 3) << 12, n_ranks=8),
                   keys=[])


def test_full_hash_table_e2big_everywhere():
    """Directed: capacity-2 table, three colliding keys — the third
    insert must fail with E2BIG on EVERY tier, leaving it absent, while
    the two resident keys update in place."""
    cap = 2
    decl = map_decl("tiny_hash", kind="hash", key_size=8, value_size=16,
                    max_entries=cap)
    k0, k1, k2 = 10, 10 + cap, 10 + 2 * cap   # one probe chain
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
    fn = _load_generated(src, "tiny", "tiny-e2big", {"tiny_hash": decl})
    prog = compile_policy(fn, section="tuner", maps=[decl])
    ret = _run_all_tiers(prog, dict(n_ranks=2), keys=[k0, k1, k2])
    assert ret == 1                                  # hit k0, never k2


# ---------------------------------------------------------------------------
# Hypothesis harness (host tiers; boundary-biased constant pool)
# ---------------------------------------------------------------------------

# NOTE: guarded import, NOT importorskip — importorskip would skip the
# whole module at collection, taking the (dependency-free) seeded
# six-tier harness above down with it.  Without hypothesis only the
# hypothesis-driven tests disappear.
try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
    HAVE_HYPOTHESIS = True
except ImportError:          # pragma: no cover — depends on the env
    HAVE_HYPOTHESIS = False

if not HAVE_HYPOTHESIS:
    def _skip(*a, **k):      # placeholder keeping the skip visible
        pytest.skip("property tests need hypothesis; the seeded "
                    "six-tier harness above and test_torch_jit_v2.py keep "
                    "deterministic differential coverage of these tiers")
    test_vm_jit_agree_on_verified_programs = _skip
    test_verified_programs_never_fault = _skip


if HAVE_HYPOTHESIS:
    _alu = st.sampled_from(["add64", "sub64", "mul64", "and64", "or64", "xor64",
                            "rsh64", "lsh64"])
    _alui = st.sampled_from(["add64i", "sub64i", "mul64i", "and64i", "or64i",
                             "xor64i", "mov64i"])
    # bias the immediate pool toward the 32-bit boundary (where pair-lowered
    # carry/borrow and shift semantics live), keep a uniform tail for breadth
    _imm = st.one_of(st.sampled_from(BOUNDARY), st.integers(0, 2**31 - 1))


    @st.composite
    def straightline_program(draw):
        insns = []
        # initialize all scratch regs from ctx inputs or (boundary-biased)
        # constants — lddw carries the full-width encodings
        for r in REGS:
            if draw(st.booleans()):
                f = draw(st.sampled_from(IN_FIELDS))
                insns.append(Insn("ldxdw", dst=r, src=1, off=f.offset))
            else:
                insns.append(Insn("lddw", dst=r, imm=draw(_imm)))
        n_ops = draw(st.integers(3, 25))
        for _ in range(n_ops):
            kind = draw(st.integers(0, 3))
            if kind == 0:
                op = draw(_alu)
                insns.append(Insn(op, dst=draw(st.sampled_from(REGS)),
                                  src=draw(st.sampled_from(REGS))))
            elif kind == 1:
                op = draw(_alui)
                imm = draw(_imm)
                if op in ("rsh64i", "lsh64i"):
                    imm %= 64
                insns.append(Insn(op, dst=draw(st.sampled_from(REGS)), imm=imm))
            elif kind == 2:
                f = draw(st.sampled_from(OUT_FIELDS))
                insns.append(Insn("stxdw", dst=1, src=draw(st.sampled_from(REGS)),
                                  off=f.offset))
            else:
                # forward conditional jump over a small gap (filled with ALU)
                op = draw(st.sampled_from(["jeqi", "jgti", "jlti", "jnei"]))
                insns.append(Insn(op, dst=draw(st.sampled_from(REGS)),
                                  imm=draw(st.integers(0, 1000)), off=1))
                insns.append(Insn("mov64i", dst=draw(st.sampled_from(REGS)),
                                  imm=draw(st.integers(0, 1000))))
        insns.append(Insn("mov64", dst=0, src=draw(st.sampled_from(REGS))))
        insns.append(Insn("exit"))

        # sprinkle longer forward jumps (nested/overlapping diamonds) —
        # inserted back-to-front so earlier offsets stay valid; targets land
        # on whatever instruction follows the gap, exercising state joins
        n_jumps = draw(st.integers(0, 3))
        for _ in range(n_jumps):
            pos = draw(st.integers(0, max(len(insns) - 3, 0)))
            max_off = len(insns) - pos - 2   # keep target before final exit
            if max_off < 1:
                continue
            off = draw(st.integers(1, min(6, max_off)))
            op = draw(st.sampled_from(["jeqi", "jgei", "jlei", "jset" + "i",
                                       "ja"]))
            if op == "ja":
                insns.insert(pos, Insn("ja", off=off))
            else:
                insns.insert(pos, Insn(op, dst=draw(st.sampled_from(REGS)),
                                       imm=draw(st.integers(0, 2**20)),
                                       off=off))
        return Program("prop", "tuner", insns)


    @st.composite
    def ctx_values(draw):
        kwargs = {}
        for f in IN_FIELDS:
            kwargs[f.name] = draw(st.integers(0, 2**48))
        return kwargs


    @settings(max_examples=200, deadline=None)
    @given(prog=straightline_program(), ctx_kwargs=ctx_values())
    def test_vm_jit_agree_on_verified_programs(prog, ctx_kwargs):
        try:
            verify(prog)
        except VerifierError:
            # e.g. mul overflow widening then used as shift amount — fine;
            # property only concerns *accepted* programs
            return
        vm = VM(prog.insns, {})
        fn_v2 = compile_program(prog, {})

        c1 = make_ctx("tuner", **ctx_kwargs)
        c2 = make_ctx("tuner", **ctx_kwargs)
        ref = torch_ref.interp(prog, c1.buf)
        r_vm = vm.run(c1.buf)
        r_v2 = fn_v2(c2.buf)
        assert r_vm == r_v2 == ref[0]
        assert c1.buf == c2.buf == ref[1]


    @settings(max_examples=200, deadline=None)
    @given(prog=straightline_program(), ctx_kwargs=ctx_values())
    def test_verified_programs_never_fault(prog, ctx_kwargs):
        """Soundness witness: if the verifier accepts, the VM must not fault."""
        try:
            verify(prog)
        except VerifierError:
            return
        vm = VM(prog.insns, {})
        try:
            vm.run(make_ctx("tuner", **ctx_kwargs).buf)
        except VMError as e:  # pragma: no cover
            raise AssertionError(
                f"verifier accepted but VM faulted: {e}\n{prog.disasm()}")
