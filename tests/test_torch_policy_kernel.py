"""The port's plain PyTorch policy kernel (``repro_torch.core.torchc``)
against the reference's Pallas policy kernel.

For every shipped policy, seeded maps and a run of seeded ctx samples go
through ``repro.core.pallasc.compile_pallas(mode="pallas",
interpret=True, word_width=64)`` (the Pallas interpreter, under the x64
scope) and through ``torchc``.  Tolerance: none — ret, the ctx words and
every map word must be bit-identical after every sample (map state
carries from one sample to the next on both sides).

The same file holds the port's load-time rejections to the reference's
messages, and the unsigned-arithmetic corners the int64 encoding has to
get right.
"""

import numpy as np
import pytest
import torch

import repro.policies as ref_policies
import repro.policies.profiler as ref_profiler
import torch_samples as samples
from repro.core import assemble as ref_assemble
from repro.core import map_decl as ref_map_decl
from repro.core.jaxc import JaxcError, check_supported as ref_check
from repro_torch.core import assemble, map_decl
from repro_torch.core import torchc
from repro_torch.core.cudac import CudacError, PolicyKernel
from repro_torch.core.verifier import verify_with_info
from repro_torch.policies import ALL_POLICIES

N_SAMPLES = 3


def _x64():
    from repro.compat import have_x64
    if not have_x64():
        pytest.skip("jax build lacks a working enable_x64")
    import jax

    from repro.compat import enable_x64
    from repro.core import pallasc
    return jax, enable_x64, pallasc


@pytest.mark.parametrize("pol", ALL_POLICIES, ids=lambda p: p.program.name)
def test_torchc_matches_pallas_kernel(pol):
    jax, enable_x64, pallasc = _x64()
    import jax.numpy as jnp

    prog = pol.program
    ref_prog = getattr(ref_policies, prog.name,
                       getattr(ref_profiler, prog.name, None)).program
    vinfo = verify_with_info(prog)
    seed = sum(map(ord, prog.name))
    host = samples.make_maps(prog, np.random.default_rng(seed))
    arrays = {n: m.to_device() for n, m in host.items()}   # u64 images
    fn, names = pallasc.compile_pallas(ref_prog, mode="pallas",
                                       interpret=True, word_width=64)
    jfn = jax.jit(fn)
    tmaps = {n: torch.from_numpy(a.view("<i8").copy())
             for n, a in arrays.items()}
    rng = np.random.default_rng(seed + 1)
    with enable_x64(True):
        jmaps = {n: jnp.asarray(a, jnp.uint64) for n, a in arrays.items()}
        for _ in range(N_SAMPLES):
            buf = samples.make_ctx(prog, rng)
            ret, ctx_out, jmaps = jfn(
                jnp.asarray(np.frombuffer(bytes(buf), "<u8")), jmaps)
            t_ret, t_ctx, tmaps = torchc.run(prog, vinfo,
                                             torchc.ctx_to_vec(buf), tmaps)
            assert int(t_ret) & (2**64 - 1) == int(ret)
            assert torchc.vec_to_bytes(t_ctx) == \
                np.asarray(ctx_out, "<u8").tobytes()
            for n in names:
                assert tmaps[n].numpy().view("<u8").tobytes() == \
                    np.asarray(jmaps[n], "<u8").tobytes(), n


# ---------------------------------------------------------------------------
# load-time rejections: the reference's messages
# ---------------------------------------------------------------------------

_REJECT = {
    "ktime": ("tuner", """
        call   ktime_get_ns
        mov64  r0, 0
        exit
    """, ()),
    "prandom": ("tuner", """
        call   get_prandom_u32
        mov64  r0, 0
        exit
    """, ()),
    "printk": ("profiler", """
        mov64  r1, 7
        call   trace_printk
        mov64  r0, 0
        exit
    """, ()),
    "delete": ("tuner", """
        stw    [r10-4], 1
        ldmap  r1, del_map
        mov64  r2, r10
        add64i r2, -4
        call   map_delete_elem
        mov64  r0, 0
        exit
    """, (("del_map", "hash", 4, 8),)),
    "unaligned_value": ("tuner", """
        mov64  r0, 0
        exit
    """, (("odd_map", "array", 4, 12),)),
}


@pytest.mark.parametrize("case", sorted(_REJECT))
def test_rejections_match_reference(case):
    section, text, decls = _REJECT[case]

    def build(asm, md):
        maps = tuple(md(n, kind=k, key_size=ks, value_size=vs,
                        max_entries=16) for n, k, ks, vs in decls)
        return asm(text, name=f"rej_{case}", section=section, maps=maps)

    with pytest.raises(JaxcError) as ref:
        ref_check(build(ref_assemble, ref_map_decl))
    prog = build(assemble, map_decl)
    with pytest.raises(torchc.TorchcError) as got:
        torchc.check_supported(prog)
    assert str(got.value) == str(ref.value)
    with pytest.raises(CudacError) as k:
        PolicyKernel(prog)
    assert str(ref.value) in str(k.value)
    assert "cannot lower to the cuda tier" in str(k.value)


# ---------------------------------------------------------------------------
# unsigned u64 on int64: the corners
# ---------------------------------------------------------------------------

_EDGES = [0, 1, 2, 7, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 1,
          2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2, 2**64 - 1]


def _t(v):
    return torch.tensor(torchc._s64(v), dtype=torch.int64)


def _u(t):
    return int(t) & (2**64 - 1)


@pytest.mark.parametrize("base", ["add", "sub", "mul", "div", "mod", "and",
                                  "or", "xor", "lsh", "rsh", "arsh", "neg",
                                  "mov"])
@pytest.mark.parametrize("width", [64, 32])
def test_alu_matches_u64_semantics(base, width):
    m = 2**width - 1
    for a in _EDGES:
        for b in _EDGES:
            x, y = a & m, b & m
            sh = b & (width - 1)
            sx = x - 2**width if x >> (width - 1) else x
            want = {"add": x + y, "sub": x - y, "mul": x * y,
                    "div": x // max(y, 1), "mod": x % max(y, 1),
                    "and": x & y, "or": x | y, "xor": x ^ y,
                    "lsh": x << sh, "rsh": x >> sh, "arsh": sx >> sh,
                    "neg": -x, "mov": y}[base] & m
            got = _u(torchc._alu(base, width, _t(a), _t(b)))
            assert got == want, (base, width, a, b)


@pytest.mark.parametrize("base", ["jeq", "jne", "jgt", "jge", "jlt", "jle",
                                  "jset", "jsgt", "jsge", "jslt", "jsle"])
def test_compares_unsigned_except_signed_forms(base):
    def s(v):
        return v - 2**64 if v >> 63 else v
    for a in _EDGES:
        for b in _EDGES:
            want = {"jeq": a == b, "jne": a != b, "jgt": a > b,
                    "jge": a >= b, "jlt": a < b, "jle": a <= b,
                    "jset": (a & b) != 0, "jsgt": s(a) > s(b),
                    "jsge": s(a) >= s(b), "jslt": s(a) < s(b),
                    "jsle": s(a) <= s(b)}[base]
            assert torchc._cmp(base, _t(a), _t(b)) == want, (base, a, b)
