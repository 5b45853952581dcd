"""The pair-form policy kernel (B2, ``tier="cuda32"``), port against
reference: the golden battery of ``tests/test_pallas32.py``.

Every golden program (``torch_samples.pair_goldens``: carries, borrows,
widening multiplies, shifts across the lane split, long division,
compares in both signed half-planes, 32-bit ALU ops, sub-word stack
writes, ctx writeback, an in-loop EMA over a map and a full-row map
update) runs through

  * the port's pair-form kernel wrapper on CPU tensors
    (:meth:`repro_torch.core.cudac.PolicyKernel.launch32`, which runs its
    plain version :func:`repro_torch.core.torchc.run32`),
  * the port's interpreter, and
  * the reference's pair lowering ``repro.core.lower32.compile_jax32``,

and the return value, the ctx bytes and every map word must be
bit-identical.  The card runs the same goldens through the kernel itself
(``chip_smoke.py`` phase 7).
"""

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
import torch_samples as samples
from repro.core.lower32 import compile_jax32
from repro_torch.core import cudac, pair
from repro_torch.core.vm import VM

GOLDENS = samples.pair_goldens()


def _ctx(ns) -> bytearray:
    return ns.make_ctx("tuner", **samples.PAIR_CTX).buf


def _reference(g):
    from repro.core.lower32 import (ctx_to_vec32, map_to_array32,
                                    ret32_to_int, vec32_to_bytes)
    prog = g.program(ref_core)
    fn, names = compile_jax32(prog)
    maps = {n: map_to_array32(m) for n, m in g.host_maps(ref_core).items()}
    ret, vec, arrs = fn(ctx_to_vec32(_ctx(ref_core)), maps)
    return (ret32_to_int(ret), vec32_to_bytes(vec),
            {n: np.asarray(arrs[n]).view("<u4").tobytes() for n in names})


@pytest.mark.parametrize("g", GOLDENS, ids=lambda g: g.id)
def test_golden_bit_exact_against_vm_and_reference(g):
    prog = g.program(port_core)
    k = cudac.PolicyKernel(prog)
    host = g.host_maps(port_core)
    maps2 = {n: pair.map_to_array32(m) for n, m in host.items()}
    ctx2 = pair.ctx_to_vec32(_ctx(port_core))
    ret2 = torch.zeros(2, dtype=torch.int32)
    k.launch32(ctx2, ret2, maps2)
    assert k.launches32 == 0                 # CPU tensors: plain version
    got = (pair.ret32_to_int(ret2), pair.vec32_to_bytes(ctx2),
           {n: t.numpy().tobytes() for n, t in maps2.items()})

    vm_buf = _ctx(port_core)
    vm_ret = VM(prog.insns, host).run(vm_buf) & (2**64 - 1)
    assert got[0] == vm_ret, f"ret {got[0]:#x} != vm {vm_ret:#x}"
    assert got[1] == bytes(vm_buf), "ctx differs from the VM"
    for n, m in host.items():
        assert got[2][n] == m.to_device().tobytes(), n

    assert got == _reference(g)


def test_pair_layout_is_the_u64_image():
    words = torch.tensor([0x123456789ABCDEF0, 7, -1])
    pairs = pair.words_to_pairs(words)
    assert pairs.shape == (3, 2) and pairs.dtype == torch.int32
    u = pairs.numpy().view("<u4")
    assert (int(u[0, 0]), int(u[0, 1])) == (0x9ABCDEF0, 0x12345678)
    assert torch.equal(pair.pairs_to_words(pairs), words)
    assert pair.ret32_to_int(pairs[2]) == 2**64 - 1


def test_lru_hash_rejected_with_the_reference_workarounds():
    """lru_hash recency metadata stays off the pair tier: asking for
    cuda32 fails before anything is built, with the maps named and every
    workaround spelled out (tier names mapped: pallas32 -> cuda32)."""
    from repro_torch.core.bridge import compile_host
    from repro_torch.policies.profiler import straggler_trap

    prog = straggler_trap.program
    for make in (lambda: cudac.check_supported32(prog),
                 lambda: compile_host(prog, {}, tier="cuda32")):
        with pytest.raises(cudac.CudacError) as ei:
            make()
        msg = str(ei.value)
        assert "lru_hash" in msg and "'ema_map'" in msg
        assert 'kind="hash"' in msg and "cuda32" in msg
        assert "word_width=64" in msg
        assert "host tier" in msg
    k = cudac.PolicyKernel(prog)             # the u64 kernel takes it
    assert not cudac.supports_pairs(prog)
    assert "bpf_kernel32" not in k.source.launcher
    with pytest.raises(cudac.CudacError, match="lru_hash"):
        k.launch32(torch.zeros(k.n_fields, 2, dtype=torch.int32),
                   torch.zeros(2, dtype=torch.int32), {})


def test_pair_entry_and_its_checks():
    from repro_torch.policies import bucket_tuner
    k = cudac.PolicyKernel(bucket_tuner.program)
    src = k.source.launcher
    assert 'extern "C" __global__ void bpf_kernel32(uint32_t *ctx, ' \
        'uint32_t *ret, uint32_t *m0)' in src
    assert "bpf_kernel32<<<1, 32, 0, (cudaStream_t)stream>>>" in src
    assert "ret[1] = (uint32_t)(r >> 32);" in src
    maps = {n: torch.zeros((*k.shapes[n], 2), dtype=torch.int32)
            for n in k.names}
    ctx = torch.zeros(k.n_fields, 2, dtype=torch.int32)
    ret = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(cudac.CudacError, match="contiguous int32"):
        k.launch32(ctx.to(torch.int64), ret, maps)
    with pytest.raises(cudac.CudacError, match="aligned to 8 bytes"):
        k.launch32(torch.zeros(2 * k.n_fields + 1, dtype=torch.int32)[1:]
                   .reshape(k.n_fields, 2), ret, maps)
    with pytest.raises(cudac.CudacError, match=r"ret must be"):
        k.launch32(ctx, torch.zeros(1, dtype=torch.int32), maps)
    # a prefix renames every program symbol, so programs can share a
    # library (build_bundle)
    k2 = cudac.PolicyKernel(bucket_tuner.program, prefix="g7_")
    full = k2.source.full
    assert "g7_main(" in full and "g7_launch32(" in full
    assert "bpf_main(" not in full
