"""Seeded inputs for differential runs of the port's shipped policies.

The policy kernel, its plain PyTorch version, the interpreter and the
reference package's tiers are compared on the same inputs: host maps
filled from a numpy generator and ctx buffers drawn per section.  Values
stay below 2**40 so no tier's ``ema_update`` arithmetic leaves u64
(the reference lowering wraps, the interpreter does not).

The pair-form goldens (:func:`pair_goldens`) are the hand-written
programs of ``tests/test_pallas32.py``, for the pair-form kernel.

A helper of the tests and of ``chip_smoke.py`` (which puts ``tests/`` on
its path), not part of the ``repro_torch`` package.
"""

from __future__ import annotations

import dataclasses
import random
import struct
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.context import CTX_TYPES
from repro_torch.core.maps import BpfMap, MapRegistry
from repro_torch.core.program import Program

_VAL_HI = 1 << 40


def _hash_keys(rng: np.random.Generator, n: int) -> List[int]:
    """Small integers (comm-id style keys) and (coll, log2-size) bucket
    keys, so lookups hit as well as miss."""
    small = [int(k) for k in rng.choice(64, size=n, replace=False)]
    buckets = [(int(c) << 8) | int(b) for c, b in
               zip(rng.integers(0, 4, n), rng.integers(10, 31, n))]
    return [k for pair in zip(small, buckets) for k in pair][:n]


def fill_map(m: BpfMap, rng: np.random.Generator) -> None:
    """Seed one host map through its public surface."""
    slots = m.value_size // 8

    def val() -> bytes:
        return rng.integers(0, _VAL_HI, slots, dtype=np.int64) \
            .astype("<u8").tobytes()

    def key(k: int) -> bytes:
        return k.to_bytes(m.key_size, "little")

    if m.kind in ("array", "perdev_array"):
        for k in range(m.max_entries):
            if rng.random() < 0.5:
                m.update(struct.pack("<I", k), val())
    elif m.kind in ("hash", "lru_hash"):
        for k in _hash_keys(rng, min(m.max_entries // 2, 32)):
            m.update(key(k), val())
    elif m.kind == "ringbuf":
        for _ in range(int(rng.integers(0, m.max_entries))):
            m.output(val())
    else:
        raise ValueError(f"no seeding for map kind {m.kind}")


def make_maps(prog: Program, rng: np.random.Generator,
              registry=None) -> Dict[str, BpfMap]:
    """Fresh, seeded host maps for ``prog``'s declarations, created in
    ``registry`` (a new port ``MapRegistry`` when None; pass the
    reference's for its maps: the same seed fills both alike)."""
    reg = MapRegistry() if registry is None else registry
    out = {}
    for d in prog.maps:
        m = reg.create(d.name, d.kind, key_size=d.key_size,
                       value_size=d.value_size, max_entries=d.max_entries)
        fill_map(m, rng)
        out[d.name] = m
    return out


def _field_value(name: str, rng: np.random.Generator) -> int:
    if name in ("msg_size", "bytes"):
        return 1 << int(rng.integers(10, 31))
    if name == "coll_type":
        return int(rng.integers(0, 4))
    if name in ("n_ranks", "n_devices"):
        return int(rng.choice([1, 2, 4, 8, 16, 64]))
    if name in ("latency_ns", "timestamp_ns"):
        return int(rng.integers(1_000, 5_000_000))
    if name == "n_pods":
        return int(rng.integers(1, 3))
    return int(rng.integers(0, 64))


def make_ctx(prog: Program, rng: np.random.Generator) -> bytearray:
    """One ctx buffer for ``prog``'s section: inputs drawn, outputs 0."""
    ct = CTX_TYPES[prog.section]
    buf = bytearray(ct.size)
    for name, f in ct.fields.items():
        if not f.writable:
            buf[f.offset:f.offset + 8] = _field_value(name, rng).to_bytes(
                8, "little")
    return buf


# ---------------------------------------------------------------------------
# the §5.3 closed loop, on either package's dispatcher
# ---------------------------------------------------------------------------

def decision_stream(n: int, seed: int = 5) -> list:
    """``n`` seeded ``(coll, size, axis, latency_ns)`` decide-and-feed
    steps: 4 KiB - 1 GiB messages over three axes."""
    rng = np.random.default_rng(seed)
    return list(zip(rng.choice([0, 1, 2], n).tolist(),
                    np.left_shift(1, rng.integers(12, 31, n)).tolist(),
                    rng.choice(["dp", "tp", "ep"], n).tolist(),
                    rng.integers(2_000, 3_000_000, n).tolist()))


def drive_closed_loop(CollectiveDispatcher, pols, tier: str, stream):
    """The §5.3 closed loop on ``CollectiveDispatcher(tier=tier)`` of one
    package (``pols`` its policies): bucket_tuner and adapt_tuner on the
    tuner chain, adapt_profiler and bucket_profiler fed after every
    decision, a ``link.replace()`` of the tuner half way.  Returns the
    decisions as tuples, every final map's bytes and the runtime."""
    disp = CollectiveDispatcher(tier=tier)
    rt = disp.runtime
    tune = rt.attach(pols.bucket_tuner.program, priority=0)
    rt.attach(pols.adapt_tuner.program, priority=1)
    rt.attach(pols.adapt_profiler.program)
    rt.attach(pols.bucket_profiler.program)
    out = []
    for i, (coll, size, axis, lat) in enumerate(stream):
        if i == len(stream) // 2:
            tune.replace(pols.bucket_tuner.program)
        d = disp.decide(coll, size, 8, axis_name=axis)
        out.append(dataclasses.astuple(d))
        disp.profiler_feed(d.comm_id, lat, coll=d.coll,
                           msg_size=d.size_bytes, channels=d.channels,
                           algo=d.algo)
    rt.flush_bridges()
    maps = {n: rt.maps.get(n).to_device().tobytes()
            for n in sorted(rt.maps.names())}
    return out, maps, rt


# ---------------------------------------------------------------------------
# pair-form goldens: the programs of tests/test_pallas32.py
# ---------------------------------------------------------------------------
#
# Each is a hand-written program whose u64 values straddle the 32-bit lane
# split: carries and borrows, widening multiplies, shifts by 0/31/32/33/63,
# long division, compares in both signed half-planes, 32-bit ALU ops,
# sub-word stack stores, ctx writeback, an in-loop EMA over a map and a
# full-row map update.  A golden names its source and its maps; the
# callers assemble it with either package (``ns`` is ``repro.core`` or
# ``repro_torch.core``).

PAIR_CTX = dict(msg_size=8 << 20, comm_id=2, n_ranks=8, max_channels=32)

# 32-bit-boundary-heavy constant pool (includes negative-signed encodings)
BOUNDARY = [0, 1, 3, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1, 2**32,
            2**32 + 1, 2**48 + 12345, 2**63 - 1, 2**63, 2**63 + 1,
            2**64 - 1, -1, -2, -(2**31), -(2**32), -(2**63)]


@dataclasses.dataclass(frozen=True)
class Golden:
    id: str
    source: str
    # (name, kind, value_size, max_entries) per map
    maps: Tuple[Tuple[str, str, int, int], ...] = ()
    # (map name, key, u64 value) seeded with update_u64
    seeds: Tuple[Tuple[str, int, int], ...] = ()

    def program(self, ns) -> Program:
        decls = tuple(ns.map_decl(n, kind=k, value_size=v, max_entries=e)
                      for n, k, v, e in self.maps)
        return ns.assemble(self.source, name=f"g_{self.id}"[:60],
                           section="tuner", maps=decls)

    def host_maps(self, ns) -> Dict[str, BpfMap]:
        reg = ns.MapRegistry()
        out = {n: reg.create(n, k, value_size=v, max_entries=e)
               for n, k, v, e in self.maps}
        for n, key, val in self.seeds:
            out[n].update_u64(key, val)
        return out


def _binop(a: int, b: int, op: str) -> str:
    return f"""
        lddw  r6, {a}
        lddw  r7, {b}
        {op}  r6, r7
        mov64 r0, r6
        exit
    """


_JUMPS = ["jeq", "jne", "jgt", "jge", "jlt", "jle",
          "jsgt", "jsge", "jslt", "jsle", "jset"]
_CMP_PAIRS = [(5, 2**63 + 3), (2**63 + 3, 5), (2**63 + 5, 2**63 + 3),
              (7, 7), (2**32 + 1, 2**32 + 2), (2**32 + 2, 2**32 + 1),
              (0, 2**64 - 1), (2**31, 2**31 - 1)]
_SHIFT_VALS = [0x8000000000000001, 0xDEADBEEFCAFEBABE, 1, 2**63, 2**32 + 7]
_FUZZ_OPS = ["add64", "sub64", "mul64", "and64", "or64", "xor64",
             "add32", "sub32", "mul32", "xor32"]
_EMA_MAP = ("p32_ema", "array", 8, 4)
_EMA_LOOP = """
        stw    [r10-4], 2
        lddw   r7, 0xFFFFFFF0
        mov64  r6, 0
    loop:
        jge    r6, 65, out
        ldmap  r1, p32_ema
        mov64  r2, r10
        add64i r2, -4
        mov64  r3, r7
        add64  r3, r6
        mov64  r4, 4
        call   ema_update
        add64i r6, 1
        ja     loop
    out:
        mov64  r0, 0
        exit
    """


def _soup(seed: int) -> str:
    rng = random.Random(0x32B17 + seed)
    lines = [f"    lddw r{r}, {rng.choice(BOUNDARY)}" for r in (6, 7, 8)]
    for _ in range(rng.randint(6, 14)):
        k = rng.random()
        if k < 0.5:
            dst, src = rng.sample([6, 7, 8], 2)
            lines.append(f"    {rng.choice(_FUZZ_OPS)} r{dst}, r{src}")
        elif k < 0.8:
            op = rng.choice(["lsh64i", "rsh64i", "arsh64i"])
            lines.append(f"    {op} r{rng.choice([6, 7, 8])}, "
                         f"{rng.choice([0, 1, 31, 32, 33, 63])}")
        else:
            op = rng.choice(["jgt", "jslt", "jge", "jne"])
            lines.append(f"    {op} r{rng.choice([6, 7, 8])}, "
                         f"r{rng.choice([6, 7, 8])}, skip{len(lines)}")
            lines.append(f"    add64i r{rng.choice([6, 7, 8])}, "
                         f"{rng.randint(1, 1 << 20)}")
            lines.append(f"skip{len(lines) - 2}:")
    lines += ["    xor64 r6, r7", "    add64 r6, r8",
              "    mov64 r0, r6", "    exit"]
    return "\n".join(lines)


def pair_goldens() -> List[Golden]:
    """Every golden program, in the order of tests/test_pallas32.py."""
    g: List[Golden] = []
    for a in [0xFFFFFFFF, 2**32 - 2, 2**64 - 1, 2**63 - 1, 2**31 - 1, 0]:
        for b in [1, 0xFFFFFFFF, 2**63, 2**64 - 1]:
            g.append(Golden(f"add_{a:x}_{b:x}", _binop(a, b, "add64")))
    for a in [0, 1, 2**32, 2**32 - 1, 2**63, 5]:
        for b in [1, 2, 0xFFFFFFFF, 2**63 + 1, 2**64 - 1]:
            g.append(Golden(f"sub_{a:x}_{b:x}", _binop(a, b, "sub64")))
    g.append(Golden("neg64_imm_carry", """
        lddw   r6, 0xFFFFFFFF
        add64i r6, 1
        neg64  r6
        lddw   r7, -1
        add64  r6, r7
        mov64  r0, r6
        exit
    """))
    for a, b in [(0xFFFFFFFF, 0xFFFFFFFF), (0x123456789, 0x987654321),
                 (2**63 + 12345, 3), (2**32, 2**32),
                 (2**64 - 1, 2**64 - 1),
                 (0x1234_5678_9ABC_DEF0, 0x0FED_CBA9_8765_4321)]:
        g.append(Golden(f"mul_{a:x}_{b:x}", _binop(a, b, "mul64")))
    for op in ["lsh64i", "rsh64i", "arsh64i"]:
        for s in [0, 1, 31, 32, 33, 63]:
            for v in _SHIFT_VALS:
                g.append(Golden(f"{op}_{s}_{v:x}", f"""
        lddw  r6, {v}
        {op}  r6, {s}
        mov64 r0, r6
        exit
    """))
    for op in ["lsh64", "rsh64", "arsh64"]:
        for s in [0, 31, 32, 33, 63]:
            g.append(Golden(f"{op}_reg_{s}", f"""
        lddw  r6, 0x8123456789ABCDEF
        mov64 r7, {s}
        {op}  r6, r7
        mov64 r0, r6
        exit
    """))
    for op in _JUMPS:
        for a, b in _CMP_PAIRS:
            g.append(Golden(f"{op}_reg_{a:x}_{b:x}", f"""
        lddw  r6, {a}
        lddw  r7, {b}
        {op}  r6, r7, yes
        mov64 r0, 0
        exit
    yes:
        mov64 r0, 1
        exit
    """))
    for op in _JUMPS:
        for imm in [0, 1, -1, 2**31 - 1, -(2**31), 1000]:
            g.append(Golden(f"{op}_imm_{imm}", f"""
        lddw  r6, 0xFFFFFFFF80000000
        {op}  r6, {imm}, yes
        mov64 r0, 0
        exit
    yes:
        mov64 r0, 1
        exit
    """))
    for op in ["div64", "mod64"]:
        for a, b in [(2**64 - 1, 3), (2**63, 2**32 + 1), (12345, 997),
                     (2**64 - 1, 2**64 - 1), (5, 2**63 + 9),
                     (0xDEADBEEFCAFEBABE, 0x12345)]:
            g.append(Golden(f"{op}_{a:x}_{b:x}", _binop(a, b, op)))
    for op, arg in [("add32", "r7"), ("sub32", "r7"), ("mul32", "r7"),
                    ("xor32", "r7"), ("lsh32i", "5"), ("rsh32i", "7"),
                    ("arsh32i", "3"), ("mov32", "r7"), ("div32", "r7"),
                    ("mod32", "r7"), ("neg32", None)]:
        line = f"{op} r6" if arg is None else f"{op} r6, {arg}"
        g.append(Golden(f"alu32_{op}", f"""
        lddw  r6, 0xFFFFFFFF8000000F
        lddw  r7, 0x10000000B
        {line}
        mov64 r0, r6
        exit
    """))
    g.append(Golden("subword_stack_rmw", """
        lddw   r6, 0x1122334455667788
        stxdw  [r10-8], r6
        stb    [r10-3], 0xAB
        sth    [r10-8], 0xCDEF
        ldxw   r7, [r10-8]
        ldxb   r8, [r10-3]
        ldxdw  r0, [r10-8]
        add64  r0, r7
        add64  r0, r8
        exit
    """))
    g.append(Golden("ctx_writeback", """
        ldxdw  r6, [r1+msg_size]
        rsh64i r6, 20
        stxdw  [r1+n_channels], r6
        lddw   r7, 0xFFFFFFFF00000002
        stxdw  [r1+algorithm], r7
        mov64  r0, 0
        exit
    """))
    # the EMA seed crosses the lane split; the second seed is the one the
    # reference's kernel-vs-body check uses
    for seed in (0xFFFFFFFFFF, 54321):
        g.append(Golden(f"inloop_ema_{seed:x}", _EMA_LOOP, (_EMA_MAP,),
                        (("p32_ema", 2, seed),)))
    g.append(Golden("map_update_full_row", """
        stw    [r10-4], 1
        lddw   r6, 0xAABBCCDDEEFF0011
        stxdw  [r10-24], r6
        lddw   r7, 0x1234567890ABCDEF
        stxdw  [r10-16], r7
        ldmap  r1, p32_row
        mov64  r2, r10
        add64i r2, -4
        mov64  r3, r10
        add64i r3, -24
        mov64  r4, 0
        call   map_update_elem
        exit
    """, (("p32_row", "array", 16, 3),)))
    for seed in range(8):
        g.append(Golden(f"soup_{seed}", _soup(seed)))
    return g


# ---------------------------------------------------------------------------
# model-kernel inputs (B3-B5)
# ---------------------------------------------------------------------------

def kernel_inputs(kernel: str, seed: int, **shape) -> Dict[str, np.ndarray]:
    """Seeded float32 inputs of one model kernel, drawn from
    ``np.random.RandomState(seed)`` in the order ``tests/test_kernels.py``
    draws them, so both frameworks get the same arrays.

    ``rmsnorm``: ``T, D, with_residual`` -> x, scale (and residual);
    ``grouped_matmul``: ``E, C, D, F`` -> x, w (scaled by 0.1);
    ``flash_attention``: ``q_shape``, ``kv_shape`` -> q, k, v."""
    rng = np.random.RandomState(seed)
    if kernel == "rmsnorm":
        T, D = shape["T"], shape["D"]
        out = {"x": rng.randn(T, D), "scale": rng.rand(D) + 0.5}
        if shape.get("with_residual"):
            out["residual"] = rng.randn(T, D)
    elif kernel == "grouped_matmul":
        E, C, D, F = shape["E"], shape["C"], shape["D"], shape["F"]
        out = {"x": rng.randn(E, C, D) * 0.1, "w": rng.randn(E, D, F) * 0.1}
    elif kernel == "flash_attention":
        out = {"q": rng.randn(*shape["q_shape"]),
               "k": rng.randn(*shape["kv_shape"]),
               "v": rng.randn(*shape["kv_shape"])}
    else:
        raise ValueError(f"no inputs for kernel {kernel!r}")
    return {n: a.astype(np.float32) for n, a in out.items()}


def bf16_round(a: np.ndarray) -> np.ndarray:
    """Float32 ``a`` rounded to bfloat16 (round to nearest, ties to even)
    and widened back: the values ``torch``'s and ``jax``'s bf16 casts of
    a float32 array both hold."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    bits = bits.astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return rounded.astype(np.uint32).view(np.float32)
