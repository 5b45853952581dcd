"""Seeded inputs for differential runs of the port's shipped policies.

The policy kernel, its plain PyTorch version, the interpreter and the
reference package's tiers are compared on the same inputs: host maps
filled from a numpy generator and ctx buffers drawn per section.  Values
stay below 2**40 so no tier's ``ema_update`` arithmetic leaves u64
(the reference lowering wraps, the interpreter does not).

A helper of the tests and of ``chip_smoke.py`` (which puts ``tests/`` on
its path), not part of the ``repro_torch`` package.
"""

from __future__ import annotations

import struct
from typing import Dict, List

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


def make_maps(prog: Program, rng: np.random.Generator) -> Dict[str, BpfMap]:
    """Fresh, seeded host maps for ``prog``'s declarations."""
    reg = MapRegistry()
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
