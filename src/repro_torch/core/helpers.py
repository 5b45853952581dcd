"""Helper function registry and per-program-type whitelists.

Helpers are the only way a policy program touches the outside world.  The
verifier checks (a) the helper id is whitelisted for the program's section
type, (b) argument registers carry the right abstract types (map pointer,
stack pointer to an initialized buffer of key/value size, scalar).

Ids follow the kernel where the helper exists there.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Tuple

# Argument type tags used by the verifier's call checker.
ARG_MAP_PTR = "map_ptr"
ARG_STACK_KEY = "stack_key"      # pointer to initialized key_size bytes
ARG_STACK_VALUE = "stack_value"  # pointer to initialized value_size bytes
ARG_SCALAR = "scalar"
ARG_ANYTHING = "any"

RET_MAP_VALUE_OR_NULL = "map_value_or_null"
RET_SCALAR = "scalar"


@dataclasses.dataclass(frozen=True)
class Helper:
    hid: int
    name: str
    args: Tuple[str, ...]
    ret: str


HELPERS = {
    1: Helper(1, "map_lookup_elem", (ARG_MAP_PTR, ARG_STACK_KEY), RET_MAP_VALUE_OR_NULL),
    2: Helper(2, "map_update_elem", (ARG_MAP_PTR, ARG_STACK_KEY, ARG_STACK_VALUE, ARG_SCALAR), RET_SCALAR),
    3: Helper(3, "map_delete_elem", (ARG_MAP_PTR, ARG_STACK_KEY), RET_SCALAR),
    5: Helper(5, "ktime_get_ns", (), RET_SCALAR),
    6: Helper(6, "trace_printk", (ARG_SCALAR,), RET_SCALAR),
    7: Helper(7, "get_prandom_u32", (), RET_SCALAR),
    # repro-specific: smoothed exponential moving average update helper —
    # new = (old*(w-1) + sample)/w, atomic on an 8-byte map slot.  Exists so
    # adaptive policies don't burn their insn budget on fixed-point math.
    64: Helper(64, "ema_update", (ARG_MAP_PTR, ARG_STACK_KEY, ARG_SCALAR, ARG_SCALAR), RET_SCALAR),
    # observability plane: the ringbuf reserve/submit surface.  Reserve
    # returns a pointer to one record slot (NULL when the ring is full —
    # the drop is counted map-side); submit publishes the pending
    # record, discard abandons it.  All three take only the map pointer,
    # so the existing call checker's map binding + null-tracked return
    # machinery covers them; the map KIND contract (ringbuf-only) is
    # enforced by the verifier's kind table below.
    65: Helper(65, "ringbuf_reserve", (ARG_MAP_PTR,), RET_MAP_VALUE_OR_NULL),
    66: Helper(66, "ringbuf_submit", (ARG_MAP_PTR,), RET_SCALAR),
    67: Helper(67, "ringbuf_discard", (ARG_MAP_PTR,), RET_SCALAR),
}

HELPER_IDS = {h.name: h.hid for h in HELPERS.values()}

# Per-section whitelists (the "illegal helper" bug class rejects e.g. a
# profiler-only helper used from a tuner program).
WHITELISTS = {
    "tuner": {1, 2, 3, 5, 7, 64, 65, 66, 67},
    "profiler": {1, 2, 3, 5, 6, 7, 64, 65, 66, 67},
    "net": {1, 2, 5, 7},
    "env": {1, 2, 5},
}

# Helper x map-kind contract: which kinds each map-taking helper may be
# called with.  The keyed surface (lookup/update/delete/ema) never runs
# on a ringbuf; the reserve/submit surface runs ONLY on one.
_KEYED_KINDS = frozenset(
    {"array", "hash", "percpu_array", "perdev_array", "lru_hash"})
HELPER_MAP_KINDS = {
    1: _KEYED_KINDS,
    2: _KEYED_KINDS,
    3: _KEYED_KINDS,
    64: _KEYED_KINDS,
    65: frozenset({"ringbuf"}),
    66: frozenset({"ringbuf"}),
    67: frozenset({"ringbuf"}),
}


def helper_allowed(section: str, hid: int) -> bool:
    return hid in WHITELISTS.get(section, set())


def ktime_get_ns() -> int:
    return time.monotonic_ns()


# xorshift64* state in a ctypes cell: the native tier (core/cc.py)
# advances the SAME generator in compiled code by writing this memory
# directly, so interleaving native and Python tiers stays one stream
_PRNG_STATE = (ctypes.c_uint64 * 1)(0x853C49E6748FEA9B)


def get_prandom_u32() -> int:
    # xorshift64*; deterministic across runs is fine for policies.
    x = _PRNG_STATE[0]
    x ^= (x >> 12) & ((1 << 64) - 1)
    x = (x ^ (x << 25)) & ((1 << 64) - 1)
    x ^= x >> 27
    _PRNG_STATE[0] = x
    return (x * 0x2545F4914F6CDD1D >> 32) & 0xFFFFFFFF
