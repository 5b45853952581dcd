"""The policy plane in plain Python: what a deployment of NCCLbpf decides
and what its maps hold after a stream of decisions and profiler feeds.

Each policy is its source's semantics written out over u64 words (the
paper's §5.3 case studies): ``adapt_tuner``, ``adapt_profiler`` and
``ring_mid_v2``.  An array map is a list of rows.  Chains compose as the paper's hooks do: the
tuner chain first-non-deferring-wins in priority order (a link defers by
leaving every output zero), the profiler chain runs every link.

A decision then goes through the dispatcher's rules: a chain that defers,
or decides outside the enums, gives the framework default (DEFAULT,
SIMPLE, 8 channels; ``from_policy`` false); the cost table with the
policy's choice zeroed picks that choice (every other entry is the
positive time of a collective of more than 4 KiB over 8 ranks); channels
are clamped to [1, 32].  The communicator id is the first four bytes of
``sha1("<axis>:<ranks>")``, little-endian, without the top bit.
"""

from __future__ import annotations

import collections
import hashlib
import struct
from typing import Callable, Dict, List, Optional, Tuple

RING, TREE, BIDIR_RING = 1, 2, 3
SIMPLE, LL, LL128 = 0, 1, 2
N_ALGOS, N_PROTOS = 4, 3
DEFAULT_CHANNELS, MAX_CHANNELS = 8, 32
MiB = 1 << 20


def comm_id(axis: str, n: int) -> int:
    h = hashlib.sha1(f"{axis}:{n}".encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


class ArrayMap:
    def __init__(self, rows: int, words: int):
        self.rows = [[0] * words for _ in range(rows)]

    def lookup(self, i: int) -> Optional[list]:
        return self.rows[i] if 0 <= i < len(self.rows) else None

    def snapshot(self) -> Dict[bytes, bytes]:
        return {struct.pack("<I", i): struct.pack(f"<{len(r)}Q", *r)
                for i, r in enumerate(self.rows)}


# the maps the programs declare: name -> (rows, u64 words)
MAPS = {"adapt_map": (64, 3)}
U64 = (1 << 64) - 1


class Policies:
    """The policies over maps ``m``."""

    def __init__(self, m: Dict[str, ArrayMap]):
        self.m = m

    # -- tuners: (ctx) -> return value; outputs written into ctx ---------
    def adapt_tuner(self, ctx: dict) -> int:
        st = self.m["adapt_map"].lookup(ctx["comm_id"] % 64)
        if st is None:
            ctx["n_channels"] = 2
            return 0
        if st[1] == 0:
            st[1] = 2
        if st[0] == 0:
            ctx["n_channels"] = st[1]
            return 0
        if st[0] > 1000000:
            st[1] = max((st[1] - 2) & U64, 2)
        elif st[2] % 8192 == 0:
            st[1] = min((st[1] + 1) & U64, 12)
        ctx["n_channels"] = st[1]
        return 0

    def ring_mid_v2(self, ctx: dict) -> int:
        size = ctx["msg_size"]
        if size < 4 * MiB:
            return 0
        if size <= 32 * MiB:
            ctx["algorithm"], ctx["protocol"] = RING, LL128
            ctx["n_channels"] = 32
        elif size <= 192 * MiB:
            ctx["algorithm"], ctx["protocol"] = RING, SIMPLE
            ctx["n_channels"] = 32
        return 0

    # -- profilers -------------------------------------------------------
    def adapt_profiler(self, ctx: dict) -> int:
        st = self.m["adapt_map"].lookup(ctx["comm_id"] % 64)
        if st is None:
            return 0
        lat = ctx["latency_ns"] & U64
        st[0] = lat if st[0] == 0 else (st[0] * 7 + lat & U64) // 8
        st[2] = (st[2] + 1) & U64
        return 0


PROGRAM_MAPS = {"adapt_tuner": ["adapt_map"], "adapt_profiler": ["adapt_map"],
                "ring_mid_v2": []}
SECTIONS = {"adapt_tuner": "tuner", "ring_mid_v2": "tuner",
            "adapt_profiler": "profiler"}

Decision = Tuple[int, int, int, int, int, int, int, int, bool]
"""(coll, algo, proto, channels, size_bytes, n_ranks, axis_kind, comm_id,
from_policy), the fields of the port's ``Decision`` in its order."""

DecisionFields = collections.namedtuple(
    "DecisionFields", "coll algo proto channels size_bytes n_ranks "
    "axis_kind comm_id from_policy")


class Deployment:
    """A configuration file's deployment, replayed: its programs attached
    in priority order (attach order breaking ties)."""

    def __init__(self, config: dict):
        names = set()
        for a in config["attach"]:
            names.update(PROGRAM_MAPS[a["program"]])
        self.maps = {n: ArrayMap(*MAPS[n]) for n in sorted(names)}
        pol = Policies(self.maps)
        order = sorted(enumerate(config["attach"]),
                       key=lambda ia: (ia[1]["priority"], ia[0]))
        self.tuners: List[Callable] = []
        self.profilers: List[Callable] = []
        for _, a in order:
            fn = getattr(pol, a["program"])
            (self.tuners if SECTIONS[a["program"]] == "tuner"
             else self.profilers).append(fn)
        # no map and no profiler: every decision a function of its key
        self.pure = not self.maps and not self.profilers

    def decide(self, coll: int, size: int, n: int, axis: str) -> Decision:
        cid = comm_id(axis, n)
        algo = proto = ch = 0
        if self.tuners:
            for fn in self.tuners:
                ctx = {"coll_type": coll, "msg_size": size, "n_ranks": n,
                       "comm_id": cid, "algorithm": 0, "protocol": 0,
                       "n_channels": 0}
                fn(ctx)
                algo, proto, ch = (ctx["algorithm"], ctx["protocol"],
                                   ctx["n_channels"])
                if algo or proto or ch:
                    break
        from_policy = bool(self.tuners) and bool(algo or proto or ch)
        if not from_policy or algo >= N_ALGOS or proto >= N_PROTOS \
                or ch > 0xFFFFFFFF:
            algo, proto, ch, from_policy = 0, SIMPLE, DEFAULT_CHANNELS, False
        ch = max(1, min(ch or DEFAULT_CHANNELS, MAX_CHANNELS))
        return (coll, algo, proto, ch, size, n, 0, cid, from_policy)

    def feed(self, d: Decision, latency_ns: int) -> None:
        """The profiler feed that follows decision ``d``'s collective."""
        self.feed_event(d[0], d[4], d[7], latency_ns, d[3], d[1])

    def feed_event(self, coll: int, size: int, cid: int, latency_ns: int,
                   channels: int, algo: int) -> None:
        ctx = {"coll_type": coll, "msg_size": size, "comm_id": cid,
               "latency_ns": latency_ns, "n_channels": channels,
               "algorithm": algo}
        for fn in self.profilers:
            fn(ctx)

    def snapshots(self) -> Dict[str, Dict[bytes, bytes]]:
        return {n: m.snapshot() for n, m in self.maps.items()}


def cached_by_size(decide: Callable) -> Callable:
    """The control of kind ``cache_key_size_only``: decisions served from
    a cache keyed on the message size alone (the collective, ranks and
    communicator left out of the key)."""
    cache: Dict[int, Decision] = {}

    def cached(coll: int, size: int, n: int, axis: str) -> Decision:
        d = cache.get(size)
        if d is None:
            d = cache[size] = decide(coll, size, n, axis)
        return d
    return cached


def mismatched_entries(got: Dict[str, Dict[bytes, bytes]],
                       want: Dict[str, Dict[bytes, bytes]]) -> int:
    """Map entries that differ: a key on one side only, or other bytes."""
    bad = 0
    for name in set(got) | set(want):
        g, w = got.get(name, {}), want.get(name, {})
        bad += sum(g.get(k) != w.get(k) for k in set(g) | set(w))
    return bad
