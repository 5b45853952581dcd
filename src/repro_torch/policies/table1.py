"""The seven safe policies of Table 1 (plus the native baseline).

Overheads in the paper decompose as ``80 + 30*n_lookup + 10*n_update`` ns;
the suite below replicates the same map-op counts so our Table 1 benchmark
reproduces the decomposition (in our host tier's units):

  noop               — 0 lookups, 0 updates   (+80 ns in paper)
  static_override    — 0 / 0                  (+80)
  size_aware         — 1 lookup               (+110)
  adaptive_channels  — 1 lookup               (+120 — hash vs array delta)
  latency_feedback   — 1 lookup, 1 update     (+120)
  bandwidth_probe    — 1 lookup, 1 update     (+120)
  slo_enforcer       — 2 lookups (hash), 1 upd(+130)
"""

from __future__ import annotations

from ..core.context import Algo, Proto
from ..core.frontend import map_decl, policy

ALGO_DEFAULT = Algo.DEFAULT
ALGO_RING = Algo.RING
ALGO_TREE = Algo.TREE
PROTO_SIMPLE = Proto.SIMPLE
PROTO_LL = Proto.LL
PROTO_LL128 = Proto.LL128

latency_map = map_decl("latency_map", kind="hash", key_size=4,
                       value_size=16, max_entries=256)
chan_map = map_decl("chan_map", kind="array", value_size=8, max_entries=256)
slo_map = map_decl("slo_map", kind="hash", key_size=4,
                   value_size=8, max_entries=256)
probe_map = map_decl("probe_map", kind="array", value_size=16, max_entries=256)


def native_baseline(ctx):
    """Identical policy logic with NO eBPF layer (paper §4, -O2 analogue).

    Plain Python operating on the same ctx buffer via the typed wrapper —
    measures dispatch floor without verification/JIT."""
    msg = int.from_bytes(ctx[8:16], "little")
    algo = ALGO_TREE if msg <= 32 * 1024 else ALGO_RING
    ctx[64:72] = algo.to_bytes(8, "little")
    ctx[72:80] = PROTO_SIMPLE.to_bytes(8, "little")
    ctx[80:88] = (8).to_bytes(8, "little")
    return 0


@policy(section="tuner", maps=[])
def noop(ctx):
    return 0


@policy(section="tuner", maps=[])
def static_override(ctx):
    ctx.algorithm = ALGO_RING
    ctx.protocol = PROTO_SIMPLE
    ctx.n_channels = 8
    return 0


@policy(section="tuner", maps=[chan_map])
def size_aware(ctx):
    if ctx.msg_size <= 32 * 1024:
        ctx.algorithm = ALGO_TREE
        ctx.protocol = PROTO_LL
    else:
        ctx.algorithm = ALGO_RING
        ctx.protocol = PROTO_SIMPLE
    st = chan_map.lookup(0)
    if st is None:
        ctx.n_channels = 8
        return 0
    ctx.n_channels = max(st[0], 1)
    return 0


@policy(section="tuner", maps=[latency_map])
def adaptive_channels(ctx):
    st = latency_map.lookup(ctx.comm_id)
    if st is None:
        ctx.n_channels = 2
        return 0
    if st[0] > 1000000:
        ctx.n_channels = min(st[1] + 1, 16)
    else:
        ctx.n_channels = st[1]
    return 0


@policy(section="tuner", maps=[latency_map])
def latency_feedback(ctx):
    st = latency_map.lookup(ctx.comm_id)
    if st is None:
        latency_map.update(ctx.comm_id, (0, 4))
        ctx.n_channels = 4
        return 0
    ctx.algorithm = ALGO_RING
    ctx.n_channels = st[1]
    st[1] = min(st[1] + 1, 32)
    return 0


@policy(section="tuner", maps=[probe_map])
def bandwidth_probe(ctx):
    st = probe_map.lookup(ctx.coll_type)
    if st is None:
        return 0
    st[0] = st[0] + 1
    if st[0] % 100 == 0:
        ctx.n_channels = 1 + st[0] // 100 % 32
    else:
        ctx.n_channels = max(st[1], 1)
    return 0


@policy(section="tuner", maps=[latency_map, slo_map])
def slo_enforcer(ctx):
    """Most complex row of Table 1: 2 hash lookups + 1 update."""
    slo = slo_map.lookup(ctx.comm_id)
    st = latency_map.lookup(ctx.comm_id)
    if slo is None:
        ctx.n_channels = 8
        return 0
    if st is None:
        latency_map.update(ctx.comm_id, (0, 8))
        ctx.n_channels = 8
        return 0
    if st[0] > slo[0]:
        ctx.algorithm = ALGO_RING
        ctx.protocol = PROTO_SIMPLE
        ctx.n_channels = min(st[1] * 2, 32)
    else:
        ctx.n_channels = st[1]
    return 0


SAFE_POLICIES = [
    noop, static_override, size_aware, adaptive_channels,
    latency_feedback, bandwidth_probe, slo_enforcer,
]
