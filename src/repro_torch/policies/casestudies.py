"""§5.3 case-study policies.

``ring_mid_v2`` is the paper's ``nvlink_ring_mid_v2`` — fewer than 20 lines:
Ring/LL128 for 4–32 MiB, Ring/Simple for 64–192 MiB, defer to the default
otherwise.  ``bad_channels`` is the deliberately destructive-but-verified
policy (1 channel).  The adaptive pair implements the profiler-to-tuner
closed loop used in the composability experiment.
"""

from __future__ import annotations

from ..core.context import Algo, Proto
from ..core.frontend import map_decl, policy

ALGO_DEFAULT = Algo.DEFAULT
ALGO_RING = Algo.RING
PROTO_SIMPLE = Proto.SIMPLE
PROTO_LL128 = Proto.LL128

MiB = 1 << 20


@policy(section="tuner", maps=[])
def ring_mid_v2(ctx):
    """Message-size-aware policy: beats the default in the 4-128 MiB band."""
    if ctx.msg_size < 4 * MiB:
        return 0                      # defer to default
    if ctx.msg_size <= 32 * MiB:
        ctx.algorithm = ALGO_RING
        ctx.protocol = PROTO_LL128
        ctx.n_channels = 32
        return 0
    if ctx.msg_size <= 192 * MiB:
        ctx.algorithm = ALGO_RING
        ctx.protocol = PROTO_SIMPLE
        ctx.n_channels = 32
        return 0
    return 0                          # 256 MiB+: default (NVLS analogue) wins


@policy(section="tuner", maps=[])
def bad_channels(ctx):
    """Verified-but-destructive: memory-safe, throughput-catastrophic."""
    ctx.algorithm = ALGO_RING
    ctx.protocol = PROTO_SIMPLE
    ctx.n_channels = 1
    return 0


# ---- composability: profiler -> shared map -> tuner ------------------------

# shared=True pins the EMA map: the profiler writes it, the tuner reads
# it, and host-side tooling fetches it by name (registry.get_pinned) — the
# paper's cross-plugin map, explicit rather than incidental
adapt_map = map_decl("adapt_map", kind="array", value_size=24, max_entries=64,
                     shared=True)
# value layout: [0]=ema latency ns, [1]=current channels, [2]=sample count


@policy(section="profiler", maps=[adapt_map])
def adapt_profiler(ctx):
    st = adapt_map.lookup(ctx.comm_id % 64)
    if st is None:
        return 0
    if st[0] == 0:
        st[0] = ctx.latency_ns
    else:
        st[0] = (st[0] * 7 + ctx.latency_ns) // 8
    st[2] = st[2] + 1
    return 0


@policy(section="tuner", maps=[adapt_map])
def adapt_tuner(ctx):
    """Start conservative (2 channels); ramp on telemetry; back off under
    contention.  Mirrors the paper's three-phase experiment."""
    st = adapt_map.lookup(ctx.comm_id % 64)
    if st is None:
        ctx.n_channels = 2
        return 0
    if st[1] == 0:
        st[1] = 2
    if st[0] == 0:
        ctx.n_channels = st[1]
        return 0
    if st[0] > 1000000:
        st[1] = max(st[1] - 2, 2)      # contention: back off fast
    elif st[2] % 8192 == 0:
        st[1] = min(st[1] + 1, 12)     # healthy: ramp slowly
    ctx.n_channels = st[1]
    return 0


# ---- net plugin program: byte/connection accounting ------------------------

net_stats = map_decl("net_stats", kind="array", value_size=24, max_entries=8)
# value layout per op: [0]=calls, [1]=bytes, [2]=peak bytes


@policy(section="net", maps=[net_stats])
def net_accounting(ctx):
    st = net_stats.lookup(ctx.op)
    if st is None:
        return 0
    st[0] = st[0] + 1
    st[1] = st[1] + ctx.bytes
    st[2] = max(st[2], ctx.bytes)
    return 0


# ---- env plugin: init-time defaults (NCCL env plugin analogue) --------------

@policy(section="env", maps=[])
def env_defaults(ctx):
    """Deployment-wide defaults: bandwidth-lean rings on small meshes,
    conservative channel cap on multi-pod."""
    if ctx.n_pods > 1:
        ctx.default_channels = 4
        ctx.max_channels = 16
        return 0
    ctx.default_channels = 8
    ctx.max_channels = 32
    return 0
