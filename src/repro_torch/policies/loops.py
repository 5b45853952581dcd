"""Loop-using tuner policies — inexpressible before bounded-loop support.

Until the verifier learned to prove trip bounds, policies were capped at
straight-line decision trees (loops had to unroll within ``_MAX_UNROLL``,
so whole-map scans were off the table).  These two tuners exercise the
full bounded-loop pipeline — frontend loop bytecode, verifier bound
proof, JIT v2 native ``while`` codegen, jaxc ``lax.fori_loop`` — on the
scenarios the ROADMAP calls out for 100k+-GPU scale telemetry:

* :func:`latency_argmin_tuner` — scan a per-channel-count latency map
  (written by a profiler via EMA) and pick the argmin configuration:
  closed-loop channel tuning over 96 candidate configurations in one
  decision.
* :func:`histogram_bucket_tuner` — log2-bucket the message size by loop,
  maintain a persistent size histogram, scan it for the hot bucket, and
  shape algorithm/protocol for the *dominant* traffic class instead of
  the current call only.

Both use array maps with 8-byte values so they also lower to the
in-graph jaxc tier unchanged.
"""

from __future__ import annotations

from ..core.context import Algo, Proto
from ..core.frontend import map_decl, policy

ALGO_RING = Algo.RING
ALGO_TREE = Algo.TREE
PROTO_SIMPLE = Proto.SIMPLE
PROTO_LL = Proto.LL

N_CONFIGS = 96          # candidate channel configs scanned per decision
# log2 message-size histogram buckets; deliberately above the frontend's
# 64-iteration unroll threshold so both scans compile to *real* verified
# loops in every tier (an unrolled 88-step shift chain would also bloat
# the jaxc graph by two orders of magnitude)
N_BUCKETS = 72
U64_MAX = 0xFFFFFFFFFFFFFFFF

# per-config EMA latency, written by a profiler program (shared so the
# host / a profiler plugin can feed it by name)
config_lat_map = map_decl("config_lat_map", kind="array", value_size=8,
                          max_entries=N_CONFIGS, shared=True)

# persistent message-size histogram (hit counts per log2 bucket)
size_hist_map = map_decl("size_hist_map", kind="array", value_size=8,
                         max_entries=N_BUCKETS, shared=True)


@policy(section="tuner", maps=[config_lat_map])
def latency_argmin_tuner(ctx):
    """Scan all measured configs; run the argmin config's channel count.

    A zero latency slot means "no telemetry yet" and is skipped; with no
    telemetry at all, fall back to 8 channels.
    """
    best = 0
    best_lat = U64_MAX
    for i in range(N_CONFIGS):
        st = config_lat_map.lookup(i)
        if st is not None:
            if st[0] > 0:
                if st[0] < best_lat:
                    best_lat = st[0]
                    best = i
    if best_lat == U64_MAX:
        ctx.n_channels = 8
        return 0
    ctx.algorithm = ALGO_RING
    ctx.protocol = PROTO_SIMPLE
    ctx.n_channels = min(best + 1, max(ctx.max_channels, 1))
    return 0


@policy(section="tuner", maps=[size_hist_map])
def histogram_bucket_tuner(ctx):
    """Bucket the current message size, then tune for the hot bucket.

    The log2 bucket index is computed by a bounded shift loop (no clz
    helper in the ISA); the histogram scan finds the traffic class that
    dominates this communicator and shapes the decision for it, so one
    giant outlier message does not flip the algorithm choice.
    """
    sz = ctx.msg_size
    bucket = 0
    for i in range(N_BUCKETS + 16):
        if sz > 1:
            sz = sz >> 1
            bucket = bucket + 1
    bucket = min(bucket, N_BUCKETS - 1)
    st = size_hist_map.lookup(bucket)
    if st is not None:
        st[0] = st[0] + 1

    hot = bucket
    hot_hits = 0
    for j in range(N_BUCKETS):
        h = size_hist_map.lookup(j)
        if h is not None:
            if h[0] > hot_hits:
                hot_hits = h[0]
                hot = j
    if hot >= 15:                      # >= 32 KiB dominates: bandwidth-bound
        ctx.algorithm = ALGO_RING
        ctx.protocol = PROTO_SIMPLE
        ctx.n_channels = min(16, max(ctx.max_channels, 1))
    else:                              # latency-bound traffic class
        ctx.algorithm = ALGO_TREE
        ctx.protocol = PROTO_LL
        ctx.n_channels = 4
    return 0


LOOP_POLICIES = [latency_argmin_tuner, histogram_bucket_tuner]
