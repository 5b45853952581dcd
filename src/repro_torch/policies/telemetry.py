"""Hash-keyed per-(collective, size-bucket) telemetry — tuner + profiler.

The tentpole pair: two policies on two different hook sections sharing
one subroutine library (:mod:`repro_torch.policies.common`) and one key
scheme — ``bucket_key(coll_type, msg_size)`` packs the collective kind
in the high byte and ``log2_bucket(msg_size)`` in the low byte — over
fixed-capacity open-addressing **hash** maps, so both run in-graph on
every tier including the 32-bit-pair one (``pallas32``), where keys
compare as (lo, hi) uint32 pairs.

``bucket_tuner``  (tuner)    — per-key (count, EMA msg_size) state; the
    EMA picks ring/simple for large running sizes, tree/LL for small,
    and channel count scales with the size bucket, clamped to [2, 16].
``bucket_profiler`` (profiler) — per-key (count, EMA latency_ns) state;
    returns the event count so invoke-all chains stay observable.

Capacity semantics (documented contract, README §hash-maps): the table
holds ``max_entries`` keys, inserts into a full table fail with E2BIG
(the policy's update is a no-op and the tuner defers), existing keys
always update in place, and there is no in-graph eviction — size the
table for the key universe (here 8 collectives x 64 buckets bounded in
practice by ~20 live size buckets).
"""

from __future__ import annotations

from ..core.context import Algo, Proto
from ..core.frontend import map_decl, policy
from .common import bucket_key, clamp, ema_step, log2_bucket

ALGO_RING = Algo.RING
ALGO_TREE = Algo.TREE
PROTO_SIMPLE = Proto.SIMPLE
PROTO_LL = Proto.LL

EMA_SHIFT = 3               # ema_step weight 2**3: new = (old*7 + sample) / 8
LARGE_EMA = 262144          # ring/simple at/above 256 KiB running size

# (count, ema) per (coll_type, size-bucket) — u64 composite key.  The
# merge spec is what makes the state mesh-safe: on a multi-device run
# each shard accumulates its own copy, and the shard merge
# (core.shardmerge) sums the count deltas while the EMA cell goes to
# the shard with the most writes (max-version-wins) instead of being
# summed into nonsense
tuner_state = map_decl("bucket_tune_state", kind="hash", key_size=8,
                       value_size=16, max_entries=128,
                       merge=("sum", "max"))
prof_state = map_decl("bucket_prof_state", kind="hash", key_size=8,
                      value_size=16, max_entries=128,
                      merge=("sum", "max"))


@policy(section="tuner", maps=[tuner_state])
def bucket_tuner(ctx):
    key = bucket_key(ctx.coll_type, ctx.msg_size)
    st = tuner_state.lookup(key)
    if st is None:
        # first sighting of this (collective, bucket): seed the EMA with
        # the sample and defer (outputs untouched -> chain falls through)
        tuner_state.update(key, (1, ctx.msg_size))
        return 0
    st[0] = st[0] + 1
    ema = ema_step(st[1], ctx.msg_size, EMA_SHIFT)
    st[1] = ema
    if ema >= LARGE_EMA:
        ctx.algorithm = ALGO_RING
        ctx.protocol = PROTO_SIMPLE
    else:
        ctx.algorithm = ALGO_TREE
        ctx.protocol = PROTO_LL
    b = log2_bucket(ema)
    nc = clamp(b - 10, 2, 16)
    ctx.n_channels = nc
    return st[0]


@policy(section="profiler", maps=[prof_state])
def bucket_profiler(ctx):
    key = bucket_key(ctx.coll_type, ctx.msg_size)
    st = prof_state.lookup(key)
    if st is None:
        prof_state.update(key, (1, ctx.latency_ns))
        return 1
    st[0] = st[0] + 1
    ema = ema_step(st[1], ctx.latency_ns, EMA_SHIFT)
    st[1] = ema
    return st[0]


TELEMETRY_POLICIES = [bucket_tuner, bucket_profiler]
