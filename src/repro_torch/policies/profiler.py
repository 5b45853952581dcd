"""Always-on profiler suite — the observability plane's policy side.

The paper's profiler hook (§5.3) observes every collective completion:
``CollectiveDispatcher.profiler_feed`` builds a profiler ctx
(event_type, coll_type, msg_size, comm_id, latency_ns, n_channels,
algorithm, timestamp_ns) and invokes the attached profiler chain.  The
two policies below are designed to ride that hook *always on*:

``latency_histogram``
    log2-bucketed latency counts into a per-device array map — one
    lookup + one in-place increment per event, no contention across
    device shards (the host merges with ``aggregate_u64``).

``straggler_trap``
    per-communicator EMA (``ema_update`` on an LRU hash, so dead
    communicators age out instead of leaking entries) plus a ringbuf
    event emitted only when a completion exceeds ``STRAGGLER_FACTOR``x
    the running mean — the flight-recorder feed.  Drop-on-full: a slow
    consumer costs events (counted), never blocks the data path.

Both compile through the verifier and run on every tier (vm / jit v1+v2
/ jaxc / pallas / pallas32 for the histogram+ringbuf path; the LRU map
keeps ``straggler_trap`` off the 32-bit pair tier by design).

Record layout of one straggler event (4 u64 slots, 32 bytes):

  [0] comm_id   [1] latency_ns   [2] ema_ns   [3] timestamp_ns
"""

from __future__ import annotations

from ..core.frontend import map_decl, policy

# histogram: 16 log2 buckets, bucket i counts latencies in
# [2^(10+i), 2^(11+i)) ns, with bucket 0 also catching everything below
# 1us and bucket 15 everything at/above ~33ms
N_BUCKETS = 16
STRAGGLER_FACTOR = 2        # latency > FACTOR * EMA emits an event
EMA_WEIGHT = 8              # new = (old*(w-1) + sample) / w
EVENT_SLOTS = 4             # u64 slots per straggler record
EVENT_SIZE = EVENT_SLOTS * 8

lat_hist = map_decl("lat_hist", kind="perdev_array", value_size=8,
                    max_entries=N_BUCKETS)
ema_map = map_decl("ema_map", kind="lru_hash", key_size=4,
                   value_size=8, max_entries=64)
events = map_decl("events", kind="ringbuf", value_size=EVENT_SIZE,
                  max_entries=256)


@policy(section="profiler", maps=[lat_hist])
def latency_histogram(ctx):
    # binary search over the 16 log2 thresholds: 4 compares per event
    # (this is the always-on hot path — a linear if-chain would execute
    # all 15 compares on every fast completion)
    lat = ctx.latency_ns
    if lat >= 262144:
        if lat >= 4194304:
            if lat >= 16777216:
                if lat >= 33554432:
                    b = 15
                else:
                    b = 14
            else:
                if lat >= 8388608:
                    b = 13
                else:
                    b = 12
        else:
            if lat >= 1048576:
                if lat >= 2097152:
                    b = 11
                else:
                    b = 10
            else:
                if lat >= 524288:
                    b = 9
                else:
                    b = 8
    else:
        if lat >= 16384:
            if lat >= 65536:
                if lat >= 131072:
                    b = 7
                else:
                    b = 6
            else:
                if lat >= 32768:
                    b = 5
                else:
                    b = 4
        else:
            if lat >= 4096:
                if lat >= 8192:
                    b = 3
                else:
                    b = 2
            else:
                if lat >= 2048:
                    b = 1
                else:
                    b = 0
    c = lat_hist.lookup(b)
    if c is None:
        return 0
    c[0] = c[0] + 1
    return 0


@policy(section="profiler", maps=[ema_map, events])
def straggler_trap(ctx):
    lat = ctx.latency_ns
    ema_update(ema_map, ctx.comm_id, lat, EMA_WEIGHT)
    st = ema_map.lookup(ctx.comm_id)
    if st is None:
        return 0
    avg = st[0]
    if lat <= avg * STRAGGLER_FACTOR:
        return 0
    e = events.reserve()
    if e is None:
        return 0
    e[0] = ctx.comm_id
    e[1] = lat
    e[2] = avg
    e[3] = ctx.timestamp_ns
    events.submit()
    return 1


PROFILER_POLICIES = [latency_histogram, straggler_trap]
