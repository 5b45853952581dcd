"""Flight recorder — the bounded, always-on event store.

``FlightRecorder.poll()`` is the single ingestion point: it flushes any
device-resident profiler bridges (so in-graph tiers' ring writes reach
the host map — the T3 boundary), drains the ``events`` ringbuf, parses
each record, and appends it to a bounded host store.  The store is
itself a :class:`~repro_torch.core.maps.RingBufMap` in overwrite mode (via
:class:`~repro_torch.core.maps.RingView`): when the recorder falls behind,
the OLDEST flight records age out and the overflow is counted — the
recorder can never grow without bound and never blocks a producer.

Loss accounting is two-level and explicit:

* ``device_drops`` — events the *policies* dropped because the ring was
  full before the host drained it (the ring's cumulative drop counter);
* ``host_overflow`` — parsed records the *store* evicted because more
  than ``capacity`` arrived without an export.

Histogram snapshots read the per-device array map non-destructively
(``aggregate_u64`` merges shards); straggler records decode the 4-slot
layout written by ``straggler_trap``:

  [0] comm_id   [1] latency_ns   [2] ema_ns   [3] timestamp_ns
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List, Optional

from ..core.maps import MapError, RingView
from ..core.runtime import PolicyRuntime, global_runtime

EVENT_STRUCT = struct.Struct("<4Q")

# histogram buckets mirror policies/profiler.py: bucket 0 is everything
# below 2^11 ns, bucket i >= 1 starts at 2^(10+i) ns
def bucket_lower_bounds(n_buckets: int) -> List[int]:
    return [0] + [1 << (10 + i) for i in range(1, n_buckets)]


@dataclasses.dataclass(frozen=True)
class StragglerRecord:
    comm_id: int
    latency_ns: int
    ema_ns: int
    timestamp_ns: int

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


def _encode(rec: StragglerRecord) -> bytes:
    return EVENT_STRUCT.pack(rec.comm_id, rec.latency_ns, rec.ema_ns,
                             rec.timestamp_ns)


def _decode(raw: bytes) -> StragglerRecord:
    return StragglerRecord(*EVENT_STRUCT.unpack(raw))


class FlightRecorder:
    """Bounded always-on store fed from the profiler event ring.

    ``register=True`` (default) publishes the recorder on the runtime so
    :meth:`PolicyRuntime.health` / ``CollectiveDispatcher.health`` fold
    its counters into their structured health dict (satellite surface:
    one place to read bridge stats + observability loss accounting)."""

    def __init__(self, runtime: Optional[PolicyRuntime] = None, *,
                 capacity: int = 1024, events_map: str = "events",
                 hist_map: str = "lat_hist", register: bool = True):
        self.runtime = runtime or global_runtime()
        self.events_map = events_map
        self.hist_map = hist_map
        self.capacity = capacity
        self._store = RingView(capacity, EVENT_STRUCT.size,
                               _encode, _decode, name="flight_records")
        self.events_seen = 0
        self.parse_errors = 0
        if register:
            self.runtime.attach_recorder(self)

    # -- ingestion ---------------------------------------------------------
    def _map(self, name: str):
        try:
            return self.runtime.maps.get(name)
        except (KeyError, MapError):
            return None

    def poll(self, *, flush: bool = True) -> int:
        """Drain the event ring into the store; returns records ingested.

        ``flush`` first syncs device-resident profiler bridges so ring
        writes made inside compiled kernels are visible on the host map
        (no-op on host tiers)."""
        if flush:
            self.runtime.flush_bridges("profiler")
        ring = self._map(self.events_map)
        if ring is None:
            return 0
        n = 0
        for raw in ring.drain():
            self.events_seen += 1
            if len(raw) < EVENT_STRUCT.size:
                self.parse_errors += 1
                continue
            self._store.append(_decode(raw[:EVENT_STRUCT.size]))
            n += 1
        return n

    # -- read surface ------------------------------------------------------
    def records(self) -> List[StragglerRecord]:
        """Every stored flight record, oldest first (non-destructive)."""
        return list(self._store)

    def histogram(self) -> List[int]:
        """Merged per-bucket counts across device shards (non-destructive;
        empty list when the histogram policy is not loaded)."""
        hist = self._map(self.hist_map)
        if hist is None or not hasattr(hist, "aggregate_u64"):
            return []
        return [hist.aggregate_u64(b) for b in range(hist.max_entries)]

    def counters(self) -> Dict[str, int]:
        ring = self._map(self.events_map)
        return {
            "events_seen": self.events_seen,
            "records_stored": len(self._store),
            "capacity": self.capacity,
            "device_drops": ring.drops if ring is not None else 0,
            "device_pending": len(ring) if ring is not None else 0,
            "host_overflow": self._store.drops,
            "parse_errors": self.parse_errors,
        }

    def health(self) -> Dict[str, object]:
        hist = self.histogram()
        return {"counters": self.counters(),
                "histogram_total": sum(hist),
                "histogram_buckets": len(hist)}

    def clear(self) -> None:
        """Drop stored records (cumulative counters survive, like the
        ring's drop counter)."""
        self._store.clear()
