"""Observability plane — host side.

The always-on profiler policies (``repro_torch.policies.profiler``) stream
straggler events into a ringbuf map and bucket latencies into a
per-device histogram; this package is the consumer half:

* :class:`FlightRecorder` — drains the event ring into a bounded
  host-side record store (itself a ringbuf, overwrite mode) and
  snapshots the histogram; exposes drop/overflow counters and a
  ``health()`` dict the runtime/dispatcher health surfaces merge.
* :class:`Exporter` — serializes recorder snapshots as JSON-lines
  (histogram / straggler / counters records) for offline tooling.
"""

from .exporter import Exporter
from .recorder import FlightRecorder, StragglerRecord, bucket_lower_bounds

__all__ = ["FlightRecorder", "StragglerRecord", "Exporter",
           "bucket_lower_bounds"]
