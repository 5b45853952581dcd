"""JSON-lines exporter for flight-recorder snapshots.

One :meth:`Exporter.snapshot` emits a self-describing batch, one JSON
object per line, to a path or stream:

  {"kind": "histogram", "seq": N, "buckets": [{"ge_ns": .., "count": ..}]}
  {"kind": "straggler", "seq": N, "comm_id": .., "latency_ns": ..,
   "ema_ns": .., "timestamp_ns": ..}
  {"kind": "counters",  "seq": N, "events_seen": .., "device_drops": ..,
   "host_overflow": .., ...}

The counters line closes every batch, so a consumer can both frame
batches and audit loss (drops/overflow are cumulative).  Stragglers are
consumed from the recorder store on export (each record is emitted
exactly once across snapshots); the histogram is cumulative state and
re-emitted in full each time.
"""

from __future__ import annotations

import json
from typing import IO, List, Optional

from .recorder import FlightRecorder, bucket_lower_bounds

SCHEMA_KINDS = ("histogram", "straggler", "counters")


class Exporter:
    def __init__(self, recorder: FlightRecorder, path: Optional[str] = None,
                 *, stream: Optional[IO[str]] = None):
        if (path is None) == (stream is None):
            raise ValueError("exactly one of path/stream is required")
        self.recorder = recorder
        self.path = path
        self._stream = stream
        self.seq = 0
        self.lines_written = 0

    # -- record construction ----------------------------------------------
    def export_records(self, *, poll: bool = True) -> List[dict]:
        """Build one batch of export records (see module docstring).
        ``poll`` drains the event ring into the recorder first."""
        rec = self.recorder
        if poll:
            rec.poll()
        self.seq += 1
        seq = self.seq
        out: List[dict] = []
        hist = rec.histogram()
        bounds = bucket_lower_bounds(len(hist))
        out.append({"kind": "histogram", "seq": seq, "total": sum(hist),
                    "buckets": [{"ge_ns": b, "count": c}
                                for b, c in zip(bounds, hist)]})
        for r in rec.records():
            out.append({"kind": "straggler", "seq": seq, **r.as_dict()})
        rec.clear()   # each straggler exports exactly once
        out.append({"kind": "counters", "seq": seq, **rec.counters()})
        return out

    def export_lines(self, *, poll: bool = True) -> List[str]:
        return [json.dumps(r, sort_keys=True)
                for r in self.export_records(poll=poll)]

    def snapshot(self, *, poll: bool = True) -> int:
        """Write one batch; returns the number of lines emitted."""
        lines = self.export_lines(poll=poll)
        text = "".join(line + "\n" for line in lines)
        if self._stream is not None:
            self._stream.write(text)
        else:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(text)
        self.lines_written += len(lines)
        return len(lines)


def validate_export(lines: List[str]) -> List[str]:
    """Schema check used by the CI driver: every line parses, kinds are
    known, histogram buckets are well-formed, counters close each batch.
    Returns a list of human-readable problems (empty = valid)."""
    problems: List[str] = []
    if not lines:
        return ["empty export"]
    last_kind = None
    seen_kinds = set()
    for i, line in enumerate(lines):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            problems.append(f"line {i}: not JSON ({e})")
            continue
        kind = rec.get("kind")
        if kind not in SCHEMA_KINDS:
            problems.append(f"line {i}: unknown kind {kind!r}")
            continue
        seen_kinds.add(kind)
        if "seq" not in rec:
            problems.append(f"line {i}: missing seq")
        if kind == "histogram":
            bks = rec.get("buckets")
            if not isinstance(bks, list) or not bks:
                problems.append(f"line {i}: histogram without buckets")
            elif not all(isinstance(b.get("ge_ns"), int)
                         and isinstance(b.get("count"), int) for b in bks):
                problems.append(f"line {i}: malformed bucket entries")
        elif kind == "straggler":
            for f in ("comm_id", "latency_ns", "ema_ns", "timestamp_ns"):
                if not isinstance(rec.get(f), int):
                    problems.append(f"line {i}: straggler missing {f}")
        elif kind == "counters":
            for f in ("events_seen", "device_drops", "host_overflow"):
                if not isinstance(rec.get(f), int):
                    problems.append(f"line {i}: counters missing {f}")
        last_kind = kind
    if last_kind != "counters":
        problems.append("batch not closed by a counters record")
    return problems
