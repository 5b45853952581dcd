"""The traced run's device view: ``torch.profiler`` over the measured
window, reduced to the device's busy time (the union of the intervals in
which a kernel, copy or set ran), device time by operation name, and the
idle time between device operations named by the harness span the host
was in (``record_function`` ranges named ``portbench.<what>``)."""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Optional, Tuple

SPAN = "portbench."


class Tracer:
    """``with Tracer(on) as tr:`` around the window; ``tr.span(name)``
    around each harness step (a no-op when off).  The trace covers the
    window's first ``limit_s`` seconds (``tr.tick()`` at the runner's
    chunk boundaries ends it): reading a trace costs the host far more
    than taking it, and a run has to end in its time limit."""

    def __init__(self, on: bool, device: str = "cuda",
                 limit_s: float = float("inf")):
        self.on = on
        self.device = device
        self.limit_s = limit_s
        self.prof = None
        self.window_s = 0.0

    def __enter__(self):
        if self.on:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device == "cuda":
                acts.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.on:
            self._stop(*exc)
        return False

    def _stop(self, *exc):
        import torch
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.__exit__(*(exc or (None, None, None)))
        self.on = False

    def tick(self) -> None:
        """End the trace once it has covered ``limit_s`` seconds."""
        if self.on and time.perf_counter() - self._t0 >= self.limit_s:
            self._stop()

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(SPAN + name)

    def summary(self) -> Optional[dict]:
        """None when off; else ``busy_s``, ``window_s``, ``by_name`` (name
        -> [count, seconds]) and ``idle_by_span`` (span -> seconds)."""
        if self.prof is None:
            return None
        return summarize(self.prof.events(), self.window_s)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events, window_s: float) -> dict:
    from torch.autograd import DeviceType

    dev: List[Tuple[float, float]] = []
    spans: List[Tuple[float, float, str]] = []
    by_name: Dict[str, List[float]] = {}
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA and (
                e.name.startswith(SPAN) or
                getattr(e, "is_user_annotation", False) or
                e.name.startswith("nccl:")):
            # a range the host annotated (a harness span, the process
            # group's ``nccl:<op>``) mirrored on the device's timeline:
            # no device work of its own
            continue
        if e.name.startswith(SPAN):
            spans.append((tr.start, tr.end, e.name[len(SPAN):]))
        elif e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end))
            t = by_name.setdefault(e.name, [0, 0.0])
            t[0] += 1
            t[1] += (tr.end - tr.start) / 1e6
    busy = union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    idle = idle_by_span(busy, spans)
    return {"busy_s": busy_s, "window_s": window_s, "by_name": by_name,
            "idle_by_span": idle, "device_events": len(dev)}


def idle_by_span(busy, spans) -> Dict[str, float]:
    """Idle device time between busy intervals, summed by the harness span
    that covers each gap's middle (``outside`` where none does).  The
    harness's spans follow one another and never nest."""
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    out: Dict[str, float] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = spans[i][2] if i >= 0 and spans[i][1] >= mid else "outside"
        out[name] = out.get(name, 0.0) + (b - a) / 1e6
    return out


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten spans the host was in while the device idled."""
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(summary["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v[1]] for n, v in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
