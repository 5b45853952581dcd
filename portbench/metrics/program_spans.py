"""What the readers of the port's own spans share: the newest profiler
session of ``repro_torch.obs.trace``, which records while the traced
window's ``torch.profiler`` runs and is read in the same process after
it.  A port without that store, or a session without the spans, gives
None."""

from typing import Optional


def durations_s(name: str):
    """The durations (s) of the newest session's ``name`` spans, or None
    where the port has no span store or the session no such span."""
    try:
        from repro_torch.obs import trace
    except ImportError:
        return None
    d = trace.spans(name)["dur_ns"]
    return d / 1e9 if len(d) else None


def share_of_window(obs: dict, name: str) -> Optional[float]:
    """The ``name`` spans' summed time over the traced window, in
    percent."""
    tr = obs.get("trace")
    d = durations_s(name)
    if d is None or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * float(d.sum()) / tr["window_s"]


def share_of_span(part: str, whole: str) -> Optional[float]:
    """The ``part`` spans' summed time over the ``whole`` spans', in
    percent."""
    p, w = durations_s(part), durations_s(whole)
    if p is None or w is None or not w.sum():
        return None
    return 100.0 * float(p.sum()) / float(w.sum())
