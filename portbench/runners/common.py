"""What the runners share: a decision's fields, the device record and
the peak memory (the run's peak so far, read before the reference
runs)."""

from __future__ import annotations

from typing import Optional


def device_record(device: str, count: int, peak: int,
                  summary: Optional[dict]) -> dict:
    """The result line's ``device``: the card's name, the cards used, the
    peak on the fullest one, and with a trace the busy seconds (averaged
    over the cards) and the traced window's length."""
    if device == "cuda":
        import torch
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
               "count": count, "memory_peak_bytes": peak}
    else:
        rec = {"platform": "cpu", "kind": "cpu", "count": count,
               "memory_peak_bytes": peak}
    if summary is not None:
        rec["busy_s"] = summary["busy_s"]
        rec["window_s"] = summary["window_s"]
    return rec


def read_peak(device: str) -> int:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())
    return 0


def decision_fields(d) -> tuple:
    """A decision's fields in the order the reference gives them."""
    return (d.coll, d.algo, d.proto, d.channels, d.size_bytes, d.n_ranks,
            d.axis_kind, d.comm_id, d.from_policy)
