"""The 99th percentile of decide() over every decision of the window, on
the host clock (one reading per decision, so a per-layer view: each
reading spans tens to hundreds of microseconds)."""

import numpy as np


def read(obs):
    ns = obs.get("decide_ns")
    if ns is None or len(ns) < 1000:
        return None
    return float(np.percentile(np.frombuffer(ns, dtype=np.int64), 99)) / 1e3
