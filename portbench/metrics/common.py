"""Arithmetic the readers share."""

from typing import Optional


def idle_share(obs: dict) -> Optional[float]:
    """The device's idle share of the traced window, in percent: 1 less
    the union of its busy intervals over the window's length."""
    tr = obs.get("trace")
    if not tr or tr["window_s"] <= 0 or not tr["device_events"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

