"""Model FLOP utilization of the window, in percent: the model FLOPs of
its steps (``flops.py``, recomputation left out) over its length and the
card's bf16 dense peak (989 TFLOP/s, H100 SXM data sheet, at 700 W)."""


def read(obs):
    if not obs.get("steps") or not obs.get("window_s"):
        return None
    return 100.0 * obs["flops_per_step"] * obs["steps"] / obs["window_s"] \
        / obs["peak_flops"]
