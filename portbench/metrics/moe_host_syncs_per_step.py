"""The expert layer's reads from the device to the host (``moe.host_syncs``)
a training step, over the steps of the traced window (each adds once to
``moe.pairs_held``).  A port without those counters gives None."""


def read(obs):
    try:
        from repro_torch.obs import trace
        syncs = trace.counter("moe.host_syncs")
        steps = trace.counter("moe.pairs_held")
    except (ImportError, AttributeError, ValueError):
        return None
    if syncs is None or steps is None:
        return None
    return syncs["total"] / steps["additions"]
