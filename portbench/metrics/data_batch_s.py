"""The data pipeline's time to make one batch (``data.batch`` spans on
the prefetch thread), the mean over the batches begun in the traced
window, in seconds."""

from portbench.metrics.program_spans import durations_s


def read(obs):
    d = durations_s("data.batch")
    return None if d is None else float(d.mean())
