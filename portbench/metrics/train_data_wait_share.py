"""The trainer's wait for its next batch (``trainer.data_wait`` spans,
``next()`` on the prefetch queue) over the traced window, in percent."""

from portbench.metrics.program_spans import share_of_window


def read(obs):
    return share_of_window(obs, "trainer.data_wait")
