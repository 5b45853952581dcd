"""The expert layer's dispatch on the host (``moe.dispatch`` spans: from
the router's scores to the held experts' inputs, the wait for the group
sizes on the host included), summed over the traced window, in percent
of it."""

from portbench.metrics.program_spans import share_of_window


def read(obs):
    return share_of_window(obs, "moe.dispatch")
