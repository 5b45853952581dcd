"""The dispatcher's decision-log append (``dispatch.log`` spans) over
its whole ``decide()`` (``dispatch.decide`` spans), in percent, over the
traced window."""

from portbench.metrics.program_spans import share_of_span


def read(obs):
    return share_of_span("dispatch.log", "dispatch.decide")
