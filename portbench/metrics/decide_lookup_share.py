"""The dispatcher's cache lookup (``dispatch.lookup`` spans: the input
guards, the cache generation, the communicator id, the key and the
cache's ``get``) over its whole ``decide()`` (``dispatch.decide``
spans), in percent, over the traced window."""

from portbench.metrics.program_spans import share_of_span


def read(obs):
    return share_of_span("dispatch.lookup", "dispatch.decide")
