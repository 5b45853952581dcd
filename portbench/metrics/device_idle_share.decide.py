"""The device's idle share of the traced window, in percent: 1 less the
union of its busy intervals (kernels, copies, sets) over the window."""

from portbench.metrics.common import idle_share


def read(obs):
    return idle_share(obs)
