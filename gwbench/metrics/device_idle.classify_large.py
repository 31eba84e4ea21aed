"""device_idle: the share (%) of the traced slice in which no operation ran on
the card: 1 - (union of device intervals) / (slice wall time)."""
from gwbench.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
