"""device_idle.wave: the device's idle share (%) of the profiled window, on the
busiest card."""

from portbench.metrics._common import idle_share


def read(rec):
    return idle_share(rec)
