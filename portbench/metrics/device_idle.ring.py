"""device_idle.ring: the device's idle share (%) of the ring's profiled
window, on the busiest card."""

from portbench.metrics._common import idle_share


def read(rec):
    return idle_share(rec)
