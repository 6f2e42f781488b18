"""k1_roofline.align: K1's share (%) of its roofline, on the kernels named
``trace_deviation_kernel``."""

from portbench.metrics._common import roofline_share


def read(rec):
    return roofline_share(rec, "trace_deviation_kernel")
