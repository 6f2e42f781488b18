"""k3_roofline.wave: K3's share (%) of its roofline, on the kernels named
``huygens_kernel``."""

from portbench.metrics._common import roofline_share


def read(rec):
    return roofline_share(rec, "huygens_kernel")
