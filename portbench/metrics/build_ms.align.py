"""build_ms.align: the median milliseconds of the span ``build``."""

from portbench.metrics._common import span_median


def read(rec):
    return span_median(rec, "build")
