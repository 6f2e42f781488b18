"""trace_bwd_ms.align: the median milliseconds of the span ``trace_bwd``."""

from portbench.metrics._common import span_median


def read(rec):
    return span_median(rec, "trace_bwd")
