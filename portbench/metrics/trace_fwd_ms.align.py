"""trace_fwd_ms.align: the median milliseconds of the span ``trace_fwd``."""

from portbench.metrics._common import span_median


def read(rec):
    return span_median(rec, "trace_fwd")
