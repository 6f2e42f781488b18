"""stage_ms.wave: the median milliseconds of the span ``stage``."""

from portbench.metrics._common import span_median


def read(rec):
    return span_median(rec, "stage")
