"""stage_ms.ring: the median milliseconds of the span ``stage`` on the
ring."""

from portbench.metrics._common import span_median


def read(rec):
    return span_median(rec, "stage")
