"""align_step_p95_ms: the 95th percentile of the window's step times
(host clock, each step ending in a synchronize), in milliseconds."""

import numpy as np


def read(rec):
    steps = rec["step_s"]
    return float(np.percentile(steps, 95)) * 1e3 if steps else None
