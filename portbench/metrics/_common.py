"""What several metrics' readers share.  Each metric keeps a file of its
own, ``<metric>.py``, which names what it reads."""

import statistics


def span_median(rec, span: str):
    """The median milliseconds of ``span``, which the traced window
    records (CUDA events) around the program's layer; None where the run
    recorded none."""
    ms = rec["spans"].get(span)
    return statistics.median(ms) if ms else None


def idle_share(rec):
    """The device's idle share (%) of the profiled window on the busiest
    card: one less the union of its operations' intervals over the
    window's length."""
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_share"])


def roofline_share(rec, kernel: str):
    """``kernel``'s share (%) of its roofline: the least time of the
    profiled window's work of the kernel (``portbench.roofline``, frozen
    counts) over the device time of the kernels of that name there."""
    prof, bound = rec.get("profile"), rec.get("roofline", {}).get(kernel)
    if not prof or not bound:
        return None
    took = sum(s for name, s in prof["kernels"].items() if kernel in name)
    return 100.0 * bound / took if took > 0 else None
