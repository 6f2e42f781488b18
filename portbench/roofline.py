"""Frozen work counts of the port's kernels, and the card's peaks.

The counts are those of each kernel's algorithm at its stated precision,
read once from the plain PyTorch twin of each kernel (``chip_smoke.py``'s
``count_ops`` and ``nbytes``, :241-256, on the twins of
``akbx_torch/kernels``, as ``chip_smoke.py`` :1124-1129 and :896-901
call them) and frozen here, so that a later kernel is read against the
same work however it is written:

* operations: one per output element of an elementwise op and one per
  input element of a reduction, none for data movement or sign changes;
  a float32 ``two_prod`` counts 2 (a multiply and an FMA, as the kernels
  run it);
* bytes: every input read once and every output written once.

The least time of a call is the larger of its bytes over ``HBM_BPS`` and
its operations over ``F32_OPS``: the H100 SXM's published 3.35 TB/s and
67 TFLOP/s of float32 outside the tensor cores, an FMA counted once
(3.35e13 instructions a second).  These are the published peaks at the
full 700 W; every run prints the card's power limit beside them.
"""

HBM_BPS = 3.35e12
F32_OPS = 3.35e13

# K1, trace_deviation_kernel: the df32 bounce chain of one ray through
# ``m`` mirrors.  count_ops on trace_deviation_reference read 4,288
# operations a ray at 2 mirrors (KB7) and 8,572 at 4 (Wolter III+I): 2,142
# a mirror and 4 besides.  Bytes: the f64 deviations of origin and
# direction in (2 x 3 x 8), and out 4 bytes for each of 3m + 3m + 3m + 3m
# (point and direction hi/lo words), m + m (leg lengths hi/lo), the two
# OPL words and the valid flag.
K1_OPS_PER_MIRROR = 2142
K1_OPS_BASE = 4


def k1_ops(n_rays: int, mirrors: int) -> int:
    return n_rays * (K1_OPS_PER_MIRROR * mirrors + K1_OPS_BASE)


def k1_bytes(n_rays: int, mirrors: int) -> int:
    return n_rays * (48 + 4 * (14 * mirrors + 3))


# K2, detector_kernel: two detector planes a ray; 1,582 operations and
# 168 bytes a ray: in 56 (the exit point's and direction's deviations as
# hi/lo f32 words, 4 x 3 x 4, and the two OPL words), out 112 (its eight
# f32 outputs, 2 x 2 x 3 + 4 x 3 + 2 x 2 words).
K2_OPS = 1582
K2_BYTES = 168


def k2_ops(n_rays: int) -> int:
    return n_rays * K2_OPS


def k2_bytes(n_rays: int) -> int:
    return n_rays * K2_BYTES


# K3, huygens_kernel: one source-target pair of the df32 Huygens sum
# (r and k r in df32, an f32 sincos, f32 accumulation): 266 operations.
# Bytes: each target's df32 position (6 x 4) read and its f32 (re, im)
# written (2 x 4); each source's df32 position (6 x 4) and f32 weight
# (2 x 4) read.
K3_OPS_PER_PAIR = 266


def k3_ops(n_targets: int, n_sources: int) -> int:
    return n_targets * n_sources * K3_OPS_PER_PAIR


def k3_bytes(n_targets: int, n_sources: int) -> int:
    return n_targets * 32 + n_sources * 32


def bound_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time of a call on one card."""
    return max(n_bytes / HBM_BPS, n_ops / F32_OPS)


def k1_seconds(n_rays: int, mirrors: int) -> float:
    return bound_seconds(k1_bytes(n_rays, mirrors), k1_ops(n_rays, mirrors))


def k2_seconds(n_rays: int) -> float:
    return bound_seconds(k2_bytes(n_rays), k2_ops(n_rays))


def k3_seconds(n_targets: int, n_sources: int) -> float:
    return bound_seconds(k3_bytes(n_targets, n_sources),
                         k3_ops(n_targets, n_sources))
