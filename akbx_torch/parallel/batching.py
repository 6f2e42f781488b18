"""Streamed giant-fan tracing (port of :mod:`akbx.parallel.batching`;
BASELINE config 5: 1e9 rays).

A 1e9-ray fan does not fit the card as one batch (each per-ray f64 array
is 8 GB).  Row blocks of the fan stream through the f64 trace and reduce
to mergeable sufficient statistics on the device, so no per-ray array of
the whole fan ever exists.  With a mesh, each block is sharded over the
ranks and its statistics are summed over them before the merge.

Statistics per block: valid count, spot centroid and second moments on
the focal plane, OPL sums (pivot-shifted by the plane's x), min/max
extents.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from akbx_torch import trace as tr
from akbx_torch.parallel import sharding as sh


class SpotStats(NamedTuple):
    """Mergeable sufficient statistics of a ray batch (f64 tensors)."""

    n: torch.Tensor          # valid-ray count
    sum_yz: torch.Tensor     # (2,) detector y/z sums
    sumsq_yz: torch.Tensor   # (2,) detector y/z squared sums
    sum_opl: torch.Tensor    # OPL sums, pivot-shifted by det_x (a ~146 m
    sumsq_opl: torch.Tensor  # path squared in f64 would drown the ~1e-4 std)
    min_yz: torch.Tensor     # (2,)
    max_yz: torch.Tensor     # (2,)

    @staticmethod
    def zero(device=None) -> "SpotStats":
        def full(shape, v):
            return torch.full(shape, v, dtype=torch.float64, device=device)

        return SpotStats(full((), 0.0), full((2,), 0.0), full((2,), 0.0),
                         full((), 0.0), full((), 0.0), full((2,), math.inf),
                         full((2,), -math.inf))

    def merge(self, other: "SpotStats") -> "SpotStats":
        return SpotStats(self.n + other.n,
                         self.sum_yz + other.sum_yz,
                         self.sumsq_yz + other.sumsq_yz,
                         self.sum_opl + other.sum_opl,
                         self.sumsq_opl + other.sumsq_opl,
                         torch.minimum(self.min_yz, other.min_yz),
                         torch.maximum(self.max_yz, other.max_yz))

    @property
    def centroid(self):
        return self.sum_yz / torch.clamp_min(self.n, 1.0)

    @property
    def spot_std(self):
        m = self.centroid
        var = self.sumsq_yz / torch.clamp_min(self.n, 1.0) - m**2
        return torch.sqrt(torch.clamp_min(var, 0.0))

    @property
    def opl_std(self):
        m = self.sum_opl / torch.clamp_min(self.n, 1.0)
        var = self.sumsq_opl / torch.clamp_min(self.n, 1.0) - m**2
        return torch.sqrt(torch.clamp_min(var, 0.0))


def _block_stats(system, angles_h, angles_v, det_x, mesh=None) -> SpotStats:
    """Trace one (n_v_block x n_h) sub-fan (this rank's columns of it,
    with a mesh) and reduce it to :class:`SpotStats` over every rank.
    Rays with a NaN angle (the padded tail of the last block) are
    invalid."""
    n = angles_h.shape[0] * angles_v.shape[0]
    lo, hi = (0, n) if mesh is None else sh.shard_bounds(n, mesh)
    rays = tr.ray_fan(angles_h, angles_v, lo, hi)
    src = system.source[:, None].expand(3, hi - lo)
    result = tr.trace(system, rays, src)
    det = tr.detector_points(result, det_x)
    d_last = torch.sqrt(torch.sum((det - result.exit_points) ** 2, dim=0))
    opl = sum(result.segments) + d_last - det_x
    v = result.valid & torch.isfinite(rays).all(dim=0)
    w = v.to(det.dtype)
    yz_m = torch.where(v[None, :], det[1:3], 0.0)
    opl_m = torch.where(v, opl, 0.0)
    inf = math.inf
    # an inf column keeps an empty shard's extremes the identity
    pad = det.new_full((2, 1), inf)
    small = torch.cat([torch.where(v[None, :], det[1:3], inf), pad], dim=1)
    big = torch.cat([torch.where(v[None, :], det[1:3], -inf), -pad], dim=1)
    sums = torch.cat([torch.sum(w)[None], torch.sum(yz_m, dim=1),
                      torch.sum(yz_m**2, dim=1), torch.sum(opl_m)[None],
                      torch.sum(opl_m**2)[None]])
    sums = sh.all_sum(sums, mesh)
    return SpotStats(sums[0], sums[1:3], sums[3:5], sums[5], sums[6],
                     sh.rank_min(small.amin(dim=1), mesh),
                     sh.rank_max(big.amax(dim=1), mesh))


def trace_streamed(system, n_h: int, n_v: int, defocus,
                   block_rows: int = 1024, mesh=None,
                   progress=None) -> SpotStats:
    """Trace an ``n_h x n_v`` fan of any size in blocks of ``block_rows``
    rows (``block_rows * n_h`` rays each) through the f64 engine, without
    tilt removal or re-fan, and merge the blocks' statistics on the
    device.  With ``mesh`` (:func:`akbx_torch.parallel.sharding.ray_mesh`)
    each block is sharded over the ranks and the statistics come back
    replicated.  ``progress(done, n_blocks)`` is called after each block.

    1e9 rays = e.g. n_h = 31623 = n_v at block_rows*n_h ~ 3e7 per block.
    """
    angles_h = tr.fan_angles(system.fan_h, n_h)
    det_x = system.s2f_middle + defocus
    # Row angles must be bit-identical to the unstreamed fan: the grazing
    # 4-bounce trace amplifies a 1-ulp angle difference by ~1e8.  Slice
    # the one linspace instead of recomputing it per block.
    angles_v_full = tr.fan_angles(system.fan_v, n_v)
    stats = SpotStats.zero(angles_h.device)
    n_blocks = -(n_v // -block_rows)
    for b in range(n_blocks):
        r0 = b * block_rows
        r1 = min(n_v, r0 + block_rows)
        angles_v = angles_v_full[r0:r1]
        if r1 - r0 < block_rows:  # every block the same shape
            angles_v = torch.cat([angles_v, angles_v.new_full(
                (block_rows - (r1 - r0),), math.nan)])
        stats = stats.merge(_block_stats(system, angles_h, angles_v, det_x,
                                         mesh))
        if progress is not None:
            progress(b + 1, n_blocks)
    return stats
