"""2D Legendre aberration decomposition (port of
:mod:`akbx.analysis.legendre`): project a wavefront map onto the outer
products P_ny(y) x P_nx(x) over the triangular order set
{(nx, ny): nx + ny < order}, each normalized by the root of its discrete
sum of squares, NaN-aware and differentiable."""

from __future__ import annotations

import torch

from akbx_torch.utils import linspace


def legendre_1d(x: torch.Tensor, order: int) -> torch.Tensor:
    """P_0..P_{order-1}(x), shape (order,) + x.shape (recurrence)."""
    outs = [torch.ones_like(x)]
    if order > 1:
        outs.append(x)
    for n in range(1, order - 1):
        outs.append(((2 * n + 1) * x * outs[n] - n * outs[n - 1]) / (n + 1))
    return torch.stack(outs)


def component(shape, nx: int, ny: int, device=None) -> torch.Tensor:
    """outer(P_ny(y), P_nx(x)) on the [-1, 1]^2 grid of ``shape``; as the
    reference, x runs over ``shape[0]`` and y over ``shape[1]``."""
    like = torch.empty(0, device=device)
    x = linspace(-1.0, 1.0, shape[0], like=like)
    y = linspace(-1.0, 1.0, shape[1], like=like)
    Px = legendre_1d(x, nx + 1)[nx]
    Py = legendre_1d(y, ny + 1)[ny]
    return torch.outer(Py, Px)


def _unit_component(shape, nx, ny, device):
    Z = component(shape, nx, ny, device)
    return Z / torch.sqrt(torch.nansum(Z * Z))


def match(data: torch.Tensor, nx: int, ny: int):
    """Project data onto one normalized Legendre mode.
    Returns (fit_map, inner_product)."""
    Z = _unit_component(data.shape, nx, ny, data.device)
    ip = torch.nansum(torch.where(torch.isfinite(data), Z * data, 0.0))
    return ip * Z, ip


def triangular_orders(order: int):
    """[(ny, nx)] with nx + ny < order, in the reference's order."""
    return [(i - j, j) for i in range(order) for j in range(order) if j <= i]


def match_multi(data: torch.Tensor, order: int):
    """All modes with nx + ny < order.
    Returns (fit_maps (n, H, W), inner_products (n,), orders [(ny, nx)])."""
    orders = triangular_orders(order)
    maps, ips = zip(*(match(data, nx, ny) for ny, nx in orders))
    return torch.stack(maps), torch.stack(ips), orders


def mode_map(inner_product, order_ny_nx, size: int = 129) -> torch.Tensor:
    """Reconstruct a single mode at a given size."""
    ny, nx = order_ny_nx
    ip = torch.as_tensor(inner_product, dtype=torch.float64)
    return ip * _unit_component((size, size), nx, ny, ip.device)


def mode_pvs(fit_maps: torch.Tensor, inner_products: torch.Tensor
             ) -> torch.Tensor:
    """Signed PV per mode (max - min over the finite entries)."""
    nan = torch.isnan(fit_maps)
    hi = torch.where(nan, -float("inf"), fit_maps).amax(dim=(1, 2))
    lo = torch.where(nan, float("inf"), fit_maps).amin(dim=(1, 2))
    return (hi - lo) * torch.sign(inner_products)


def fit_sum(fit_maps: torch.Tensor) -> torch.Tensor:
    return torch.sum(fit_maps, dim=0)
