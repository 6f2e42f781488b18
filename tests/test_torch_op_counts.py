"""The operation counts behind the kernels' bounds, as ``chip_smoke.py``
counts them on the twins (on the CPU, at one pair / one ray): every f32
``two_prod`` counts as 2 (a multiply and an FMA, as the kernels run it),
whatever tensor passes the twin's detour through f64 takes.  The counts,
and so the bounds, are those of the Dekker-form twins before them."""

import pytest
import torch

import chip_smoke
from akbx_torch import trace
from akbx_torch.kernels import huygens as hk
from akbx_torch.kernels import trace_kernel as tk
from akbx_torch.systems import (AlignParams, WOLTER_3_1_DEFAULT,
                                WOLTER_3_3_TANDEM_DEFAULT, build_wolter_3_1,
                                build_wolter_3_3_tandem)

torch.set_num_threads(2)


def k1_inputs(s):
    """K1's arguments for one ray of a 5x5 fan through the placed system
    ``s``, and the chief's f64 outgoing direction after each mirror."""
    rays = trace.ray_fan(trace.fan_angles(s.fan_h, 5),
                         trace.fan_angles(s.fan_v, 5))
    n = rays.shape[1]
    src = s.source[:, None].expand(3, n)
    chief_d0, chief_p0, c64 = trace._fast_scalars(s, rays, src, n // 2)
    (Ms, bvecs, Ds, Dns, Ts, A, Bp, rho, gC, gA, br, _) = c64
    table = tk.pack_consts(Ms, gC, gA, Ds, Dns, Ts, A, Bp, rho, br, bvecs)
    return (table, (src - chief_p0)[:, 3:4].contiguous(),
            (rays - chief_d0)[:, 3:4].contiguous(), len(s.mirrors)), Dns


@pytest.fixture(scope="module")
def trace_inputs():
    """K1's and K2's arguments for one ray of a 5x5 fan (K2: two planes)."""
    dev = torch.device("cpu")
    s = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.zeros(dev))
    k1, Dns = k1_inputs(s)
    t1 = tk.trace_deviation_reference(*k1)
    R = torch.eye(3, dtype=torch.float64)
    planes = torch.cat([
        tk.pack_det_consts(R, Dns[-1], torch.tensor(t, dtype=torch.float64),
                           torch.tensor(t, dtype=torch.float64))
        for t in (0.2, 0.201)])
    k2 = (planes, t1[0][9:12], t1[1][9:12], t1[2][9:12], t1[3][9:12], t1[6],
          t1[7])
    return {"K1": (tk.trace_deviation_reference, k1),
            "K2": (tk.detector_reference, k2)}


@pytest.mark.parametrize("kernel,ops,two_prods", [
    ("K1", 8572, 4 * 77), ("K2", 1582, 18 + 2 * 17), ("K3", 266, 7)])
def test_operations_per_ray_or_pair(trace_inputs, kernel, ops, two_prods):
    if kernel == "K3":
        fn, args = hk.huygens_reference, (
            torch.zeros(6, 1), torch.ones(6, 1), torch.ones(2, 1),
            torch.ones(2))
    else:
        fn, args = trace_inputs[kernel]
    assert chip_smoke.count_ops(fn, *args) == (ops, two_prods)


def test_k1_operations_per_ray_on_the_tandem():
    """K1 on the Wolter III+III tandem's mirrors counts what it counts on
    III+I's: 2,142 operations a mirror and 4 more a ray, the frozen count
    that ``k1_roofline.align`` divides by at four mirrors."""
    s = build_wolter_3_3_tandem(WOLTER_3_3_TANDEM_DEFAULT,
                                AlignParams.zeros(torch.device("cpu")))
    k1, _ = k1_inputs(s)
    assert chip_smoke.count_ops(tk.trace_deviation_reference, *k1) == (
        4 * 2142 + 4, 4 * 77)


def test_counting_leaves_two_prod_in_place():
    from akbx_torch.core import precision

    before = precision.two_prod
    chip_smoke.count_ops(hk.huygens_reference, torch.zeros(6, 1),
                         torch.ones(6, 1), torch.ones(2, 1), torch.ones(2))
    assert precision.two_prod is before and hk.two_prod is before
    assert tk.two_prod is before
