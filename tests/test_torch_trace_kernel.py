"""Parity of the K1/K2 twins and constant tables of
akbx_torch.kernels.trace_kernel with akbx.kernels.trace_kernel.

The constants are those of the port's placed Wolter III+I system; the
deviations are a 9x9 fan's, and one seeded random set of the same scale.
Both packages get the same numpy inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from akbx.kernels import trace_kernel as jtk
from akbx_torch import trace as ttr
from akbx_torch.kernels import trace_kernel as ttk
from akbx_torch.systems import AlignParams, WOLTER_3_1_DEFAULT, build_wolter_3_1

torch.set_num_threads(2)

N_MIRR = 4
# every output plane, as hi + lo in f64: <= 1e-11 of the plane's largest
# magnitude.  The twins run the same df32 operations in the same order;
# what may differ is XLA contracting a non-EFT mul+add (df_mul's cross
# term) and the f32 rsqrt first guess, both far below this bar.
PLANE_REL = 1e-11


@pytest.fixture(scope="module")
def chief():
    s = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.zeros("cpu"))
    n = 9
    rays = ttr.ray_fan(ttr.fan_angles(s.fan_h, n), ttr.fan_angles(s.fan_v, n))
    src = s.source[:, None].expand(3, n * n)
    chief_d0, chief_p0, consts64 = ttr._fast_scalars(s, rays, src,
                                                     n * n // 2)
    return rays, src, chief_d0, chief_p0, consts64


@pytest.fixture(scope="module", params=["fan", "random"])
def deviations(request, chief):
    rays, src, chief_d0, chief_p0, _ = chief
    dd = rays - chief_d0
    dp = src - chief_p0
    if request.param == "random":
        rng = np.random.default_rng(7)
        scale = dd.abs().amax(dim=1, keepdim=True).numpy()
        dd = torch.from_numpy(rng.uniform(-1, 1, dd.shape) * scale)
        dp = torch.from_numpy(rng.normal(0, 1e-6, dp.shape))
    return dp.contiguous(), dd.contiguous()


def _consts(consts64):
    (Ms, bvecs, Ds, Dns, Ts, A, Bp, rho, gC, gA, br, Ps) = consts64
    return (Ms, gC, gA, Ds, Dns, Ts, A, Bp, rho, br, bvecs)


def _assert_planes(t_pairs, j_pairs):
    """Each (hi, lo) output of the contract, against the output's largest
    magnitude (a single row can be pure rounding noise: ddet's x row is
    ~1e-16 m on the plane x = x_det by construction)."""
    for (th, tl), (jh, jl) in zip(t_pairs, j_pairs):
        t = th.double().numpy() + tl.double().numpy()
        j = np.asarray(jh, dtype=np.float64) + np.asarray(jl, np.float64)
        err = np.abs(t - j).max()
        assert err <= PLANE_REL * np.abs(j).max(), err


def test_pack_consts_bit_identical(chief):
    args = _consts(chief[4])
    t = ttk.pack_consts(*args)
    j = jtk.pack_consts(*[jnp.asarray(a.numpy()) for a in args])
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_pack_det_consts_bit_identical(chief):
    rng = np.random.default_rng(3)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    D4r = rng.normal(size=3)
    t_c, L = 0.2051234567891, 0.2101234567891
    t = ttk.pack_det_consts(*[torch.tensor(x, dtype=torch.float64)
                              for x in (R, D4r, t_c, L)])
    j = jtk.pack_det_consts(*[jnp.asarray(x) for x in (R, D4r, t_c, L)])
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.fixture(scope="module")
def k1_outputs(chief, deviations):
    consts = ttk.pack_consts(*_consts(chief[4]))
    dp, dd = deviations
    t = ttk.trace_deviation_reference(consts, dp, dd, N_MIRR)
    j = jtk.trace_deviation_reference(jnp.asarray(consts.numpy()),
                                      jnp.asarray(dp.numpy()),
                                      jnp.asarray(dd.numpy()), N_MIRR)
    return t, j


def test_bounce_twin_matches_akbx(k1_outputs):
    t, j = k1_outputs
    assert [tuple(x.shape) for x in t] == [tuple(x.shape) for x in j]
    np.testing.assert_array_equal(t[8].numpy(), np.asarray(j[8]))
    _assert_planes([(t[k], t[k + 1]) for k in range(0, 8, 2)],
                   [(j[k], j[k + 1]) for k in range(0, 8, 2)])


def test_detector_twin_matches_akbx(chief, k1_outputs):
    """The port's K2 twin takes both detector planes in one call; akbx
    calls its twin once per plane."""
    t1, _ = k1_outputs
    Dns = chief[4][3]
    rng = np.random.default_rng(5)
    R = torch.from_numpy(np.linalg.qr(rng.normal(size=(3, 3)))[0])
    rows = [(torch.tensor(v, dtype=torch.float64) for v in pair)
            for pair in ((0.2051234, 0.2069), (0.2061234, 0.2079))]
    consts = torch.cat([ttk.pack_det_consts(R, R @ Dns[-1], tc, L)
                        for tc, L in rows])
    ins = (t1[0][9:12], t1[1][9:12], t1[2][9:12], t1[3][9:12], t1[6], t1[7])
    t = ttk.detector_reference(consts, *ins)
    for p in range(2):
        j = jtk.detector_reference(jnp.asarray(consts[p:p + 1].numpy()),
                                   *[jnp.asarray(x.numpy()) for x in ins])
        _assert_planes([(t[0][p], t[1][p]), (t[2], t[3]), (t[4], t[5]),
                        (t[6][p], t[7][p])],
                       [(j[0], j[1]), (j[2], j[3]), (j[4], j[5]),
                        (j[6], j[7])])


def test_wrappers_take_the_twin_on_cpu(chief, deviations):
    """On CPU tensors the wrappers return the twins' results and launch
    nothing."""
    consts = ttk.pack_consts(*_consts(chief[4]))
    dp, dd = deviations
    before = (ttk.trace_deviation.launches, ttk.detector.launches)
    a = ttk.trace_deviation(consts, dp, dd, N_MIRR)
    b = ttk.trace_deviation_reference(consts, dp, dd, N_MIRR)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    dcon = torch.cat([consts[:1, :32], consts[1:2, :32]])
    ins = (a[0][9:12], a[1][9:12], a[2][9:12], a[3][9:12], a[6], a[7])
    for x, y in zip(ttk.detector(dcon, *ins),
                    ttk.detector_reference(dcon, *ins)):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    assert (ttk.trace_deviation.launches, ttk.detector.launches) == before


def test_wrappers_reject_other_devices(chief):
    consts = ttk.pack_consts(*_consts(chief[4])).to("meta")
    d = torch.zeros(3, 8, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        ttk.trace_deviation(consts, d, d, N_MIRR)
