"""Figure errors in akbx_torch against akbx: ``calibrate_uv``,
``figure_height``, the figure branch of ``intersect_and_reflect``, and
``trace.run`` with figures on every engine route (all on the f64 engine:
K1 does not model figures, so those routes launch no kernel); akbx's two
differentiability tests, reproduced; and the figure state carried across
by ``convert``.  Fans are 5x5 to 9x9; figures are seeded 3x3 Legendre
fields of nm amplitude."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from akbx import surfaces as jsurf
from akbx import systems as jsys
from akbx import trace as jtr
from akbx_torch import convert
from akbx_torch import surfaces as tsurf
from akbx_torch import systems as tsys
from akbx_torch import trace as ttr

torch.set_num_threads(2)

N = 9
FIG = np.random.default_rng(7).normal(0.0, 1e-9, (4, 3, 3))
KB7 = (146.0, 0.21, 0.16742, 0.180, 0.030, 0.15525, 0.05)
BUILDERS = {
    "wolter_3_1": (lambda p: jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT, p),
                   lambda p: tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                                                   p)),
    "kb": (lambda p: jsys.build_kb(jsys.KBSpec.from_kb_define(*KB7), p),
           lambda p: tsys.build_kb(tsys.KBSpec.from_kb_define(
               *KB7, device="cpu"), p)),
    "tandem": (lambda p: jsys.build_wolter_3_3_tandem(
                   jsys.WOLTER_3_3_TANDEM_DEFAULT, p),
               lambda p: tsys.build_wolter_3_3_tandem(
                   tsys.WOLTER_3_3_TANDEM_DEFAULT, p)),
}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _calibrated(name):
    jb, tb = BUILDERS[name]
    return (jsys.calibrate_uv(jb(jsys.AlignParams.zeros())),
            tsys.calibrate_uv(tb(tsys.AlignParams.zeros("cpu"))))


def _with_figure(system, figs, mod):
    """``system`` with the figure field ``figs[i]`` on mirror i."""
    arr = jnp.asarray if mod == "akbx" else torch.from_numpy
    return system._replace(mirrors=tuple(
        m._replace(fig_coeffs=arr(f)) for m, f in zip(system.mirrors, figs)))


@pytest.fixture(scope="module")
def w31():
    """The calibrated zero-parameter Wolter III+I system of each package,
    bare and with the seeded figures."""
    j, t = _calibrated("wolter_3_1")
    return j, t, _with_figure(j, FIG, "akbx"), _with_figure(t, FIG, "port")


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_calibrate_uv_matches_akbx(name):
    """``uv_center`` and ``uv_half`` to 1e-10 m (footprints from f64 traces
    whose hit points agree to 1e-10 m, test_torch_trace.py), the axes to
    1e-12 with the same rows swapped; and akbx's footprint test: the
    traced footprint fills [-1, 1] in u and v on every mirror."""
    j, t = _calibrated(name)
    res = ttr.run(t, N, N, defocus=0.0, exit_pupil_uniform=False,
                  tilt_correction=False)
    raw = BUILDERS[name][1](tsys.AlignParams.zeros("cpu"))
    for tm, jm, rm, pts in zip(t.mirrors, j.mirrors, raw.mirrors,
                               res.trace.points):
        for f in ("uv_center", "uv_half"):
            np.testing.assert_allclose(_np(getattr(tm, f)),
                                       np.asarray(getattr(jm, f)), rtol=0,
                                       atol=1e-10)
        np.testing.assert_allclose(_np(tm.axes), np.asarray(jm.axes),
                                   rtol=0, atol=1e-12)
        swapped = not torch.equal(tm.axes, rm.axes)
        if swapped:
            assert torch.equal(tm.axes, rm.axes[[0, 2, 1]])
        local = _np(tm.axes @ (pts - tm.center[:, None]))
        u = (local[0] - float(tm.uv_center[0])) / float(tm.uv_half[0])
        v = (local[1] - float(tm.uv_center[1])) / float(tm.uv_half[1])
        for w in (u, v):
            assert -1.001 < w.min() and w.max() < 1.001
            assert w.max() - w.min() > 1.9


def test_figure_height_and_bounce_match_akbx(w31):
    """``figure_height`` and ``intersect_and_reflect`` with a figure, on
    each mirror of the calibrated system, given the same rays: heights to
    1e-6 of the largest (~1e-15 m of nm heights; the local coordinates
    come from f64 products that may round differently), points and
    segments to 1e-10 m, reflected directions and normals to 1e-12
    (test_torch_trace.py's f64 bars), valid identical."""
    _, _, jf, tf = w31
    rays = ttr.ray_fan(ttr.fan_angles(tf.fan_h, N), ttr.fan_angles(tf.fan_v, N))
    p = tf.source[:, None].expand(3, N * N)
    for tm, jm in zip(tf.mirrors, jf.mirrors):
        jr, jp = jnp.asarray(_np(rays)), jnp.asarray(_np(p))
        tout = tsurf.intersect_and_reflect(tm, rays, p)
        jout = jsurf.intersect_and_reflect(jm, jr, jp)
        h_t = tsurf.figure_height(tm, tout[0])
        h_j = jsurf.figure_height(jm, jnp.asarray(_np(tout[0])))
        assert np.abs(_np(h_t)).max() > 1e-10
        np.testing.assert_allclose(_np(h_t), np.asarray(h_j), rtol=0,
                                   atol=1e-6 * np.abs(np.asarray(h_j)).max())
        for a, b, bar in zip(tout, jout, (1e-10, 1e-12, 1e-12, 1e-10)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                       atol=bar)
        np.testing.assert_array_equal(_np(tout[4]), np.asarray(jout[4]))
        rays, p = tout[1], tout[0]


class _K1Calls:
    """Stands in for the trace module's handle on the kernel wrappers and
    counts K1's calls (its twin's here, on the CPU)."""

    def __init__(self, module):
        self._module = module
        self.calls = 0

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if name != "trace_deviation":
            return fn

        def counted(*args):
            self.calls += 1
            return fn(*args)

        return counted


def _demeaned(total, valid):
    total = _np(total)
    return total - total[_np(valid)].mean()


@pytest.mark.parametrize("precision", ["f64", "pallas", "df32"])
def test_run_with_figure_matches_akbx(w31, monkeypatch, precision):
    """``run`` with figures on every mirror, against akbx's run of the same
    route: detcenter to 1e-10 m and demeaned OPL to 1e-12 m (the f64
    engine's bars, test_torch_trace.py), valid identical.  Every route
    traces on the f64 engine: K1 is called 0 times (and once on the same
    system without figures at "pallas"); "df32" gives the f64 route's
    result exactly, "pallas" its sum in plain f64 (within 1e-12 m).  The
    figures move the wavefront by more than 1e-11 m."""
    j0, t0, jf, tf = w31
    calls = _K1Calls(ttr.tk)
    monkeypatch.setattr(ttr, "tk", calls)
    kw = dict(defocus=0.0, exit_pupil_uniform=False)
    t = ttr.run(tf, N, N, precision=precision, **kw)
    assert calls.calls == 0
    j = jtr.run(jf, N, N, precision=precision, **kw)
    np.testing.assert_array_equal(_np(t.valid), np.asarray(j.valid))
    assert bool(t.valid.all())
    np.testing.assert_allclose(_np(t.detcenter), np.asarray(j.detcenter),
                               rtol=0, atol=1e-10)
    w = _demeaned(t.total_dist, t.valid)
    np.testing.assert_allclose(w, _demeaned(j.total_dist, j.valid), rtol=0,
                               atol=1e-12)
    t64 = ttr.run(tf, N, N, **kw)
    if precision == "df32":
        assert torch.equal(t.total_dist, t64.total_dist)
    np.testing.assert_allclose(w, _demeaned(t64.total_dist, t64.valid),
                               rtol=0, atol=1e-12)
    bare = ttr.run(t0, N, N, precision=precision, **kw)
    assert calls.calls == (1 if precision == "pallas" else 0)
    assert np.abs(w - _demeaned(bare.total_dist, bare.valid)).max() > 1e-11


def test_single_bounce_grad_matches_fd(w31):
    """akbx's test_single_bounce_grad_matches_fd, on the port: the
    derivative of the reflected directions with respect to the (1, 0)
    mode (axial tilt) of mirror 1's figure, by autograd, against a
    central difference with a step of 1e-6 m, to 1e-5 of its largest
    entry + 1e-12; the response is O(1)."""
    _, t, _, _ = w31
    n = 5
    rays = ttr.ray_fan(ttr.fan_angles(t.fan_h, n), ttr.fan_angles(t.fan_v, n))
    src = t.source[:, None].expand(3, n * n)

    def refl_of(fig9):
        m0 = t.mirrors[0]._replace(fig_coeffs=fig9.reshape(3, 3))
        return tsurf.intersect_and_reflect(m0, rays, src)[1]

    e = torch.zeros(9, dtype=torch.float64)
    e[3] = 1.0
    delta = 1e-6
    fd = _np((refl_of(e * delta) - refl_of(-e * delta)) / (2 * delta))
    J = torch.autograd.functional.jacobian(
        refl_of, torch.zeros(9, dtype=torch.float64))
    ad = _np(J[..., 3])
    np.testing.assert_allclose(ad, fd, rtol=0,
                               atol=1e-5 * np.abs(fd).max() + 1e-12)
    assert np.abs(ad).max() > 0.1


def _figure_jacobian(system, n):
    """d(demeaned OPL)/d(mirror 1's 3x3 figure) through the full trace,
    by reverse mode: (n*n, 9)."""
    def w_of(fig9):
        m0 = system.mirrors[0]._replace(fig_coeffs=fig9.reshape(3, 3))
        res = ttr.run(system._replace(mirrors=(m0,) + system.mirrors[1:]),
                      n, n, defocus=0.0, exit_pupil_uniform=False)
        w = res.total_dist - ttr.masked_mean(res.total_dist, res.valid)
        return torch.where(res.valid, w, 0.0)

    return torch.autograd.functional.jacobian(
        w_of, torch.zeros(9, dtype=torch.float64,
                          device=system.s2f_middle.device))


def test_wavefront_jacobian_has_strong_modes(w31):
    """akbx's test_wavefront_jacobian_has_strong_modes, on the port at
    7x7: the figure -> wavefront Jacobian (reverse mode here, jacfwd
    there) has at least 3 singular values within 1 % of the largest, and
    the largest above 1 (metres of OPL per metre of coefficient)."""
    J = _np(_figure_jacobian(w31[1], 7))
    sv = np.linalg.svd(J, compute_uv=False)
    assert (sv > 1e-2 * sv[0]).sum() >= 3
    assert sv[0] > 1.0


def test_convert_carries_figure_state(w31):
    """akbx's calibrated system with figures, flattened to numpy and
    rebuilt by ``convert.system_from_numpy``: every Mirror field
    (``fig_coeffs``, ``uv_center``, ``uv_half``, the swapped ``axes``)
    arrives bit for bit, and the port's f64 run of it matches akbx's at
    the f64 bars (detcenter 1e-10 m, demeaned OPL 1e-12 m)."""
    _, _, jf, _ = w31
    fields = {
        "mirrors": [{k: np.asarray(getattr(m, k)) for k in jsurf.Mirror._fields}
                    for m in jf.mirrors],
        **{k: np.asarray(getattr(jf, k)) for k in
           ("s2f_middle", "fan_h", "fan_v", "source", "valid")}}
    t = convert.system_from_numpy(fields, device="cpu")
    for tm, jm in zip(t.mirrors, jf.mirrors):
        for k in jsurf.Mirror._fields:
            np.testing.assert_array_equal(_np(getattr(tm, k)),
                                          np.asarray(getattr(jm, k)))
    assert tuple(t.mirrors[0].fig_coeffs.shape) == (3, 3)
    kw = dict(defocus=0.0, exit_pupil_uniform=False)
    r, j = ttr.run(t, N, N, **kw), jtr.run(jf, N, N, **kw)
    np.testing.assert_allclose(_np(r.detcenter), np.asarray(j.detcenter),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(_demeaned(r.total_dist, r.valid),
                               _demeaned(j.total_dist, j.valid), rtol=0,
                               atol=1e-12)
