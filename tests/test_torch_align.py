"""The rest of the trace and align layers against akbx at a 9x9 fan:
``compare_sep``, ``trace_pallas`` and the re-fanned fast run (held to
akbx's f64 engine at akbx's fast-vs-f64 bars), the ``trace_dev32`` JVP,
the Jacobian of ``build_wolter_3_1``, and the alignment solvers on
analytic metrics (``solve_alignment`` with a rank-deficient case,
``gradient_align``, ``shrink_search``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from akbx import align as jalign
from akbx import systems as jsys
from akbx import trace as jtr
from akbx_torch import align as talign
from akbx_torch import systems as tsys
from akbx_torch import trace as ttr

torch.set_num_threads(2)

N = 9
SEEDED = np.random.default_rng(1).normal(0.0, 1e-5, 26)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tbuild(vec):
    return tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                                 tsys.AlignParams.from_vector(vec))


@pytest.fixture(scope="module")
def akbx_f64():
    """akbx's f64 engine on the seeded system at 9x9: a trace of the
    uniform fan, a run without and one with the exit-pupil re-fan."""
    s = jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT,
                              jsys.AlignParams.from_vector(SEEDED))
    rays = jtr.ray_fan(jtr.fan_angles(s.fan_h, N), jtr.fan_angles(s.fan_v, N))
    tr = jtr.trace(s, rays, s.source[:, None] * jnp.ones((1, N * N)))
    flat = jtr.run(s, N, N, defocus=SEEDED[0], exit_pupil_uniform=False)
    refan = jtr.run(s, N, N, defocus=SEEDED[0], exit_pupil_uniform=True)
    sep = jalign.compare_sep(flat.trace, s.s2f_middle + SEEDED[0], N, N)
    return {"system": s, "trace": tr, "flat": flat, "refan": refan,
            "sep": np.asarray(sep.to_vector())}


def _port_trace(result):
    return ttr.TraceResult(*[tuple(_t(a) for a in f) for f in result[:4]],
                           _t(result.valid))


def test_compare_sep_matches_akbx(akbx_f64):
    """On akbx's own f64 trace carried over, the 12 slice metrics to
    1e-12 of each (the same f64 formulas); on the port's own f64 run,
    to 1e-8 of the focus positions, as the two traces agree to 1e-10 m
    and the closed-form focus divides that by ray slopes of ~0.05."""
    flat, j = akbx_f64["flat"], akbx_f64["sep"]
    x_ref = float(akbx_f64["system"].s2f_middle) + SEEDED[0]
    t = talign.compare_sep(_port_trace(flat.trace), torch.tensor(x_ref), N,
                           N).to_vector().numpy()
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-18)
    s = _tbuild(torch.tensor(SEEDED))
    r = ttr.run(s, N, N, defocus=torch.tensor(SEEDED[0]),
                exit_pupil_uniform=False)
    own = talign.compare_sep(r.trace, s.s2f_middle + SEEDED[0], N, N)
    np.testing.assert_allclose(own.to_vector().numpy(), j, rtol=0,
                               atol=1e-8)
    for mode, n in (("abrr", 6), ("KB", 3)):
        v = talign.aberration_vector(own, mode)
        assert v.shape == (n,)
        np.testing.assert_allclose(v.numpy(), np.asarray(
            jalign.aberration_vector(jalign.SepMetrics(*j), mode)),
            rtol=0, atol=1e-8)


def test_trace_pallas_matches_akbx(akbx_f64):
    """The port's fast trace (K1, its twin here) against akbx's f64 trace
    of the same fan: akbx's fast-vs-f64 bars (tests/test_trace_pallas.py):
    points 5e-9 m, normals (and the reflected directions) 1e-7, demeaned
    OPL 1e-9 m; valid equal."""
    j = akbx_f64["trace"]
    s = _tbuild(torch.tensor(SEEDED))
    rays = ttr.ray_fan(ttr.fan_angles(s.fan_h, N), ttr.fan_angles(s.fan_v, N))
    t = ttr.trace_pallas(s, rays, s.source[:, None].expand(3, N * N))
    assert t._result is None        # lazily materialized
    np.testing.assert_array_equal(_np(t.valid), np.asarray(j.valid))
    for i in range(4):
        np.testing.assert_allclose(_np(t.points[i]), np.asarray(j.points[i]),
                                   rtol=0, atol=5e-9)
        np.testing.assert_allclose(_np(t.normals[i]),
                                   np.asarray(j.normals[i]), rtol=0,
                                   atol=1e-7)
        np.testing.assert_allclose(_np(t.directions[i + 1]),
                                   np.asarray(j.directions[i + 1]), rtol=0,
                                   atol=1e-7)
    opl_t = _np(sum(t.segments))
    opl_j = np.asarray(sum(j.segments))
    np.testing.assert_allclose(opl_t - opl_t.mean(), opl_j - opl_j.mean(),
                               rtol=0, atol=1e-9)


def test_refan_fast_run_matches_akbx(akbx_f64):
    """run(exit_pupil_uniform=True, precision='pallas') against akbx's
    re-fanned f64 run: the fast pre-trace re-derives the source angles
    from exit angles without the f64 engine's rounding noise (ROADMAP
    F4), so the angles differ by that noise carried back through the
    fan's magnification (measured 6.9e-13 rad; bar 1e-11); then akbx's
    fast-vs-f64 bars: points (m1-m3) and detcenter 5e-9 m, demeaned OPL
    1e-9 m, tilt angles 2e-8 rad (ROADMAP F1); valid equal."""
    j = akbx_f64["refan"]
    s = _tbuild(torch.tensor(SEEDED))
    t = ttr.run(s, N, N, defocus=torch.tensor(SEEDED[0]),
                exit_pupil_uniform=True, precision="pallas")
    for f in ("rand_p0h", "rand_p0v"):
        np.testing.assert_allclose(_np(getattr(t, f)),
                                   np.asarray(getattr(j, f)), rtol=0,
                                   atol=1e-11)
    np.testing.assert_array_equal(_np(t.valid), np.asarray(j.valid))
    for i in range(3):
        np.testing.assert_allclose(_np(t.trace.points[i]),
                                   np.asarray(j.trace.points[i]), rtol=0,
                                   atol=5e-9)
    for f in ("detcenter", "detcenter2"):
        np.testing.assert_allclose(_np(getattr(t, f)),
                                   np.asarray(getattr(j, f)), rtol=0,
                                   atol=5e-9)
    for f in ("total_dist", "total_dist2"):
        a, b = _np(getattr(t, f)), np.asarray(getattr(j, f))
        np.testing.assert_allclose(a - a.mean(), b - b.mean(), rtol=0,
                                   atol=1e-9)
    for f in ("theta_y", "theta_z"):
        assert abs(float(getattr(t, f)) - float(getattr(j, f))) <= 2e-8


def _total(mod, fn, vec):
    """Sum of the per-ray OPL legs of a 5x5 fan under trace ``fn``."""
    tr = jtr if mod == "akbx" else ttr
    if mod == "akbx":
        s = jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT,
                                  jsys.AlignParams.from_vector(vec))
        src = s.source[:, None] * jnp.ones((1, 25))
    else:
        s = _tbuild(vec)
        src = s.source[:, None].expand(3, 25)
    rays = tr.ray_fan(tr.fan_angles(s.fan_h, 5), tr.fan_angles(s.fan_v, 5))
    return sum(fn(s, rays, src).segments)


def test_trace_dev32_jvp_matches_akbx_f64():
    """The plain-f32 twin linearizes like akbx's f64 engine: the JVP of
    the total OPL along hyp_V pitch, rtol 1e-3 and atol 3e-6 (akbx's own
    test_dev32_jacobian_matches_f64)."""
    e2 = np.zeros(26)
    e2[2] = 1.0
    f = jax.jit(lambda v: jax.jvp(lambda u: _total("akbx", jtr.trace, u),
                                  (v,), (jnp.asarray(e2),))[1])
    j = np.asarray(f(jnp.zeros(26)))
    _, t = torch.func.jvp(lambda v: _total("port", ttr.trace_dev32, v),
                          (torch.zeros(26, dtype=torch.float64),),
                          (torch.tensor(e2),))
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-3, atol=3e-6)


def test_build_jacobian_matches_akbx():
    """d(mirror coefficients)/d(26-vector) of build_wolter_3_1 at the
    seeded misalignment: the port's autograd against akbx's jax.jacfwd,
    each column (parameter) to 1e-9 of its largest entry; defocus
    (column 0) moves the detector, not the mirrors."""
    def jcoeffs(v):
        s = jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT,
                                  jsys.AlignParams.from_vector(v))
        return jnp.stack([m.coeffs for m in s.mirrors])

    j = np.asarray(jax.jit(jax.jacfwd(jcoeffs))(jnp.asarray(SEEDED)))
    t = torch.autograd.functional.jacobian(
        lambda v: torch.stack([m.coeffs for m in _tbuild(v).mirrors]),
        torch.tensor(SEEDED)).numpy()
    assert t.shape == j.shape == (4, 10, 26)
    t, j = t.reshape(40, 26), j.reshape(40, 26)
    scale = np.abs(j).max(axis=0)
    assert np.flatnonzero(scale == 0).tolist() == [0]
    np.testing.assert_array_equal(t[:, 0], 0.0)
    err = np.abs(t - j)[:, 1:] / scale[1:]
    assert err.max() <= 1e-9, err.max(axis=0)


# --- the solvers on analytic metrics ---------------------------------------

A = np.random.default_rng(12).normal(size=(4, 3))


def _metric(mod, rank_deficient):
    """A smooth nonlinear metric of parameters 2, 5 and 9 of the
    26-vector; rank-deficient: it sees 2 and 5 only through their sum."""
    lib = jnp if mod == "akbx" else torch
    a = lib.asarray(A) if mod == "akbx" else torch.tensor(A)

    def fn(v):
        x = lib.stack([v[2] + v[5], v[2] + v[5], v[9]]) if rank_deficient \
            else lib.stack([v[2], v[5], v[9]])
        return lib.tanh(a @ x + 0.1) + 0.05 * x[0] ** 2
    return fn


@pytest.mark.parametrize("rank_deficient", [False, True],
                         ids=["full_rank", "rank_deficient"])
def test_solve_alignment_matches_akbx(rank_deficient):
    """Two damped Newton steps: the port's SVD minimum-norm solve against
    akbx's lstsq(rcond=None), to 1e-12.  Rank-deficient, the two
    parameters the metric sees only through their sum move alike, and
    nothing else moves."""
    p0 = np.zeros(26)
    p0[[2, 5, 9]] = [0.3, -0.2, 0.1]
    idx = [2, 5, 9]
    j = np.asarray(jalign.solve_alignment(_metric("akbx", rank_deficient),
                                          jnp.asarray(p0), idx, iters=2,
                                          damping=0.7))
    t = talign.solve_alignment(_metric("port", rank_deficient),
                               torch.tensor(p0), idx, iters=2,
                               damping=0.7).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-12)
    moved = np.flatnonzero(t != p0)
    assert set(moved) <= set(idx) and len(moved) >= 2
    if rank_deficient:
        assert abs((t[2] - p0[2]) - (t[5] - p0[5])) <= 1e-12


def test_gradient_align_matches_akbx():
    """40 Adam steps on an analytic loss of the 26-vector over four free
    parameters: the port's torch.optim.Adam against akbx's optax.adam,
    to 1e-12 of the parameters' scale; the loss falls."""
    target = np.array([1e-4, -2e-4, 3e-5, 5e-5])
    free = [2, 8, 14, 20]

    def loss(lib, v):
        arr = jnp.asarray if lib is jnp else torch.tensor
        x = lib.stack([v[i] for i in free])
        weights = arr(np.array([1.0, 2.0, 3.0, 4.0]))
        return lib.sum((x - arr(target)) ** 2 * weights) + v[0] ** 2

    v0 = SEEDED.copy()
    j, jl = jalign.gradient_align(lambda v: loss(jnp, v), jnp.asarray(v0),
                                  free, steps=40, lr=1e-5)
    t, tl = talign.gradient_align(lambda v: loss(torch, v), torch.tensor(v0),
                                  free, steps=40, lr=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-16)
    assert float(tl) == pytest.approx(float(jl), rel=1e-10)
    np.testing.assert_array_equal(np.delete(t.numpy(), free),
                                  np.delete(v0, free))
    assert float(tl) < float(loss(torch, torch.tensor(v0)))


def test_shrink_search_matches_akbx():
    def f(x):
        return (x - 0.123456789) ** 2 + 1.0

    t = talign.shrink_search(f, -1.0, 1.0, num_steps=21, max_attempts=6)
    j = jalign.shrink_search(f, -1.0, 1.0, num_steps=21, max_attempts=6)
    assert t[0] == pytest.approx(j[0], abs=1e-15)
    assert t[1] == pytest.approx(j[1], abs=1e-15)
    assert abs(t[0] - 0.123456789) < 1e-6
