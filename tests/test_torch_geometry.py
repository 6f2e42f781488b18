"""Parity of akbx_torch.core.geometry and akbx_torch.core.quadric_df with
their akbx counterparts, on inputs made from a numpy seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from akbx.core import geometry as jgeo
from akbx.core import precision as jpr
from akbx.core import quadric_df as jqdf
from akbx_torch.core import geometry as tgeo
from akbx_torch.core import precision as tpr
from akbx_torch.core import quadric_df as tqdf

torch.set_num_threads(2)

# plain-f64 geometry: both packages evaluate the same formulas, but matrix
# products and reductions may round in another order (BLAS vs XLA), so
# values agree to a few ulp of their scale, not bit for bit
F64_REL = 1e-13


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float64))


def _close(t, j, rel=F64_REL):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * np.abs(j).max())


@pytest.fixture(scope="module")
def quadric():
    """A placed-looking ellipse: the canonical conic shifted by 73 m and
    tilted, so its coefficients span ~1e-4..1e4 like the real mirrors."""
    c = np.array([1 / 73.1**2, 1 / 0.52**2, 0, 0, 0, 0, 0, 0, 0, -1.0])
    c = jgeo.shift(jnp.asarray(c), jnp.asarray([73.1, 0.0, 0.0]))
    c, _ = jgeo.rotate_about_axis(c, jnp.asarray([0.0, 0.0, 1.0]), 1.4e-4,
                                  jnp.zeros(3))
    return np.asarray(c)


@pytest.fixture(scope="module")
def fan(quadric):
    """Seeded rays from the origin towards the mirror, and their hits."""
    rng = np.random.default_rng(0)
    d = np.stack([np.ones(64), rng.uniform(-1e-3, 1e-3, 64),
                  rng.uniform(-1e-3, 1e-3, 64)])
    d /= np.linalg.norm(d, axis=0)
    o = np.zeros((3, 64))
    return d, o


def test_quadric_matrix_roundtrip(quadric):
    M = tgeo.quadric_matrix(_t(quadric))
    _close(M, jgeo.quadric_matrix(jnp.asarray(quadric)), 0.0)
    _close(tgeo.matrix_to_coeffs(M), quadric, 0.0)


@pytest.mark.parametrize("kind", ["shift", "shift_xyz", "rotate",
                                  "transform"])
def test_coefficient_transforms(quadric, kind):
    rng = np.random.default_rng(1)
    t = rng.normal(0, 50, 3)
    axis = rng.normal(0, 1, 3)
    theta = 3e-3
    if kind == "shift":
        j = jgeo.shift(jnp.asarray(quadric), jnp.asarray(t))
        t_ = tgeo.shift(_t(quadric), _t(t))
    elif kind == "shift_xyz":
        j, t_ = jnp.asarray(quadric), _t(quadric)
        for k, name in enumerate("xyz"):
            j = getattr(jgeo, f"shift_{name}")(j, jnp.asarray(t[k]))
            t_ = getattr(tgeo, f"shift_{name}")(t_, _t(t[k]))
    elif kind == "rotate":
        j, jR = jgeo.rotate_about_axis(jnp.asarray(quadric), jnp.asarray(axis),
                                       theta, jnp.asarray(t))
        t_, tR = tgeo.rotate_about_axis(_t(quadric), _t(axis),
                                        _t(theta), _t(t))
        _close(tR, jR)
    else:
        R = np.asarray(jgeo.rodrigues(jnp.asarray(axis), theta))
        j = jgeo.transform_quadric(jnp.asarray(quadric), jnp.asarray(R),
                                   jnp.asarray(t))
        t_ = tgeo.transform_quadric(_t(quadric), _t(R), _t(t))
    _close(t_, j, 1e-12)


def test_batched_transforms_match_single(quadric):
    """A leading batch dim gives the per-mirror results (to the rounding
    of a batched vs a single 4x4 matrix product)."""
    rng = np.random.default_rng(2)
    q = np.stack([quadric * (1 + 0.1 * k) for k in range(4)])
    axes = rng.normal(0, 1, (4, 3))
    thetas = rng.normal(0, 1e-3, 4)
    centers = rng.normal(0, 10, (4, 3))
    batched, Rb = tgeo.rotate_about_axis(_t(q), _t(axes), _t(thetas),
                                         _t(centers))
    for k in range(4):
        single, R = tgeo.rotate_about_axis(_t(q[k]), _t(axes[k]),
                                           _t(thetas[k]), _t(centers[k]))
        _close(batched[k], single.numpy())
        _close(Rb[k], R.numpy())


@pytest.mark.parametrize("branch", [1, -1])
def test_intersect_normal_reflect(quadric, fan, branch):
    d, o = fan
    jp, jt, jv = jgeo.intersect(jnp.asarray(quadric), jnp.asarray(d),
                                jnp.asarray(o), branch=branch)
    tp, tt, tv = tgeo.intersect(_t(quadric), _t(d), _t(o), branch=branch)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(tp, jp)
    _close(tt, jt)
    jn = jgeo.surface_normal(jnp.asarray(quadric), jp)
    tn = tgeo.surface_normal(_t(quadric), tp)
    _close(tn, jn, 1e-11)  # normals inherit the points' rounding x |grad|
    _close(tgeo.reflect(_t(d), tn), jgeo.reflect(jnp.asarray(d), jn), 1e-11)


def test_planes_and_rotations(fan):
    d, o = fan
    pts = o + 146.0 * d
    x = 146.2
    jd = jgeo.plane_intersect(jgeo.detector_plane(x), jnp.asarray(d),
                              jnp.asarray(pts))
    td = tgeo.plane_intersect(tgeo.detector_plane(_t(x)), _t(d), _t(pts))
    _close(td, jd)
    ty, tz = 2.4e-1, -7.7e-1
    _close(tgeo.rotate_vectors_yz(_t(d), _t(ty), _t(tz)),
           jgeo.rotate_vectors_yz(jnp.asarray(d), ty, tz))
    piv = np.array([146.19, 1e-3, -2e-3])
    _close(tgeo.rotate_points_about(_t(pts), _t(piv), _t(ty), _t(tz)),
           jgeo.rotate_points_about(jnp.asarray(pts), jnp.asarray(piv),
                                    ty, tz))
    _close(tgeo.normalize(_t(pts)), jgeo.normalize(jnp.asarray(pts)))


def test_quadric_eval(quadric, fan):
    """Points of the quadric evaluate to 0 within akbx's bar (1e-9,
    tests/test_geometry.py); at seeded points off it, the two packages
    agree to the rounding of the 10-term sum."""
    d, o = fan
    pts, _, valid = tgeo.intersect(_t(quadric), _t(d), _t(o))
    on = tgeo.quadric_eval(_t(quadric), pts)
    assert bool(valid.all()) and float(on.abs().max()) < 1e-9
    off = np.random.default_rng(4).normal(0, 1, (3, 50)) * [[50], [1], [1]]
    _close(tgeo.quadric_eval(_t(quadric), _t(off)),
           jgeo.quadric_eval(jnp.asarray(quadric), jnp.asarray(off)))


def test_tangent_and_curvature(quadric, fan):
    d, o = fan
    jp = jgeo.intersect(jnp.asarray(quadric), jnp.asarray(d),
                        jnp.asarray(o))[0]
    args_j = (jnp.asarray(quadric), jnp.asarray(d), jp)
    args_t = (_t(quadric), _t(d), _t(np.asarray(jp)))
    _close(tgeo.tangent(*args_t), jgeo.tangent(*args_j), 1e-11)
    _close(tgeo.curvature(*args_t), jgeo.curvature(*args_j), 1e-11)


def test_point_rotations(fan):
    """rotate_points (with and without a centre) and point_rotate_x/y/z,
    with the reference's -theta convention."""
    d, o = fan
    pts = o + 146.0 * d
    R = np.asarray(jgeo.rodrigues(jnp.asarray([0.3, -1.0, 0.2]), 2e-3))
    c = np.array([146.0, 1e-3, -2e-3])
    _close(tgeo.rotate_points(_t(pts), _t(R)),
           jgeo.rotate_points(jnp.asarray(pts), jnp.asarray(R)))
    _close(tgeo.rotate_points(_t(pts), _t(R), _t(c)),
           jgeo.rotate_points(jnp.asarray(pts), jnp.asarray(R),
                              jnp.asarray(c)))
    for name in ("point_rotate_x", "point_rotate_y", "point_rotate_z"):
        _close(getattr(tgeo, name)(_t(pts), 3.1e-3, c),
               getattr(jgeo, name)(jnp.asarray(pts), 3.1e-3,
                                   jnp.asarray(c)))


def test_grid_on_mirror(quadric):
    """A 7 x 5 bilinear grid between four corners near the mirror,
    projected onto it along -x."""
    corners = np.array([[146.2, 146.3, 146.3, 146.2],
                        [-1e-3, -1e-3, 1e-3, 1e-3],
                        [0.02, 0.021, 0.021, 0.02]])
    t = tgeo.grid_on_mirror(_t(quadric), _t(corners), 7, 5)
    j = jgeo.grid_on_mirror(jnp.asarray(quadric), jnp.asarray(corners), 7, 5)
    assert t.shape == (3, 35)
    _close(t, j)
    assert float(tgeo.quadric_eval(_t(quadric), t).abs().max()) < 1e-9


def test_branch_sign():
    from akbx.surfaces import branch_sign as jbs
    from akbx_torch.surfaces import branch_sign as tbs

    for negative in (True, False):
        t = tbs(negative, device="cpu")
        assert t.dtype == torch.float64
        assert float(t) == float(jbs(negative))


# --- double-f64 placement ------------------------------------------------
# The DF chains keep ~32 digits; their f64 views agree to ~1 ulp of the
# largest coefficient (the last rounding is the only one that may differ).
DF_REL = 1e-15


@pytest.mark.parametrize("kind", ["shift", "shift_x", "rotate"])
def test_qdf_transforms(quadric, kind):
    rng = np.random.default_rng(3)
    t = rng.normal(0, 50, 3)
    axis = rng.normal(0, 1, 3)
    jq = jqdf.QDF.from_f64(jnp.asarray(quadric))
    tq = tqdf.QDF.from_f64(_t(quadric))
    if kind == "shift":
        j, t_ = jqdf.shift(jq, jnp.asarray(t)), tqdf.shift(tq, _t(t))
    elif kind == "shift_x":
        j, t_ = jqdf.shift_x(jq, t[0]), tqdf.shift_x(tq, _t(t[0]))
    else:
        j, _ = jqdf.rotate_about_axis(jq, jnp.asarray(axis), 2e-3,
                                      jnp.asarray(t))
        t_, _ = tqdf.rotate_about_axis(tq, _t(axis), _t(2e-3), _t(t))
    _close(t_.to_f64(), j.to_f64(), DF_REL)


def test_qdf_trig():
    """Small-angle double-word sin/cos/asin agree to 1e-18 relative.  The
    bar is set by akbx's own df_asin, which is off by ~1.4e-19 rad at
    0.24 rad against a 50-digit mpmath value (the port: ~2e-22); sin and
    cos agree to the last bit."""
    x = np.array([5.5e-5, 1.4e-4, 0.11, 0.24, 0.33])
    jx = jpr.DF(jnp.asarray(x), jnp.zeros(5))
    tx = tpr.DF(_t(x), torch.zeros(5, dtype=torch.float64))
    for name in ("df_sin_small", "df_cos_small", "df_asin"):
        j = getattr(jqdf, name)(jx)
        t = getattr(tqdf, name)(tx)
        rel = np.abs((t.hi.numpy() - np.asarray(j.hi))
                     + (t.lo.numpy() - np.asarray(j.lo))) / np.abs(j.hi)
        assert rel.max() < 1e-18, (name, rel.max())


def test_wolter_iii_angles_df():
    """The DF layout angle chain, batched over two edge angles."""
    from akbx.systems import WOLTER_3_1_DEFAULT as S

    th = np.array([5.2e-5, 5.9e-5])
    args = (S.a_hyp_v, S.b_hyp_v, S.a_ell_v, S.b_ell_v)
    t_all = tqdf.wolter_iii_angles_df(*args, _t(th))
    for k in range(2):
        j_all = jqdf.wolter_iii_angles_df(*args, th[k])
        for j, t in zip(j_all, t_all):
            got = t.hi[k].item() + t.lo[k].item()
            want = float(j.hi) + float(j.lo)
            assert abs(got - want) <= 1e-18, (k, got, want)
