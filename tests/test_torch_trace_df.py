"""The double-f32 deviation trace (``trace.trace_df``,
``run(precision="df32")``) and its arithmetic (``core.geometry_df``)
against akbx, against the port's f64 engine, and against an mpmath
oracle at 50 digits (the port's own copy of akbx's ``mp_opl``).  Fans
are 9x9 to 17x17, as in akbx's tests/test_trace_df.py, whose bars these
are."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from akbx import systems as jsys
from akbx import trace as jtr
from akbx.core import geometry_df as jgdf
from akbx.core.precision import DF as JDF
from akbx_torch import systems as tsys
from akbx_torch import trace as ttr
from akbx_torch.core import geometry_df as tgdf
from akbx_torch.core.precision import DF as TDF

torch.set_num_threads(2)

# the misaligned system of akbx's test_misaligned_system: defocus 1e-4,
# hyp_v pitch 1e-5, hyp_h roll 2e-5
MISALIGNED = np.zeros(26)
MISALIGNED[[0, 2, 9]] = (1e-4, 1e-5, 2e-5)
VECS = {"zero": np.zeros(26), "misaligned": MISALIGNED}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module", params=sorted(VECS))
def systems(request):
    vec = VECS[request.param]
    return (jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT,
                                  jsys.AlignParams.from_vector(vec)),
            tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                                  tsys.AlignParams.from_vector(vec,
                                                               device="cpu")),
            vec)


def fan(system, n):
    rays = ttr.ray_fan(ttr.fan_angles(system.fan_h, n),
                       ttr.fan_angles(system.fan_v, n))
    return rays, system.source[:, None].expand(3, n * n)


# --- geometry_df against akbx's, on seeded inputs --------------------------

def _f64(x):
    """An f64 array of a double-word (either package's) or a plain array."""
    if isinstance(x, (JDF, TDF)):
        return _np(x.hi).astype(np.float64) + _np(x.lo).astype(np.float64)
    return _np(x).astype(np.float64)


def _close(t, j, rel):
    """|port - akbx| <= rel x the largest |akbx| (elementwise arrays,
    double-words or Vec3DFs)."""
    if isinstance(t, tgdf.Vec3DF):
        for a, b in zip(t, j):
            _close(a, b, rel)
        return
    a, b = _f64(t), _f64(j)
    scale = np.abs(b).max()
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale)


def test_geometry_df_matches_akbx():
    """Every function of geometry_df on seeded data in the local frame of
    the first mirror (its coefficients shifted to its chief-ray center):
    a 9x9 fan from the source, against akbx's.  Bar 2^-44 of each output's
    largest value: both run the same double-f32 algebra (~2^-48), and
    their two_prod forms agree bit for bit on these normal products."""
    js = jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT, jsys.AlignParams.zeros())
    ts = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                               tsys.AlignParams.zeros("cpu"))
    m = ts.mirrors[0]
    rays, src = fan(ts, 9)
    local = ttr.geo.shift(m.coeffs, -m.center)
    o64 = (src - m.center[:, None]).contiguous()
    rel = 2.0 ** -44
    jrays = jgdf.Vec3DF.from_f64(jnp.asarray(_np(rays)))
    jorig = jgdf.Vec3DF.from_f64(jnp.asarray(_np(o64)))
    trays = tgdf.Vec3DF.from_f64(rays)
    torig = tgdf.Vec3DF.from_f64(o64)
    _close(trays, jrays, 0.0)
    _close(trays.dot(torig), jrays.dot(jorig), rel)
    _close(trays.normalize(), jrays.normalize(), rel)
    jl, tl = jnp.asarray(_np(local)), local
    jp, jt, jv = jgdf.intersect_df(jl, jrays, jorig, 1.0)
    tp, tt, tv = tgdf.intersect_df(tl, trays, torig, 1.0)
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    _close(tp, jp, rel)
    _close(tt, jt, rel)
    _close(tgdf.surface_normal_df(tl, tp), jgdf.surface_normal_df(jl, jp),
           rel)
    tn, jn = tgdf.surface_normal_df(tl, tp), jgdf.surface_normal_df(jl, jp)
    _close(tgdf.reflect_df(trays, tn), jgdf.reflect_df(jrays, jn), rel)
    M = np.random.default_rng(3).normal(size=(3, 3))
    tM, jM = tgdf.mat3_const(torch.from_numpy(M)), jgdf.mat3_const(
        jnp.asarray(M))
    _close(tgdf.matvec(tM, trays), jgdf.matvec(jM, jrays), rel)
    _close(tgdf.quadform(tM, trays), jgdf.quadform(jM, jrays), rel)
    _close(tgdf.vec3_const(torch.from_numpy(M[0]), (81,)).dot(trays),
           jgdf.vec3_const(jnp.asarray(M[0]), (81,)).dot(jrays), rel)
    x_plane = tgdf.split_f64(torch.tensor(0.2, dtype=torch.float64))
    jx_plane = jgdf.split_f64(jnp.float64(0.2))
    for a, b in zip(tgdf.plane_x_intersect_df(x_plane, trays, torig),
                    jgdf.plane_x_intersect_df(jx_plane, jrays, jorig)):
        _close(a, b, rel)
    rng = np.random.default_rng(4)
    A, B, C = (rng.normal(size=81) * s for s in (1e-3, 1.0, 1e-2))
    for a, b in zip(tgdf.solve_quadratic_df(
            *[tgdf.split_f64(torch.from_numpy(x)) for x in (A, B, C)]),
            jgdf.solve_quadratic_df(
            *[jgdf.split_f64(jnp.asarray(x)) for x in (A, B, C)])):
        _close(a, b, rel) if isinstance(a, TDF) else \
            np.testing.assert_array_equal(_np(a), np.asarray(b))


# --- trace_df ---------------------------------------------------------------

def test_trace_df_matches_akbx(systems):
    """The port's trace_df against akbx's at 17x17: points and segments to
    1e-10 m and exit directions to 1e-12, the f64 chief traces' parity
    bars (test_torch_trace.py; the deviations themselves agree to df32
    rounding), valid identical."""
    js, ts, _ = systems
    rays, src = fan(ts, 17)
    j = jtr.trace_df(js, jnp.asarray(_np(rays)), jnp.asarray(_np(src)))
    t = ttr.trace_df(ts, rays, src)
    np.testing.assert_array_equal(_np(t.valid), np.asarray(j.valid))
    for a, b in zip(t.points, j.points):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-10)
    for a, b in zip(t.segments, j.segments):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-10)
    for a, b in zip(t.directions, j.directions):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=1e-12)


def test_trace_df_matches_f64_within_f64_noise(systems):
    """akbx's test_matches_f64_within_f64_noise, on the port: trace_df
    against the port's f64 trace at 17x17, points and segments 2e-9 m
    (the f64 path's own grazing-amplified error); exit rays at akbx's
    bar as written there, 1e-10 plus assert_allclose's default 1e-7
    relative (the f64 trace's exit directions carry ~9e-9 of rounding on
    the last, steep bounce, in akbx as in the port)."""
    _, ts, _ = systems
    rays, src = fan(ts, 17)
    r64 = ttr.trace(ts, rays, src)
    rdf = ttr.trace_df(ts, rays, src)
    assert bool(rdf.valid.all())
    for a, b in zip(rdf.points, r64.points):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=2e-9)
    for a, b in zip(rdf.segments, r64.segments):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=2e-9)
    np.testing.assert_allclose(_np(rdf.exit_rays), _np(r64.exit_rays),
                               rtol=1e-7, atol=1e-10)


def mp_opl(d0, p0, mirrors, dps=50):
    """Arbitrary-precision OPL through the mirror chain (the oracle):
    exact quadric intersections and reflections at ``dps`` digits."""
    from mpmath import mp, mpf
    from mpmath import sqrt as msqrt

    mp.dps = dps
    d = [mpf(float(x)) for x in d0]
    p = [mpf(float(x)) for x in p0]
    nrm = msqrt(sum(x * x for x in d))
    d = [x / nrm for x in d]
    total = mpf(0)
    for m in mirrors:
        a, b, cc, dd_, e, f, g, h, i_, j = [mpf(float(x))
                                            for x in _np(m.coeffs)]
        l, mm, nn = d
        px, py, pz = p
        A = (a * l * l + b * mm * mm + cc * nn * nn + dd_ * mm * l
             + e * nn * l + f * mm * nn)
        B = (2 * a * px * l + 2 * b * py * mm + 2 * cc * pz * nn
             + dd_ * (px * mm + py * l) + e * (px * nn + pz * l)
             + f * (pz * mm + py * nn) + g * l + h * mm + i_ * nn)
        C = (a * px * px + b * py * py + cc * pz * pz + dd_ * px * py
             + e * px * pz + f * py * pz + g * px + h * py + i_ * pz + j)
        sq = msqrt(B * B - 4 * A * C)
        t = ((-B + sq) / (2 * A) if float(m.branch) >= 0
             else (-B - sq) / (2 * A))
        total += t
        p = [px + t * l, py + t * mm, pz + t * nn]
        gx = 2 * a * p[0] + dd_ * p[1] + e * p[2] + g
        gy = 2 * b * p[1] + dd_ * p[0] + f * p[2] + h
        gz = 2 * cc * p[2] + e * p[0] + f * p[1] + i_
        gn = msqrt(gx * gx + gy * gy + gz * gz)
        nx, ny, nz = gx / gn, gy / gn, gz / gn
        dot = d[0] * nx + d[1] * ny + d[2] * nz
        d = [d[0] - 2 * dot * nx, d[1] - 2 * dot * ny, d[2] - 2 * dot * nz]
    return total


def test_trace_df_beats_f64_against_mpmath_oracle(systems):
    """akbx's headline property, on the port: the demeaned OPL of trace_df
    is within 1e-12 m of the 50-digit oracle's, and under 0.05 of the f64
    trace's error, at every 8th ray of a 9x9 fan."""
    _, ts, _ = systems
    n = 9
    rays, src = fan(ts, n)
    r64 = ttr.trace(ts, rays, src)
    rdf = ttr.trace_df(ts, rays, src)
    idx = list(range(0, n * n, 8))
    ref = np.array([float(mp_opl(_np(rays[:, k]), _np(src[:, k]),
                                 ts.mirrors) - 146) for k in idx])
    o64 = _np(sum(r64.segments))[idx] - 146.0
    odf = _np(sum(rdf.segments))[idx] - 146.0
    e64 = (o64 - ref) - (o64 - ref).mean()
    edf = (odf - ref) - (odf - ref).mean()
    assert np.abs(edf).max() < 1e-12
    assert np.abs(edf).max() < 0.05 * np.abs(e64).max()


def test_run_df32_matches_akbx_and_f64(systems):
    """``run(precision="df32")`` at 17x17 with the re-fan and a 1e-2 m
    defocused plane (akbx's test_run_precision_df32): against the port's
    f64 engine, detcenter 1e-8 m and wave2 0.5 nm (akbx's bars); against
    akbx's df32 run, detcenter 1e-9 m and wave2 0.05 nm (the bars of
    test_torch_wave_io.py and test_torch_trace.py): the same engine
    on a system placed to 1e-12 m, whose re-fan maps exit angles with the
    f64 trace's rounding back to source angles (ROADMAP F4: up to ~1e-9
    m), valid identical."""
    js, ts, vec = systems
    kw = dict(defocus=vec[0], defocus_wave=1e-2)
    res64 = ttr.run(ts, 17, 17, **kw)
    resdf = ttr.run(ts, 17, 17, precision="df32", **kw)
    jdf = jtr.run(js, 17, 17, precision="df32", **kw)
    assert bool(resdf.valid.all())
    np.testing.assert_array_equal(_np(resdf.valid), np.asarray(jdf.valid))
    np.testing.assert_allclose(_np(resdf.detcenter), _np(res64.detcenter),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(resdf.wave2), _np(res64.wave2), rtol=0,
                               atol=0.5)
    np.testing.assert_allclose(_np(resdf.detcenter), np.asarray(jdf.detcenter),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(resdf.wave2), np.asarray(jdf.wave2),
                               rtol=0, atol=0.05)


def test_run_df32_differentiates():
    """The df32 engine under autograd (akbx's test_df32_differentiates):
    the spot-size loss's gradient with respect to the 26-vector is finite
    and non-zero, and within 1e-3 of the f64 engine's (floor 1e-6 of the
    largest component, the bar of test_torch_backward.py)."""
    def grad(precision):
        v = torch.tensor(MISALIGNED, requires_grad=True)
        s = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                                  tsys.AlignParams.from_vector(v))
        res = ttr.run(s, 9, 9, defocus=v[0], exit_pupil_uniform=False,
                      precision=precision)
        sy, sz = ttr.spot_size(res.detcenter, res.valid)
        (sy + sz).backward()
        return v.grad.numpy()

    g, g64 = grad("df32"), grad("f64")
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    scale = np.abs(g64).max()
    assert (np.abs(g - g64) / np.maximum(np.abs(g64), 1e-6 * scale)).max() \
        < 1e-3
