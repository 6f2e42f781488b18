"""The port's main path against akbx: build_wolter_3_1 -> run at a 9x9
fan, precision='pallas' (K1/K2 twins on the CPU) and the f64 branch, at
zero and at a seeded misalignment."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from akbx import systems as jsys
from akbx import trace as jtr
from akbx_torch import convert
from akbx_torch import systems as tsys
from akbx_torch import trace as ttr

torch.set_num_threads(2)

N = 9
SEEDED = np.random.default_rng(1).normal(0.0, 1e-5, 26)
PARAMS = {"zero": np.zeros(26), "seeded": SEEDED}


def _run_kwargs(precision):
    return dict(exit_pupil_uniform=False, tilt_correction=True,
                precision=precision)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _demeaned(total, valid):
    total = _np(total)
    return total - total[_np(valid)].mean()


@pytest.fixture(scope="module", params=sorted(PARAMS))
def both(request):
    """Each package's system and engine runs (pallas, f64) for one
    parameter vector, shared by the tests of this module."""
    vec = PARAMS[request.param]
    jsys_ = jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT,
                                  jsys.AlignParams.from_vector(vec))
    tsys_ = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                                  tsys.AlignParams.from_vector(vec))
    runs = {}
    for prec in ("pallas", "f64"):
        runs[prec] = (
            jtr.run(jsys_, N, N, defocus=vec[0], **_run_kwargs(prec)),
            ttr.run(tsys_, N, N, defocus=torch.tensor(vec[0]),
                    **_run_kwargs(prec)))
    return jsys_, tsys_, runs


def test_slice_matches_akbx(both):
    """precision='pallas' against akbx's own CPU path (the jnp twins).
    Bars: detcenter/detcenter2 <= 5e-9 m, demeaned OPL <= 1e-9 m, w32 <=
    2e-9 m (akbx's own fast-vs-f64 bars, tests/test_trace_pallas.py);
    valid identical.  theta <= 2e-8 rad: the tilt angle is a float32
    masked mean over angles up to 0.12 rad, and akbx's float32 sum rounds
    by 3.2e-9 (zero) and 7.6e-9 rad (seeded) against the exact mean of
    the same float32 angles, where the port's rounds by ~2e-10; a 1e-9
    bar would test the order of a float32 sum."""
    j, t = both[2]["pallas"]
    np.testing.assert_array_equal(_np(t.valid), _np(j.valid))
    assert bool(t.valid.all())
    for f in ("detcenter", "detcenter2"):
        np.testing.assert_allclose(_np(getattr(t, f)), _np(getattr(j, f)),
                                   rtol=0, atol=5e-9)
    for f in ("total_dist", "total_dist2"):
        np.testing.assert_allclose(_demeaned(getattr(t, f), t.valid),
                                   _demeaned(getattr(j, f), j.valid),
                                   rtol=0, atol=1e-9)
    for f in ("w32", "w32_2"):
        np.testing.assert_allclose(_np(getattr(t, f)), _np(getattr(j, f)),
                                   rtol=0, atol=2e-9)
    np.testing.assert_allclose(_np(t.ddet32), _np(j.ddet32), rtol=0,
                               atol=5e-9)
    for f in ("theta_y", "theta_z"):
        assert abs(float(getattr(t, f)) - float(getattr(j, f))) <= 2e-8
    # the wavefront [nm]: the OPL difference plus the reference sphere's
    # share of the tilt difference (measured <= 6.1e-3 nm at 9x9)
    np.testing.assert_allclose(_np(t.wave2), _np(j.wave2), rtol=0, atol=0.05)


def test_f64_branch_matches_akbx(both):
    """precision='f64' (the golden): both packages trace in f64 the same
    placed system; points and detcenter agree to 1e-10 m (f64 rounding
    over 146 m legs, amplified by grazing incidence), demeaned OPL to
    1e-12 m, angles to 1e-12 rad."""
    j, t = both[2]["f64"]
    np.testing.assert_array_equal(_np(t.valid), _np(j.valid))
    for i in range(4):
        np.testing.assert_allclose(_np(t.trace.points[i]),
                                   _np(j.trace.points[i]), rtol=0,
                                   atol=1e-10)
    for f in ("detcenter", "detcenter2"):
        np.testing.assert_allclose(_np(getattr(t, f)), _np(getattr(j, f)),
                                   rtol=0, atol=1e-10)
    np.testing.assert_allclose(_demeaned(t.total_dist, t.valid),
                               _demeaned(j.total_dist, j.valid),
                               rtol=0, atol=1e-12)
    for f in ("theta_y", "theta_z"):
        assert abs(float(getattr(t, f)) - float(getattr(j, f))) <= 1e-12


def test_fast_path_matches_port_f64_golden(both):
    """Within the port, as akbx's tests/test_trace_pallas.py holds akbx:
    points and detcenter <= 5e-9 m, demeaned OPL <= 1e-9 m, normals <=
    1e-7, w32 against the demeaned f64 OPL <= 2e-9 m."""
    _, t64 = both[2]["f64"]
    _, t = both[2]["pallas"]
    for i in range(4):
        np.testing.assert_allclose(_np(t.trace.points[i]),
                                   _np(t64.trace.points[i]), rtol=0,
                                   atol=5e-9)
        np.testing.assert_allclose(_np(t.trace.normals[i]),
                                   _np(t64.trace.normals[i]), rtol=0,
                                   atol=1e-7)
    np.testing.assert_allclose(_np(t.detcenter), _np(t64.detcenter), rtol=0,
                               atol=5e-9)
    w64 = _demeaned(t64.total_dist, t64.valid)
    np.testing.assert_allclose(_demeaned(t.total_dist, t.valid), w64,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(t.w32), w64, rtol=0, atol=2e-9)


def test_converted_system_traces_like_akbx(both):
    """A placed akbx system carried over by convert.system_from_numpy
    traces in the port like in akbx (same coefficients, f64 both sides:
    1e-10 m as above)."""
    jsys_ = both[0]
    fields = {"mirrors": [{k: np.asarray(v) for k, v in m._asdict().items()}
                          for m in jsys_.mirrors]}
    for f in ("s2f_middle", "fan_h", "fan_v", "source", "valid"):
        fields[f] = np.asarray(getattr(jsys_, f))
    tsys_ = convert.system_from_numpy(fields)
    for tm, jm in zip(tsys_.mirrors, jsys_.mirrors):
        np.testing.assert_array_equal(tm.coeffs.numpy(), np.asarray(jm.coeffs))
    rays = jtr.ray_fan(jtr.fan_angles(jsys_.fan_h, N),
                       jtr.fan_angles(jsys_.fan_v, N))
    src = jsys_.source[:, None] * jnp.ones((1, N * N))
    jr = jtr.trace(jsys_, rays, src)
    tr = ttr.trace(tsys_, torch.from_numpy(np.asarray(rays)),
                   torch.from_numpy(np.asarray(src)))
    np.testing.assert_array_equal(_np(tr.valid), _np(jr.valid))
    for i in range(4):
        np.testing.assert_allclose(_np(tr.points[i]), _np(jr.points[i]),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(_np(tr.segments[i]), _np(jr.segments[i]),
                                   rtol=0, atol=1e-10)


@pytest.mark.parametrize("mode", ["mean", "extremes"])
def test_tilt_correct_matches_akbx(both, mode):
    """Both tilt estimators of the f64 branch on the same exit fan (akbx's
    f64 trace, carried over as numpy): the same f64 formulas, so angles
    agree to 1e-15 rad and the rotated rays/points to 1e-12 of their
    scale (the rotation is a 3x3 product, BLAS vs XLA)."""
    j = both[2]["f64"][0]
    tres = ttr.TraceResult(*[tuple(torch.from_numpy(np.array(a)) for a in f)
                             for f in j.trace[:4]],
                           torch.from_numpy(np.array(j.trace.valid)))
    jout = jtr.tilt_correct(j.trace, j.detcenter, mode=mode)
    tout = ttr.tilt_correct(tres, torch.from_numpy(np.array(j.detcenter)),
                            mode=mode)
    for k in (2, 3):
        assert abs(float(tout[k]) - float(jout[k])) <= 1e-15
    for k in (0, 1, 4):
        jk = np.asarray(jout[k])
        np.testing.assert_allclose(_np(tout[k]), jk, rtol=0,
                                   atol=1e-12 * np.abs(jk).max())


@pytest.mark.parametrize("mode", ["mean", "extremes"])
def test_tilt_stats_match_akbx(mode):
    """The fast path's tilt angles from f32 exit-direction deviations, on
    seeded inputs.  "extremes" (min/max, order-free): 1e-12 rad, what the
    f32 arctan of two backends may differ by on ~1e-4 rad deviations.
    "mean": 2e-8 rad, the rounding of akbx's float32 sum (ROADMAP F1)."""
    rng = np.random.default_rng(11)
    D4 = np.array([1.0, 2.4e-3, -1.1e-3])
    D4 /= np.linalg.norm(D4)
    dd4 = rng.normal(0.0, 1e-4, (3, 81)).astype(np.float32)
    valid = rng.uniform(size=81) > 0.1
    jt = jtr._tilt_stats(jnp.asarray(D4), jnp.asarray(dd4),
                         jnp.asarray(valid), True, mode)
    tt = ttr._tilt_stats(torch.from_numpy(D4), torch.from_numpy(dd4),
                         torch.from_numpy(valid), True, mode)
    bar = 1e-12 if mode == "extremes" else 2e-8
    for a, b in zip(tt, jt):
        assert abs(float(a) - float(b)) <= bar, (float(a), float(b))


def test_fast_trace_is_lazy():
    s = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                              tsys.AlignParams.zeros())
    r = ttr.run(s, 5, 5, defocus=0.0, **_run_kwargs("pallas"))
    assert r.trace._result is None
    assert len(r.trace.points) == 4
    assert r.trace.exit_points is r.trace.materialize().points[-1]


def test_backward_raises_until_ported():
    """No gradient through the fast engine is silently wrong: its
    backward raises until the f32 twin is ported."""
    v = torch.zeros(26, dtype=torch.float64, requires_grad=True)
    s = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                              tsys.AlignParams.from_vector(v))
    r = ttr.run(s, 5, 5, defocus=v[0], **_run_kwargs("pallas"))
    assert r.w32.requires_grad
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        r.w32.sum().backward()


@pytest.mark.parametrize("kwargs", [
    dict(exit_pupil_uniform=True, precision="pallas"),
    dict(exit_pupil_uniform=False, precision="df32"),
    dict(exit_pupil_uniform=False, precision="pallas", ray_sharding=object()),
    dict(exit_pupil_uniform=False, precision="f64", fan_mode="edge_dense"),
], ids=["exit_pupil_uniform", "df32", "ray_sharding", "edge_dense"])
def test_unported_options_raise(kwargs):
    s = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                              tsys.AlignParams.zeros())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttr.run(s, 5, 5, defocus=0.0, **kwargs)
