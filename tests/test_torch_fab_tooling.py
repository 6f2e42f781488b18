"""The port's fab and tooling modules against akbx on the CPU.

``fab`` and the readers and fits of ``tooling`` run akbx's numpy code on
the host, so from the same inputs (tensors on the port's side, arrays on
akbx's) they give the same numbers: held to 1e-12 of each output's scale
(measured: bit for bit).  The KB sweep traces akbx's KB7 design on each
package's f64 engine with the exit-pupil re-fan, whose exit-angle noise
(ROADMAP F4) moves PV by ~1e-7 of itself: PV is held to 1e-6 of itself and
the Legendre inner products to 1e-5 of the largest, as the other re-fan
parity tests hold them (tests/test_torch_systems_variants.py).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from akbx import fab as jfab
from akbx import tooling as jtool
from akbx_torch import fab as tfab
from akbx_torch import tooling as ttool

torch.set_num_threads(2)

REL = 1e-12


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64))


def _same(t, j, rel=REL):
    """Every array of the two results (tuples, dicts or arrays) within
    ``rel`` of its scale."""
    if isinstance(j, dict):
        assert sorted(t) == sorted(j)
        for k in j:
            _same(t[k], j[k], rel)
    elif isinstance(j, (tuple, list)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b, rel)
    elif j is None:
        assert t is None
    else:
        t, j = np.asarray(t, dtype=float), np.asarray(j, dtype=float)
        assert t.shape == j.shape
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
        ok = ~np.isnan(j)
        scale = max(np.abs(j[ok]).max(), 1e-300) if ok.any() else 1.0
        np.testing.assert_allclose(t[ok], j[ok], rtol=0, atol=rel * scale)


RNG = np.random.default_rng(13)
X = RNG.uniform(0.0, 0.05, 200)
Y = 1e-3 * X**2 + RNG.normal(0, 1e-9, 200)
A_H, B_H = 72.9825, 0.263879113520857
F_H = np.sqrt(A_H**2 + B_H**2)
A_E, B_E = 0.0933, 0.0236745564714402
F_E = np.sqrt(A_E**2 - B_E**2)

CASES = {
    "hyperbola_profile": ((A_H, B_H, F_H, 146.0 + X),),
    "ellipse_profile": ((A_E, B_E, F_E, F_E + X),),
    "rotation_2d": ((X, Y, 0.3),),
    "calc_theta3": ((146.0 + X, 0.02 + Y, 0.0933),),
    "conic_radius_at_angle": ((A_E, B_E, np.linspace(0.1, 0.2, 64), F_E),
                              (0.0077, 0.0043205, np.linspace(0.30, 0.38, 64),
                               0.00883, True)),
    "extrapolate_parabola": ((0.0, -0.5, 1.0, 2.0, 0.7, X),),
    "extrapolate_linear": ((0.0, -0.5, 1.0, 2.0, 0.7, X),),
    "interp_nan": ((np.array([np.nan, 1.0, np.nan, 3.0, 4.0, np.nan]),),),
    "merge_max": (([(np.linspace(0, 1, 101), np.sin(np.pi * np.linspace(
        0, 1, 101))), (np.linspace(0.5, 1.5, 101), np.full(101, 0.25))],),),
    "newell_normal": (((0, 0, 0), (1, 0, 0), (1, 1, 0.01), (0, 1, 0.01)),),
    "rotation_between": (([0.2, 0.9, -0.1], [0.0, 0.0, 1.0]),
                         ([0.0, 0.0, 1.0], [0.0, 0.0, -1.0])),
    "rotate_point_cloud": ((RNG.normal(size=(3, 50)), [0.2, 0.9, -0.1],
                            [0.0, 0.0, 1.0]),),
    "sideview_profile": ((np.stack([146 + X, Y, 0.01 * X]),),),
    "compare_profiles": ((np.linspace(0, 50, 501),
                          -1e-4 * (np.linspace(0, 50, 501) - 25) ** 2,
                          np.linspace(0, 50, 501),
                          -1e-4 * (np.linspace(0, 50, 501) - 25) ** 2
                          + 1e-3 * np.linspace(0, 50, 501)),),
}


def _as_tensors(x):
    if isinstance(x, np.ndarray):
        return _t(x)
    if type(x) in (list, tuple) and x and isinstance(x[0], (tuple, list)):
        return type(x)(_as_tensors(v) for v in x)
    if type(x) is tuple and len(x) == 2 and isinstance(x[0], np.ndarray):
        return tuple(_t(v) for v in x)
    return x


@pytest.mark.parametrize("name", sorted(CASES))
def test_fab_function(name):
    """Each numpy function of fab, with the port given tensors."""
    for args in CASES[name]:
        j = getattr(jfab, name)(*args)
        t = getattr(tfab, name)(*[_as_tensors(a) for a in args])
        _same(t, j)


def test_machining_profile():
    """The hyp_v machining pipeline (the reference's AKB_calc_rotate
    case), with a profile function that returns tensors."""
    theta1 = 5.55983241203018e-05
    l1_prod = -(B_H**2) / np.sin(0.117) ** 2
    l1 = (2 * A_H + np.sqrt((2 * A_H) ** 2 - 4 * l1_prod)) / 2
    xc = l1 * np.cos(theta1)
    j = jfab.machining_profile(
        lambda x: jfab.hyperbola_profile(A_H, B_H, F_H, x), xc, 0.043,
        num=5000)
    t = tfab.machining_profile(
        lambda x: tfab.hyperbola_profile(_t(A_H), B_H, F_H, _t(x)) * 1.0,
        _t(xc), 0.043, num=5000)
    _same(t, j)
    assert abs(t["y_raw"][0] - t["y_raw"][-1]) < 1e-9


def test_wolter1_and_export(tmp_path):
    """The Wolter-I combined profile and its CSV export, byte for byte."""
    spec = dict(a_ell=73.1076714403445, b_ell=0.517019631143022,
                a_hyp=0.0077, b_hyp=0.00432051448679384,
                theta1=0.000145746388538841, ell_length=0.030)
    j = jfab.wolter1_combined_profile(**spec, num=8000)
    t = tfab.wolter1_combined_profile(
        **{k: _t(v) for k, v in spec.items()}, num=8000)
    _same(t, j)
    for pitch in (None, 0.1):
        pj = jfab.export_profile_csv(str(tmp_path / f"j{pitch}.csv"),
                                     j["x_merged"], j["y_merged"], pitch)
        pt = tfab.export_profile_csv(str(tmp_path / f"t{pitch}.csv"),
                                     _t(t["x_merged"]), _t(t["y_merged"]),
                                     pitch)
        assert open(pt).read() == open(pj).read()


@pytest.fixture(scope="module")
def hyp_v_trace():
    """WOLTER_3_1_DEFAULT at zero misalignment on the port's f64 engine:
    129 stations along hyp_v, 5 across (akbx's test loop)."""
    from akbx_torch import trace
    from akbx_torch.systems import (AlignParams, WOLTER_3_1_DEFAULT,
                                    build_wolter_3_1)

    sys_ = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.zeros("cpu"))
    res = trace.run(sys_, 5, 129, defocus=0.0, exit_pupil_uniform=False,
                    tilt_correction=False)
    return res.trace.points[0], sys_.mirrors[0].coeffs


def test_canonical_frame_parity(hyp_v_trace):
    cloud, coeffs = hyp_v_trace
    _same(tfab.quadric_principal_frame(coeffs),
          jfab.quadric_principal_frame(coeffs.numpy()))
    _same(tfab.canonical_conic_profile(cloud, coeffs),
          jfab.canonical_conic_profile(cloud.numpy(), coeffs.numpy()))


def test_traced_vs_analytic_loop(hyp_v_trace):
    """akbx's traced-versus-analytic loop (tests/test_fab_tooling.py) on
    the port's traced cloud, with akbx's bars: the cloud on the conic to
    1e-9 m, the side profile against the analytic export to 1e-6 mm after
    detrend, and compare_profiles to the interpolation floor, 2e-4 mm."""
    from akbx_torch.systems import WOLTER_3_1_DEFAULT as spec

    cloud, coeffs = hyp_v_trace
    x_c, r = tfab.canonical_conic_profile(cloud, coeffs)
    y_ana = tfab.hyperbola_profile(spec.a_hyp_v, spec.b_hyp_v, 0.0, x_c)
    assert np.abs(r - y_ana).max() < 1e-9
    order = np.argsort(x_c)
    x_c, r = x_c[order], r[order]
    prof = tfab.sideview_profile(np.stack([x_c, 0 * x_c, r]))
    ana = tfab.machining_profile(
        lambda x: tfab.hyperbola_profile(spec.a_hyp_v, spec.b_hyp_v, 0.0, x),
        float(x_c.min() + x_c.max()) / 2, float(x_c.max() - x_c.min()),
        num=8000, pre_margin=(0.005, 0.02))
    x_a = ana["x_raw"] - np.min(ana["x_raw"])
    y_a = ana["y_raw"] - np.min(ana["y_raw"])
    x_t, y_t = prof[0] * 1e3, prof[1] * 1e3
    y_at = np.interp(x_t, x_a * 1e3, y_a * 1e3)
    d = y_t - (y_at - y_at.max() + y_t.max())
    d -= np.polyval(np.polyfit(x_t, d, 1), x_t)
    assert np.abs(d).max() < 1e-6
    resid = tfab.compare_profiles(x_t, y_t, x_a * 1e3, y_a * 1e3, dx=0.05)[3]
    assert np.abs(resid).max() < 2e-4


# --- tooling ---------------------------------------------------------------

def _make_sweep(base, n=6):
    """akbx's synthetic sweep folders (tests/test_fab_tooling.py)."""
    for i in range(n):
        d = base / f"{i:02d}"
        os.makedirs(d, exist_ok=True)
        na = 0.02 + 0.01 * i
        with open(d / "kb_design.txt", "w") as f:
            f.write(f"l1h: 146.0\nNA_h: {na}\naccept_h: {na*2}\n")
        np.savetxt(d / "pvs.txt", np.arange(13) * 0.1 + 3 * na**4)
    return str(base)


def test_collect_and_fits(tmp_path):
    base = _make_sweep(tmp_path)
    path = os.path.join(base, "03", "kb_design.txt")
    assert ttool.parse_keyvalue_file(path) == jtool.parse_keyvalue_file(path)
    j, t = jtool.collect_sweep(base), ttool.collect_sweep(base)
    assert sorted(t) == sorted(j)
    for k in j:
        if j[k].dtype == object:
            assert list(t[k]) == list(j[k])
        else:
            _same(t[k], j[k])
    cj, r2j = jtool.fit_pv_vs_na(j["NA_h"], j["pv"])
    ct, r2t = ttool.fit_pv_vs_na(_t(t["NA_h"]), _t(t["pv"]))
    _same(ct, cj)
    assert r2t == pytest.approx(r2j, rel=REL)
    x = np.linspace(0.01, 0.1, 20)
    _same(ttool.fit_power_law(_t(x), _t(2.5 * x**3)),
          jtool.fit_power_law(x, 2.5 * x**3))


def test_mode_sensitivities(tmp_path):
    orders = [(0, 0), (1, 0), (0, 1), (2, 0)]
    for i, p in enumerate(np.linspace(-1e-4, 1e-4, 5)):
        d = tmp_path / f"run{i}"
        os.makedirs(d, exist_ok=True)
        with open(d / "optical_params.txt", "w") as f:
            for j in range(4):
                f.write(f"params[{j}]: {p if j == 2 else 0.0}\n")
        ips = np.array([0.1, 2.0 * p * 1e4, 0.0, -1.5 * p * 1e4])
        np.savetxt(d / "inner_products.csv", ips, delimiter=",")
        np.savetxt(d / "orders.csv", np.array(orders, dtype=float),
                   delimiter=",")
    for nx in (0, None):
        j = jtool.collect_mode_sensitivities(str(tmp_path), 2, nx_filter=nx)
        t = ttool.collect_mode_sensitivities(str(tmp_path), 2, nx_filter=nx)
        assert sorted(t) == sorted(j)
        for k in j:
            _same(t[k], j[k])


def test_write_kb_design(tmp_path):
    """kb_design.txt of akbx's KB7 design, line for line."""
    from akbx import design as jd
    from akbx_torch import design as td

    args = (146.0, 0.21, 0.16742, 0.180, 0.030, 0.15525, 0.05)
    pj = jtool.write_kb_design(str(tmp_path / "j"), jd.kb_define(*args),
                               extra={"run": 3})
    pt = ttool.write_kb_design(str(tmp_path / "t"),
                               td.kb_define(*args, device="cpu"),
                               extra={"run": 3})
    lj, lt = open(pj).read().splitlines(), open(pt).read().splitlines()
    assert [ln.split(":")[0] for ln in lt] == [ln.split(":")[0] for ln in lj]
    _same([float(ln.split(":")[1]) for ln in lt],
          [float(ln.split(":")[1]) for ln in lj])


def _cli(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """``cli sweep-kb`` of both packages: two l1h values at 17 rays
    (akbx's own test size)."""
    from akbx import cli as jcli
    from akbx_torch import cli as tcli

    base = tmp_path_factory.mktemp("sweep")
    argv = ["sweep-kb", "--start", "146", "--stop", "147", "--num", "2",
            "--rays", "17"]
    return (_cli(jcli, argv + ["--out", str(base / "j")]), base / "j",
            _cli(tcli, argv + ["--out", str(base / "t"), "--device", "cpu"]),
            base / "t")


def test_kb_design_sweep(sweeps):
    """The JSON line (NA, PV, no r2 below five points), every run's
    artifacts, and the artifacts read back by collect_sweep."""
    j, jdir, t, tdir = sweeps
    assert t["r2"] is None and j["r2"] is None
    np.testing.assert_array_equal(t["na"], j["na"])
    np.testing.assert_allclose(t["pv"], j["pv"], rtol=1e-6)
    for run in ("run_000", "run_001"):
        for name in ("inner_products.csv", "pvs.txt", "fit_sum.txt",
                     "orders.csv"):
            delim = "," if name.endswith(".csv") else None
            a = np.loadtxt(tdir / run / name, delimiter=delim)
            b = np.loadtxt(jdir / run / name, delimiter=delim)
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
        _same(ttool.parse_keyvalue_file(str(tdir / run / "kb_design.txt")),
              jtool.parse_keyvalue_file(str(jdir / run / "kb_design.txt")))
    data = ttool.collect_sweep(str(tdir), pv_index=-1)
    np.testing.assert_array_equal(data["NA_h"], t["na"])
    np.testing.assert_array_equal(data["pv"], t["pv"])
