"""The analysis chain of the port against akbx: utils (edge-dense fans,
ray angles, grid pitches), config files read across both packages, the
wavefront map, Legendre decomposition, pupil rectification and the PSF
on the same inputs, ``cli trace`` from a TraceConfig, and the alignment
sweeps built on them (``field_of_curvature``,
``legendre_alignment_sweep``, ``fine_tune``).  Every fan is 9x9, so that
akbx's eager operations compile once for all of them."""

import contextlib
import io as _io
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from akbx import align as jalign
from akbx import cli as jcli
from akbx import config as jcfg
from akbx import systems as jsys
from akbx import utils as jutils
from akbx import wavefront as jwf
from akbx.analysis import legendre as jleg
from akbx.analysis import psf as jpsf
from akbx.analysis import rectify as jrect
from akbx_torch import align as talign
from akbx_torch import cli as tcli
from akbx_torch import config as tcfg
from akbx_torch import systems as tsys
from akbx_torch import trace as ttr
from akbx_torch import utils as tutils
from akbx_torch import wavefront as twf
from akbx_torch.analysis import legendre as tleg
from akbx_torch.analysis import psf as tpsf
from akbx_torch.analysis import rectify as trect

torch.set_num_threads(2)

SEEDED = np.random.default_rng(1).normal(0.0, 1e-5, 26)
N = 9
LAMBDA_NM = 13.5


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# --- utils -----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 9, 17, 2048])
def test_linspace_is_jnp_linspace(n):
    """The formula of every grid in the port: jnp.linspace's, the ends
    exact, every point within two ulps of the ends' magnitude (XLA may
    contract its multiply-add into an FMA: measured one point in 9 apart
    by 8.5e-22, and 1.0e-20 at 2048 points, on these 3.2e-5 ends)."""
    lo, hi = -3.2e-5, 1.7e-5
    t = tutils.linspace(lo, hi, n).numpy()
    j = np.asarray(jnp.linspace(lo, hi, n))
    assert t[0] == j[0] and t[-1] == j[-1]
    np.testing.assert_allclose(t, j, rtol=0,
                               atol=2 * np.spacing(abs(lo)))


@pytest.mark.parametrize("n", [2, 9, 33])
def test_edge_dense_fan_matches_akbx(n):
    """fan_mode='edge_dense': the sigmoid ramp, to one ulp of its ~2e-5
    rad angles (torch's and XLA's exp may round apart)."""
    fan = np.array([-1.9e-5, 2.1e-5])
    j = np.asarray(jutils.non_uniform_distribution(fan[0], fan[1], n))
    t = ttr.fan_angles(_t(fan), n, mode="edge_dense").numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-20)
    assert t[0] == fan[0]
    if n > 2:   # denser at the edges than in the middle
        assert t[1] - t[0] < t[n // 2 + 1] - t[n // 2]


def test_crop_angle_pitch_match_akbx():
    assert tutils.crop_indices(2, 17, 3) == jutils.crop_indices(2, 17, 3)
    rng = np.random.default_rng(4)
    r1 = rng.normal(size=(3, 40))
    r1[0, 3] = 0.0
    r2 = rng.normal(size=(3, 40))
    for a, b in zip(tutils.angle_between(_t(r1), _t(r2)),
                    jutils.angle_between(jnp.asarray(r1), jnp.asarray(r2))):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-14,
                                   equal_nan=True)
    pts = rng.normal(size=(3, 6 * 5))
    assert tutils.data_pitch(_t(pts), 5, 6) == pytest.approx(
        jutils.data_pitch(jnp.asarray(pts), 5, 6), rel=1e-14)


# --- config ----------------------------------------------------------------

CONFIGS = {
    "trace": dict(n_rays_h=13, n_rays_v=11, energy="hardXray",
                  defocus_for_wave=1e-2, tilt_mode="extremes",
                  fan_mode="edge_dense", precision="pallas"),
    "wave": dict(wavelength_m=1.35e-9, use_pallas=False),
}


def _config(mod, kind):
    kw = dict(CONFIGS[kind])
    if kind == "trace":
        kw["energy"] = mod.Energy(kw["energy"])
        return mod.TraceConfig(**kw)
    return mod.WaveConfig(**kw)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
@pytest.mark.parametrize("writer", ["port", "akbx"])
def test_config_files_read_across(tmp_path, kind, writer):
    """A config saved by either package loads in the other, field for
    field; the files are the same bytes."""
    mods = {"port": tcfg, "akbx": jcfg}
    reader = jcfg if writer == "port" else tcfg
    path = str(tmp_path / "cfg.json")
    mods[writer].save_config(_config(mods[writer], kind), path)
    got = reader.load_config(path)
    assert got == _config(reader, kind)
    assert dataclasses_asdict(got) == dataclasses_asdict(
        _config(mods[writer], kind))
    other = str(tmp_path / "other.json")
    reader.save_config(got, other)
    assert open(other).read() == open(path).read()
    with open(path) as f:
        d = json.load(f)
    d["bogus"] = 1
    with open(path, "w") as f:
        json.dump(d, f)
    with pytest.raises(ValueError, match="unknown"):
        tcfg.load_config(path)


def dataclasses_asdict(cfg):
    import dataclasses

    return {k: getattr(v, "value", v)
            for k, v in dataclasses.asdict(cfg).items()}


# --- wavefront, Legendre, rectify, PSF on one map ---------------------------

@pytest.fixture(scope="module")
def maps():
    """The port's f64 run with the re-fan at 9x9 (seeded), gridded by
    both packages from the same numpy fields."""
    s = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                              tsys.AlignParams.from_vector(SEEDED,
                                                           device="cpu"))
    r = ttr.run(s, N, N, defocus=torch.tensor(SEEDED[0]), defocus_wave=1e-2)
    fields = {k: _np(getattr(r, k)) for k in ("detcenter2", "wave2",
                                              "valid")}
    t = twf.wavefront_grid(SimpleNamespace(**{k: _t(v) for k, v in
                                              fields.items()}), N, N)
    j = jwf.wavefront_grid(SimpleNamespace(**{k: jnp.asarray(v) for k, v in
                                              fields.items()}), N, N)
    return [_np(x) for x in t], [np.asarray(x) for x in j]


def test_wavefront_grid_matches_akbx(maps):
    """The resampled, plane-corrected map [nm] and its grids: the same
    NaN pupil, values to 1e-9 of the map's range (the normal equations
    solve in another order), the grids to two ulps of their ends
    (test_linspace_is_jnp_linspace)."""
    (tm, ty, tz), (jm, jy, jz) = maps
    np.testing.assert_array_equal(np.isnan(tm), np.isnan(jm))
    assert np.isfinite(tm).sum() > N * N // 2
    for a, b in ((ty, jy), (tz, jz)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=2 * np.spacing(np.abs(b).max()))
    scale = np.nanmax(np.abs(jm))
    np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-9 * scale)
    assert float(twf.pv_6sigma(_t(jm) / LAMBDA_NM)) == pytest.approx(
        float(jwf.pv_6sigma(jnp.asarray(jm) / LAMBDA_NM)), rel=1e-12)


def test_resample_quasigrid_decreasing_rows():
    """Rows and columns running backwards and masked samples: the same
    values and NaN pattern as akbx."""
    rng = np.random.default_rng(2)
    y = np.linspace(1.0, -1.0, 7)[None, :] + rng.normal(size=(6, 7)) * 0.01
    z = np.linspace(2.0, -2.0, 6)[:, None] + rng.normal(size=(6, 7)) * 0.01
    v = rng.normal(size=(6, 7))
    valid = rng.uniform(size=(6, 7)) > 0.15
    yg, zg = np.linspace(-1.1, 1.1, 9), np.linspace(-2.1, 2.1, 8)
    t = twf.resample_quasigrid(*map(_t, (y, z, v, valid, yg, zg)))
    j = jwf.resample_quasigrid(*map(jnp.asarray, (y, z, v, valid, yg, zg)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-14,
                               atol=1e-15, equal_nan=True)


def test_plane_correction_matches_akbx():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:12, 0:10]
    img = 0.3 * xx - 0.2 * yy + 0.01 * xx * yy + rng.normal(size=(12, 10))
    img[0, :3] = np.nan
    img[5, 5] = 40.0   # an outlier
    np.testing.assert_allclose(twf.plane_correction(_t(img)).numpy(),
                               np.asarray(jwf.plane_correction(
                                   jnp.asarray(img))),
                               rtol=0, atol=1e-12, equal_nan=True)


def test_legendre_matches_akbx(maps):
    """match_multi on akbx's rectified map (rtol 1e-10, akbx's own bar
    against the reference), mode PVs, the fit sum and mode_map."""
    jm = maps[1][0]
    rect = np.asarray(jrect.extract_square_region(jnp.asarray(jm) / LAMBDA_NM,
                                                  N))[1:-2, 1:-2]
    tf, tip, tord = tleg.match_multi(_t(rect), 5)
    jf, jip, jord = jleg.match_multi(jnp.asarray(rect), 5)
    assert tord == jord and len(tord) == 15
    np.testing.assert_allclose(tip.numpy(), np.asarray(jip), rtol=1e-10)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(tleg.mode_pvs(tf, tip).numpy(),
                               np.asarray(jleg.mode_pvs(jf, jip)), rtol=1e-10)
    np.testing.assert_allclose(tleg.fit_sum(tf).numpy(),
                               np.asarray(jleg.fit_sum(jf)), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(tleg.mode_map(tip[4], tord[4], 33).numpy(),
                               np.asarray(jleg.mode_map(jip[4], jord[4], 33)),
                               rtol=1e-10, atol=1e-14)


def test_rectify_matches_akbx(maps):
    """Corners, the rectified square (bilinear gather) and the NaN-aware
    rotation on the same map."""
    jm = maps[1][0]
    t = trect.extract_square_region(_t(jm), N).numpy()
    j = np.asarray(jrect.extract_square_region(jnp.asarray(jm), N))
    np.testing.assert_allclose(t, j, rtol=1e-13, atol=1e-12, equal_nan=True)
    rot = jrect.estimate_grid_rotation(jnp.asarray(jm))
    assert trect.estimate_grid_rotation(_t(jm)) == rot
    np.testing.assert_allclose(
        trect.rotate_with_nan(_t(jm), 0.3).numpy(),
        np.asarray(jrect.rotate_with_nan(jnp.asarray(jm), 0.3)),
        rtol=1e-13, atol=1e-12, equal_nan=True)


def test_psf_from_wavefront_matches_akbx(maps):
    """The derotated, 16x padded FFT PSF of the map (complex128 in both):
    akbx's bars, rtol 1e-8 and atol 1e-10 on the peak-normalized PSF,
    1e-12 on the image coordinates."""
    jm, jy, jz = maps[1]
    t = tpsf.psf_from_wavefront(_t(jm), _t(jy), _t(jz), 1e-2, 13.5e-9)
    j = jpsf.psf_from_wavefront(jnp.asarray(jm), jnp.asarray(jy),
                                jnp.asarray(jz), 1e-2, 13.5e-9)
    assert t["psf"].dtype == torch.float64 and t["psf"].shape == (160, 160)
    assert t["rotation_rad"] == j["rotation_rad"]
    np.testing.assert_allclose(t["psf"].numpy(), np.asarray(j["psf"]),
                               rtol=1e-8, atol=1e-10)
    for k in ("x_im", "y_im"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-12)


@pytest.mark.parametrize("window", [None, "hann"])
def test_compute_psf_fft_odd_size_matches_akbx(window):
    """An odd-sized pupil with NaNs, large phases (several turns: the
    floor-mod wrap), optional Hann window, the E-field."""
    rng = np.random.default_rng(8)
    opd = rng.normal(size=(15, 13)) * 3e-8
    amp = np.ones_like(opd)
    opd[2, 3] = np.nan
    amp[7, 0] = np.nan
    t = tpsf.compute_psf_fft(_t(opd), _t(amp), 13.5e-9, 1e-4, 0.3,
                             pad_factor=3, window=window,
                             return_efield=True, pupil_dy_m=2e-4)
    j = jpsf.compute_psf_fft(jnp.asarray(opd), jnp.asarray(amp), 13.5e-9,
                             1e-4, 0.3, pad_factor=3, window=window,
                             return_efield=True, pupil_dy_m=2e-4)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-8,
                               atol=1e-10)
    for a, b in zip(t[1:3], j[1:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
    np.testing.assert_allclose(t[3].numpy(), np.asarray(j[3]), rtol=1e-8,
                               atol=1e-10)


def test_fresnel_fwhm_db_match_akbx():
    """The direct Fresnel sum within 1e-6 of its peak: its phases k r are
    ~2.3e8 rad, whose f64 rounding (~3e-8 rad) the two libraries' cos and
    sin reduce differently (measured 2.2e-7); FWHM and dB exactly."""
    rng = np.random.default_rng(9)
    g = np.linspace(-1e-4, 1e-4, 9)
    gx, gy = np.meshgrid(g, g)
    phi = rng.normal(size=(9, 9)) * 1e-9
    phi[0, 0] = np.nan
    out = np.linspace(-2e-6, 2e-6, 7)
    t = tpsf.fresnel_integral(_t(phi), _t(gx), _t(gy), 13.5e-9, 0.5,
                              _t(out), _t(out), chunk=16)
    j = jpsf.fresnel_integral(jnp.asarray(phi), jnp.asarray(gx),
                              jnp.asarray(gy), 13.5e-9, 0.5,
                              jnp.asarray(out), jnp.asarray(out), chunk=16)
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=0,
                               atol=1e-6)
    cut = t[0][3]
    assert float(tpsf.fwhm(_t(out), cut)) == pytest.approx(
        float(jpsf.fwhm(jnp.asarray(out), jnp.asarray(cut.numpy()))))
    v = _t(np.array([1.0, 0.1, 1e-9]))
    np.testing.assert_allclose(tpsf.psf_to_db(v).numpy(),
                               np.asarray(jpsf.psf_to_db(jnp.asarray(
                                   v.numpy()))), atol=1e-12)


# --- cli trace --------------------------------------------------------------

def _cli(mod, *argv):
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(list(argv)) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def trace_runs(tmp_path_factory):
    """cli trace of both packages from one TraceConfig (akbx's file): 9
    rays, the f64 engine without the re-fan, the edge-dense fan, the
    extremes tilt estimator, the seeded misalignment, no autofocus."""
    from akbx import io as jio

    d = tmp_path_factory.mktemp("trace")
    jio.write_optical_params(str(d), SEEDED)
    cfg = jcfg.TraceConfig(n_rays_h=9, n_rays_v=9, defocus_for_wave=1e-2,
                           exit_pupil_uniform=False, tilt_mode="extremes",
                           fan_mode="edge_dense")
    jcfg.save_config(cfg, str(d / "cfg.json"))
    argv = ("trace", "--config", str(d / "cfg.json"), "--no-autofocus",
            "--params", str(d / "optical_params.txt"))
    return (_cli(jcli, *argv, "--out", str(d / "j")),
            _cli(tcli, *argv, "--out", str(d / "t"), "--device", "cpu"))


def test_cli_trace_matches_akbx(trace_runs):
    """The summary and every artifact.  The two f64 engines trace the same
    fan through the same system to 1e-10 m (tests/test_torch_trace.py):
    the map [nm] within 1e-3 nm (measured 3.1e-5 on a 2.6e4 nm map), the
    rectified map, Legendre inner products, PVs and fit sum [waves] within
    1e-8 of their largest entry (measured 1.1e-9), the PSF within 1e-4 of
    its peak (measured 6.5e-6), its coordinates 1e-9 (they scale with the
    grid pitch, which the traced spot sets: measured 1.7e-10).  With the re-fan
    the engines' own exit-angle noise (ROADMAP F4) moves the map by ~0.04
    nm and the PSF of this 5,000-wave map by ~1 % of its peak, so the
    re-fan is held to akbx in tests/test_torch_wave_io.py instead."""
    j, t = trace_runs
    assert t["valid_rays"] == j["valid_rays"] == 81
    assert t["pv_6sigma_lambda"] == pytest.approx(j["pv_6sigma_lambda"],
                                                  rel=1e-8)
    assert (t["defocus"], t["astig_h"]) == (j["defocus"], j["astig_h"])
    assert os.path.basename(t["out_dir"]).endswith("_akb_trace")
    files = sorted(os.listdir(j["out_dir"]))
    assert sorted(os.listdir(t["out_dir"])) == files

    def load(run, name):
        path = os.path.join(run["out_dir"], name)
        if name.endswith(".npy"):
            return np.load(path)
        return np.loadtxt(path, delimiter="," if name.endswith(".csv")
                          else None)

    a, b = load(t, "matrixWave2(nm).txt"), load(j, "matrixWave2(nm).txt")
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, equal_nan=True)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    for name, rel in (("rectified_img.txt", 1e-8), ("fit_sum.txt", 1e-8),
                      ("inner_products.csv", 1e-8), ("pvs.txt", 1e-8),
                      ("psf.npy", 1e-4), ("psf_x.npy", 1e-9),
                      ("psf_y.npy", 1e-9)):
        a, b = load(t, name), load(j, name)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * np.nanmax(np.abs(b)),
                                   equal_nan=True, err_msg=name)
    np.testing.assert_array_equal(load(t, "orders.csv"),
                                  load(j, "orders.csv"))
    params = [open(os.path.join(r["out_dir"], "optical_params.txt")).read()
              for r in (t, j)]
    assert params[0] == params[1]


def test_psf_helpers_match_akbx():
    """wavefront_error_v2, strehl and the display trim on seeded inputs."""
    rng = np.random.default_rng(10)
    args = (rng.normal(size=(3, 20)) + np.array([[1.0], [0.0], [0.0]]),
            rng.normal(size=20) * 1e-9, rng.normal(size=(3, 20)),
            rng.normal(size=(3, 20)) * 1e-6, 13.5e-9)
    t = tpsf.wavefront_error_v2(*map(_t, args[:4]), args[4])
    j = jpsf.wavefront_error_v2(*map(jnp.asarray, args[:4]), args[4])
    for a, b in zip(t, j):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-24)
    assert float(tpsf.strehl(_t(0.5), _t(2.0))) == 0.25
    img = rng.uniform(size=(8, 10))
    x, y = np.linspace(-5e-7, 5e-7, 10), np.linspace(-4e-7, 4e-7, 8)
    for a, b in zip(tpsf.trim_window(_t(img), _t(x), _t(y), 2.5e-7),
                    jpsf.trim_window(img, x, y, 2.5e-7)):
        np.testing.assert_array_equal(a, b)


def _builds():
    return (lambda p, **kw: jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT, p,
                                                  **kw),
            lambda p, **kw: tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT, p,
                                                  **kw))


def test_field_of_curvature_matches_akbx():
    """Best focus and spot for two source shifts at 9x9, f64 engines
    without the re-fan: foci to 1e-8 m (test_torch_align.py's
    compare_sep bar), spots to 1e-6 of each."""
    jb, tb = _builds()
    kw = dict(shifts_y=[0.0, 1e-4], shifts_z=[-1e-4], n=9)
    j = jalign.field_of_curvature(jb, jsys.AlignParams.from_vector(SEEDED),
                                  **kw)
    t = talign.field_of_curvature(
        tb, tsys.AlignParams.from_vector(SEEDED, device="cpu"), **kw)
    assert sorted(t) == sorted(j)
    for k in ("focus_x_h", "focus_x_v"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-8)
    for k in ("spot_h", "spot_v"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-6)


def test_legendre_sweep_and_fine_tune_match_akbx():
    """legendre_alignment_sweep over hyp_V pitch (two values, no
    autofocus) and one fine_tune pass, 9x9 f64 runs with the re-fan: the
    inner products and PVs [waves] within 1e-5 of the largest (the
    re-fan's f64 noise, ROADMAP F4: measured 1.4e-7), the line fits
    within what that allows.  fine_tune's zero crossings lie far outside
    the sampled span at this misalignment (defocus moves by ~1.5e-2 m on
    a span of 2e-5 m), so the PVs' agreement moves them by up to ~1e-3 of
    their move (measured 6.8e-4 astigH, 8.2e-4 defocus); the bar is 2e-3."""
    jb, tb = _builds()
    jp = jsys.AlignParams.from_vector(SEEDED)
    tp = tsys.AlignParams.from_vector(SEEDED, device="cpu")
    kw = dict(param_index=2, values=[0.0, 2e-5], n=9, autofocus=False)
    j = jalign.legendre_alignment_sweep(jb, jp, **kw)
    t = talign.legendre_alignment_sweep(tb, tp, **kw)
    assert t["orders"] == j["orders"]
    np.testing.assert_array_equal(t["values"], j["values"])
    for k, fits in (("inner_products", "ip_slopes"), ("pvs", "pv_slopes")):
        eps = 1e-5 * np.abs(j[k]).max()
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=eps, err_msg=k)
        # two-point line fits: the slope within 2 eps over the step, the
        # intercept (at the value 0) within eps
        np.testing.assert_allclose(t[fits][:, 0], j[fits][:, 0], rtol=0,
                                   atol=2 * eps / 2e-5, err_msg=fits)
        np.testing.assert_allclose(t[fits][:, 1], j[fits][:, 1], rtol=0,
                                   atol=eps, err_msg=fits)
    jt = jalign.fine_tune(jb, jp, n=9, samples=2)
    tt = talign.fine_tune(tb, tp, n=9, samples=2)
    for f in ("astig_h", "defocus"):
        a, b, p0 = (float(getattr(x, f)) for x in (tt, jt, tp))
        assert abs(a - b) <= 2e-3 * abs(b - p0)
