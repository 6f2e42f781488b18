"""The ray -> wave handoff of the port against akbx: jnp.interp and the
exit-pupil re-fan, the f64 run with the re-fan, autofocus, the handoff
files and stage caches read across both packages, and the two CLI
subcommands; plus the device default of the port's entry points."""

import contextlib
import io as _io
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from akbx import align as jalign
from akbx import cli as jcli
from akbx import io as jio
from akbx import systems as jsys
from akbx import trace as jtr
from akbx import wave as jw
from akbx_torch import align as talign
from akbx_torch import cli as tcli
from akbx_torch import convert
from akbx_torch import io as tio
from akbx_torch import surfaces, systems as tsys
from akbx_torch import trace as ttr
from akbx_torch import wave as tw

torch.set_num_threads(2)

SEEDED = np.random.default_rng(1).normal(0.0, 1e-5, 26)
N = 17


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def systems():
    """akbx's placed system at the seeded misalignment, the port's own
    build of it, and akbx's carried over exactly (convert)."""
    j = jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT,
                              jsys.AlignParams.from_vector(SEEDED))
    t = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                              tsys.AlignParams.from_vector(SEEDED,
                                                           device="cpu"))
    fields = {"mirrors": [{k: np.asarray(v) for k, v in m._asdict().items()}
                          for m in j.mirrors]}
    for f in ("s2f_middle", "fan_h", "fan_v", "source", "valid"):
        fields[f] = np.asarray(getattr(j, f))
    return j, t, convert.system_from_numpy(fields, device="cpu")


@pytest.mark.parametrize("case", ["inside", "outside", "repeated_knot"])
def test_interp_matches_jnp(case):
    """jnp.interp's formula: clamped ends, and a zero-width interval takes
    its left value; to 1e-19 (one ulp of the ~1e-4 values, where XLA may
    contract the interpolation's multiply-add)."""
    rng = np.random.default_rng(3)
    xp = np.sort(rng.uniform(-0.1, 0.1, 17))
    fp = rng.uniform(-1e-4, 1e-4, 17)
    x = np.linspace(xp[0], xp[-1], 33)
    if case == "outside":
        x = np.concatenate([x, [-0.2, 0.3, xp[0] - 1e-12, xp[-1] + 1e-12]])
    if case == "repeated_knot":
        xp[8] = xp[7]
        x = np.concatenate([x, xp])
    j = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                              jnp.asarray(fp)))
    t = ttr.interp(_t(x), _t(xp), _t(fp)).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-19)


@pytest.mark.parametrize("n_h,n_v,stage", [(N, N, -1), (N, 9, -1),
                                           (9, 9, 1)])
def test_exit_pupil_uniform_angles_match_akbx(systems, n_h, n_v, stage):
    """On akbx's own f64 trace (carried over), the port's re-fan angles
    equal akbx's to one ulp (1e-19 rad on ~2e-5 rad angles), for the
    square and the non-square center-row rule and for uniform_stage=1."""
    j_sys = systems[0]
    p0h = jtr.fan_angles(j_sys.fan_h, n_h)
    p0v = jtr.fan_angles(j_sys.fan_v, n_v)
    res = jtr.trace(j_sys, jtr.ray_fan(p0h, p0v),
                    j_sys.source[:, None] * jnp.ones((1, n_h * n_v)))
    tres = ttr.TraceResult(*[tuple(_t(a) for a in f) for f in res[:4]],
                           _t(res.valid))
    j = jtr.exit_pupil_uniform_angles(res, p0h, p0v, n_h, n_v, stage=stage)
    t = ttr.exit_pupil_uniform_angles(tres, _t(p0h), _t(p0v), n_h, n_v,
                                      stage=stage)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-19)


@pytest.fixture(scope="module")
def refan_runs(systems):
    j_sys, t_sys, _ = systems
    kw = dict(defocus_wave=1e-3, exit_pupil_uniform=True, precision="f64")
    return (jtr.run(j_sys, N, N, defocus=SEEDED[0], **kw),
            ttr.run(t_sys, N, N, defocus=torch.tensor(SEEDED[0]), **kw))


def test_refan_retrace_matches_akbx_f64_bars(systems, refan_runs):
    """The same re-fanned rays through the same placed system: the port's
    f64 trace against akbx's at the f64 bars of test_torch_trace.py
    (points 1e-10 m), on the mirrors the tilt correction leaves alone."""
    j, _ = refan_runs
    j_sys, _, t_conv = systems
    rays = ttr.ray_fan(_t(j.rand_p0h), _t(j.rand_p0v))
    t = ttr.trace(t_conv, rays, t_conv.source[:, None].expand(3, N * N))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    for i in range(3):
        np.testing.assert_allclose(t.points[i].numpy(),
                                   np.asarray(j.trace.points[i]), rtol=0,
                                   atol=1e-10)


def test_run_with_refan_matches_akbx(refan_runs):
    """trace.run(exit_pupil_uniform=True, precision='f64') at 17x17.  The
    re-fan feeds the first trace's exit angles back into the source fan,
    and the f64 engine's exit angles carry rounding noise of ~1e-9 rad at
    the fan's edge (two f64 traces of fans 3e-16 rad apart differ by
    8.4e-9 rad there): the two packages' first traces differ at that
    noise, so their re-fanned source angles differ by ~3e-16 rad and the
    re-traced M4 points by ~6e-10 m, the port against itself as much as
    against akbx.  Bars: source angles 1e-15 rad; points, detcenter 5e-9
    m and demeaned OPL 1e-9 m (akbx's fast-vs-f64 bars, the accuracy
    akbx claims for this engine); tilt angles 5e-9 rad; valid equal."""
    j, t = refan_runs
    for f in ("rand_p0h", "rand_p0v"):
        np.testing.assert_allclose(_np(getattr(t, f)),
                                   np.asarray(getattr(j, f)), rtol=0,
                                   atol=1e-15)
    np.testing.assert_array_equal(_np(t.valid), np.asarray(j.valid))
    for i in range(4):
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
        assert abs(float(getattr(t, f)) - float(getattr(j, f))) <= 5e-9


def test_auto_focus_matches_akbx():
    """Two autofocus iterations (the first step and one secant step) from
    the seeded misalignment, 9x9 fans: defocus and astigH agree to 2e-9 m
    (measured <= 4.7e-10 m).  Each iteration's closed-form focus divides
    detector-point spreads, which the two f64 traces give to ~1e-10 m
    (test_torch_trace.py's f64 bar), by ray slopes of ~0.05: ~2e-9 m."""
    def jbuild(p):
        return jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT, p)

    def tbuild(p):
        return tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT, p)

    j = jalign.auto_focus(jbuild, jsys.AlignParams.from_vector(SEEDED),
                          n=9, iters=2)
    t = talign.auto_focus(tbuild, tsys.AlignParams.from_vector(
        SEEDED, device="cpu"), n=9, iters=2)
    assert abs(float(t.defocus) - float(j.defocus)) <= 2e-9
    assert abs(float(t.astig_h) - float(j.astig_h)) <= 2e-9
    assert abs(float(t.defocus) - SEEDED[0]) > 1e-6   # it moved
    np.testing.assert_array_equal(t.to_vector().numpy()[2:], SEEDED[2:])


def test_best_focus_axis_matches_akbx():
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(3, 50)) * 1e-6
    rays = np.vstack([np.ones(50), rng.normal(size=(2, 50)) * 1e-2])
    valid = rng.uniform(size=50) > 0.2
    for axis in (1, 2):
        j = jalign.best_focus_axis(jnp.asarray(pts), jnp.asarray(rays),
                                   jnp.asarray(valid), axis)
        t = talign.best_focus_axis(_t(pts), _t(rays), _t(valid), axis)
        for a, b in zip(t, j):
            assert abs(float(a) - float(b)) <= 1e-12 * abs(float(b))


def _surface(n_v, n_h, x0):
    yy, zz = np.meshgrid(np.linspace(0, 1e-2, n_h), np.linspace(0, 2e-2, n_v))
    return np.stack([np.full_like(yy, x0) + 1e-4 * yy ** 2, yy, zz]).reshape(
        3, -1)


COND = {"grid pix_y": 4, "grid pix_z": 4, "grid pix_H1": 6,
        "grid pix_V1": 5, "option_AKB": True, "defocusForWave": 1e-3,
        "grid pitch_y": 2.5e-07, "label": "run A"}


@pytest.mark.parametrize("writer", ["port", "akbx"])
def test_handoff_files_read_across(tmp_path, writer):
    """A wave-handoff directory written by either package loads the same
    in both: arrays identical, conditions identical, the dS row within
    1e-12 relative of the other package's calc_ds."""
    surfaces_ = {"M1": (_surface(5, 6, 1.0), 5, 6),
                 "M2": (_surface(5, 6, 2.0), 5, 6)}
    args = (str(tmp_path), np.array([0.0, 1e-9, -2e-9]), surfaces_,
            _surface(4, 4, 3.0), _surface(4, 4, 3.1))
    (tio if writer == "port" else jio).save_wave_data(*args, conditions=COND)
    a, b = tio.load_wave_data(str(tmp_path)), jio.load_wave_data(
        str(tmp_path))
    assert sorted(a) == sorted(b) == ["M1", "M2", "conditions",
                                      "gridDefocus", "gridImage", "source"]
    assert a["conditions"] == b["conditions"] == COND
    for k in ("M1", "M2", "gridImage", "gridDefocus", "source"):
        np.testing.assert_array_equal(a[k], b[k])
    for k, (pts, n_v, n_h) in surfaces_.items():
        np.testing.assert_array_equal(a[k][:3], pts)
        other = (jw.calc_ds(jnp.asarray(pts), n_v, n_h) if writer == "port"
                 else tw.calc_ds(_t(pts), n_v, n_h))
        np.testing.assert_allclose(a[k][3], _np(other), rtol=1e-12)


@pytest.mark.parametrize("writer", ["port", "akbx"])
def test_stage_cache_reads_across(tmp_path, writer):
    """A complex_data_<stage>.npz written by either package is a cache hit
    in the other for the same points (same geometry key), with the same
    field, ds and grid size; other points miss."""
    pts = _surface(5, 6, 0.5)
    rng = np.random.default_rng(9)
    u = rng.normal(size=30) + 1j * rng.normal(size=30)
    ds = np.full(30, 1e-6)
    jc, tc = jio.StageCache(str(tmp_path)), tio.StageCache(str(tmp_path))
    if writer == "port":
        tc.save("M1", tw.WaveField.from_complex(pts, u, ds, 6, 5,
                                                device="cpu"))
    else:
        jc.save("M1", jw.WaveField.from_complex(pts, u, ds, 6, 5))
    assert tc._geom_key(_t(pts)) == jc._geom_key(jnp.asarray(pts))
    t = tc.load("M1", _t(pts))
    j = jc.load("M1", pts)
    np.testing.assert_array_equal(t.u.numpy(), u)
    np.testing.assert_array_equal(np.asarray(j.re) + 1j * np.asarray(j.im), u)
    np.testing.assert_array_equal(t.ds.numpy(), ds)
    assert (t.n_h, t.n_v) == (j.n_h, j.n_v) == (6, 5)
    assert tc.load("M1", _t(pts + 1e-3)) is None
    assert jc.load("M1", pts + 1e-3) is None
    assert tc.load("M2", _t(pts)) is None


def test_params_and_manifest_round_trip(tmp_path):
    v = np.random.default_rng(5).normal(size=26)
    (tmp_path / "t").mkdir()
    tio.write_optical_params(str(tmp_path / "t"), v)
    jio.write_optical_params(str(tmp_path), v)
    assert (tmp_path / "t" / "optical_params.txt").read_text() == \
        (tmp_path / "optical_params.txt").read_text()
    np.testing.assert_array_equal(
        tio.read_optical_params(str(tmp_path / "optical_params.txt")), v)
    tio.write_manifest(str(tmp_path), {"n_rays_h": 65})
    assert jio.read_manifest(str(tmp_path)) == {"n_rays_h": 65}


def _cli(mod, *argv):
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(list(argv)) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """export-wave then propagate, 9x9, seeded params, no autofocus, in
    both packages; the port's propagate also reads akbx's export."""
    d = tmp_path_factory.mktemp("cli")
    jio.write_optical_params(str(d), SEEDED)
    common = ("--rays", "9", "--no-autofocus", "--params",
              str(d / "optical_params.txt"))
    j_dir = _cli(jcli, "export-wave", *common, "--out", str(d / "j"))
    t_dir = _cli(tcli, "export-wave", *common, "--out", str(d / "t"),
                 "--device", "cpu")
    out = {"export": (j_dir, t_dir)}
    for name, mod, src, dev in (
            ("j", jcli, j_dir, ()), ("t", tcli, t_dir, ("--device", "cpu")),
            ("t_on_j", tcli, j_dir, ("--device", "cpu"))):
        out[name] = _cli(mod, "propagate", src["out_dir"], "--out",
                         str(d / f"prop_{name}"), *dev)
    return out


def test_cli_export_wave_matches_akbx(cli_runs):
    """The two handoff directories: the same files and conditions; arrays
    within the re-fan's f64 noise (test_run_with_refan_matches_akbx):
    mirror points and grids 5e-9 m, dS 1e-5 relative (a grid pitch of
    ~1e-3 m moving by ~1e-9 m), and the source point 1e-6 m: it is the
    origin rotated about the focus by the tilt angles, 146 m away, so
    5e-9 rad of tilt is 7.3e-7 m there."""
    j_dir, t_dir = (o["out_dir"] for o in cli_runs["export"])
    assert os.path.basename(t_dir).endswith("_akb_wave")
    j, t = jio.load_wave_data(j_dir), jio.load_wave_data(t_dir)
    assert sorted(j) == sorted(t)
    assert j["conditions"].keys() == t["conditions"].keys()
    for key, value in j["conditions"].items():
        assert t["conditions"][key] == pytest.approx(value, rel=1e-5,
                                                     abs=0), key
    for i in range(1, 5):
        np.testing.assert_allclose(t[f"M{i}"][:3], j[f"M{i}"][:3], rtol=0,
                                   atol=5e-9)
        np.testing.assert_allclose(t[f"M{i}"][3], j[f"M{i}"][3], rtol=1e-5)
    for k in ("gridImage", "gridDefocus"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=5e-9)
    np.testing.assert_allclose(t["source"], j["source"], rtol=0, atol=1e-6)


def test_cli_propagate_matches_akbx(cli_runs, tmp_path):
    """intensity_Image.npy: the port (K3, its twin here) on akbx's handoff
    against akbx (its f64 path on the CPU) within 2e-3 of the peak: K3's
    source -> M1 stage carries ~5e-4 of the field (df32 with the source
    145 m from the stage's centroid; akbx's kernel the same), and every
    later stage inherits it.  Each package on its own export: 2e-2 of the
    peak, as the re-fan's f64 noise moves M4 by up to ~6e-10 m (0.3 rad of
    phase at 13.5 nm on single points)."""
    def inten(name):
        return np.load(os.path.join(cli_runs[name]["out"],
                                    "intensity_Image.npy"))

    j, t, t_on_j = inten("j"), inten("t"), inten("t_on_j")
    assert cli_runs["t"]["stages"] == cli_runs["j"]["stages"] == 5
    assert j.shape == t.shape == (81,) and np.isfinite(t).all()
    assert np.abs(t_on_j - j).max() <= 2e-3 * j.max()
    assert np.abs(t - j).max() <= 2e-2 * j.max()
    # the port's stage cache: a rerun reloads every stage
    out = cli_runs["t"]["out"]
    assert sorted(f for f in os.listdir(out) if f.endswith(".npz")) == [
        f"complex_data_{s}.npz" for s in
        ("Image", "Image2", "M1", "M2", "M3", "M4")]


def test_cli_unported_options_raise(cli_runs, tmp_path):
    """No command of akbx's CLI is left unported (``--system kb`` runs
    against akbx's in tests/test_torch_systems_variants.py, ``plot`` in
    tests/test_torch_plotting.py); propagate --config reads akbx's
    WaveConfig file: on akbx's handoff it writes what the same command
    without it wrote (the file's wavelength is the default, and its
    use_pallas runs K3 as the default backend does)."""
    from akbx import config as jcfg

    assert not hasattr(tcli, "UNPORTED")
    cfg = str(tmp_path / "wave.json")
    jcfg.save_config(jcfg.WaveConfig(), cfg)
    out = _cli(tcli, "propagate", cli_runs["export"][0]["out_dir"], "--out",
               str(tmp_path / "prop"), "--config", cfg, "--device", "cpu")
    assert out["stages"] == 5
    np.testing.assert_array_equal(
        np.load(os.path.join(out["out"], "intensity_Image.npy")),
        np.load(os.path.join(cli_runs["t_on_j"]["out"],
                             "intensity_Image.npy")))


@pytest.mark.parametrize("make", [
    lambda: tsys.AlignParams.zeros(),
    lambda: tsys.AlignParams.from_vector(np.zeros(26)),
    lambda: convert.align_params_from_numpy(np.zeros(26)),
    lambda: surfaces.ellipse_coeffs(1.0, 0.5, "xz"),
    lambda: tw.point_source(),
    lambda: tw.WaveField.from_complex(np.zeros((3, 2)), np.ones(2)),
], ids=["zeros", "from_vector", "convert", "ellipse_coeffs", "point_source",
        "from_complex"])
def test_entry_points_default_to_the_card(make):
    """Called without a device and without a tensor to follow, an entry
    point builds on CUDA: without a card that raises (torch's own error),
    with one the result lands there.  Nothing falls back to the CPU."""
    try:
        out = make()
    except (AssertionError, RuntimeError) as exc:
        assert not torch.cuda.is_available(), exc
        return
    first = out[0] if isinstance(out, tuple) else out
    assert first.device.type == "cuda"


def test_tensor_arguments_keep_their_device():
    v = torch.zeros(26, dtype=torch.float64)
    assert tsys.AlignParams.from_vector(v).defocus.device.type == "cpu"
    assert surfaces.ellipse_coeffs(torch.tensor(1.0), 0.5,
                                   "xy").device.type == "cpu"
    assert tw.point_source(torch.zeros(3)).points.device.type == "cpu"
