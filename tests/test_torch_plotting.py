"""akbx_torch.plotting, gui and ``cli plot``: akbx's tests/test_plotting.py
cases on the port's tensors (Agg backend), the headless GUI against akbx's,
and the CLI's figure battery at a small fan."""

import json
import os

import numpy as np
import pytest

import torch

from akbx import gui as jgui
from akbx_torch import cli, design, design_na, gui, plotting, trace
from akbx_torch.systems import AlignParams, WOLTER_3_1_DEFAULT, build_wolter_3_1

RNG = np.random.default_rng(3)


@pytest.fixture(autouse=True)
def close_figures():
    yield
    import matplotlib.pyplot as plt

    plt.close("all")


@pytest.fixture(scope="module")
def engine_result():
    sys_ = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.zeros("cpu"))
    return sys_, trace.run(sys_, 9, 9, defocus=0.0, exit_pupil_uniform=False)


@pytest.fixture(scope="module")
def kb_pair():
    e1 = design.design_ell_v(48.6, 0.33, 0.006, 0.002, device="cpu")
    return e1, e1  # layout plots only need attribute access


class TestPlots:
    def test_spot_diagram(self, engine_result, tmp_path):
        _, res = engine_result
        p = str(tmp_path / "spot.png")
        fig = plotting.spot_diagram(res.detcenter, res.valid, path=p)
        assert os.path.getsize(p) > 0
        assert fig.axes[0].get_title() == "Focal spot"

    def test_ray_sideview(self, engine_result, tmp_path):
        sys_, res = engine_result
        p = str(tmp_path / "side.png")
        plotting.ray_sideview(res.trace.exit_rays, res.trace.exit_points,
                              float(sys_.s2f_middle), 1e-3, 9, 9, path=p)
        assert os.path.getsize(p) > 0

    def test_around_focus_montage(self, tmp_path):
        spots = RNG.normal(size=(5, 3, 40))
        p = str(tmp_path / "montage.png")
        fig = plotting.around_focus_montage(
            torch.as_tensor(spots), np.linspace(-1, 1, 5) * 1e-3, path=p)
        assert len(fig.axes) == 5
        assert os.path.getsize(p) > 0

    def test_wavefront_and_psf(self, tmp_path):
        mat = torch.as_tensor(RNG.normal(size=(17, 17)))
        plotting.wavefront_map(mat, path=str(tmp_path / "w.png"))
        y = np.linspace(-1, 1, 32)
        img = torch.as_tensor(np.exp(-np.add.outer(y**2, y**2) * 30))
        yt = torch.as_tensor(y * 1e-6)
        plotting.psf_image(img, yt, yt, path=str(tmp_path / "psf.png"))
        plotting.psf_image(img, yt, yt, log=True,
                           path=str(tmp_path / "psf_log.png"))
        plotting.psf_image(img, yt, yt, half_width=5e-7,
                           path=str(tmp_path / "psf_trim.png"))
        fig = plotting.psf_cuts(img, yt, yt, path=str(tmp_path / "cuts.png"))
        for f in ("w.png", "psf.png", "psf_log.png", "psf_trim.png",
                  "cuts.png"):
            assert os.path.getsize(tmp_path / f) > 0
        # FWHM: 2 * sqrt(ln 2 / 30) in these units, to the sampling
        assert "FWHM" in fig.axes[0].get_title()

    def test_interactive_around_focus(self, engine_result):
        sys_, res = engine_result
        x0 = float(sys_.s2f_middle)
        calls = []

        def spots_at(off):
            calls.append(off)
            return trace.detector_points(res.trace, x0 + off)

        fig, state = plotting.interactive_around_focus(spots_at, 1e-3,
                                                       n_planes=3,
                                                       valid=res.valid)
        first_offsets = state["offsets"].copy()
        assert len(first_offsets) == 3

        class FakeEvent:
            inaxes = fig.axes[0]

        state["on_click"](FakeEvent())  # click the leftmost plane
        # recentered on the clicked offset with halved span
        assert state["offsets"][1] == pytest.approx(first_offsets[0])
        assert (state["offsets"][-1] - state["offsets"][0]) == pytest.approx(
            (first_offsets[-1] - first_offsets[0]) / 2)
        assert len(calls) == 6  # re-traced all panes

    def test_legendre_modes(self, tmp_path):
        orders = [(0, 0), (1, 0), (0, 1), (1, 1)]
        p = str(tmp_path / "leg.png")
        plotting.legendre_modes(torch.tensor([1.0, 0.5, -0.2, 0.1]), orders,
                                path=p)
        assert os.path.getsize(p) > 0

    def test_design_plots(self, kb_pair, tmp_path):
        e1, e2 = kb_pair
        plotting.ellipse_layout(e1, e2, path=str(tmp_path / "lay.png"))
        plotting.incident_angles(e1, e2, path=str(tmp_path / "ang.png"))
        txt = plotting.design_summary_text(e1, e2)
        assert "aperture" in txt and "demagnification" in txt

    def test_design_raytrace_plot(self, kb_pair, tmp_path):
        e1, _ = kb_pair
        rt = design_na.design_raytrace(e1, 2e-3, n_points=32)
        p = str(tmp_path / "rt.png")
        fig = plotting.design_raytrace_plot(rt, path=p)
        assert len(fig.axes) == 6  # profile + 5 focus planes
        assert os.path.getsize(p) > 0


class TestGUI:
    @pytest.fixture(scope="class")
    def designs(self):
        values = {k: float(v) for k, v in gui.FIELDS}
        return values, gui.compute_design(values, device="cpu"), \
            jgui.compute_design(values)

    def test_compute_design_headless(self, designs):
        """akbx's case, and the summary text akbx's own GUI prints for the
        same fields, line for line."""
        values, (e1, e2, summary), (_, _, j_summary) = designs
        assert gui.FIELDS == jgui.FIELDS
        assert (abs(float(e2.l_o2) - values["target_l_o2"])
                < 0.3 * values["target_l_o2"])
        assert "Focus distance" in summary
        assert summary == j_summary

    def test_make_figures(self, designs):
        _, (e1, e2, _), _ = designs
        figs = gui.make_figures(e1, e2)
        assert len(figs) == 2


def test_cli_plot_writes_its_figures(tmp_path, capsys):
    """``cli plot`` at a 9x9 fan on the CPU writes akbx's seven figures."""
    out = tmp_path / "plots"
    assert cli.main(["plot", "--rays", "9", "--no-autofocus", "--device",
                     "cpu", "--out", str(out)]) == 0
    made = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    names = ["spot.png", "virtualSource.png", "wavefront.png", "PSF.png",
             "PSF_log.png", "psf_cuts.png", "around_focus.png"]
    assert [os.path.basename(f) for f in made["figures"]] == names
    assert all(os.path.getsize(f) > 0 for f in made["figures"])


def _drawn(fig):
    """What a figure draws, per axes: title, line data, scatter offsets,
    image / mesh values and bar heights, as float arrays."""
    out = []
    for ax in fig.axes:
        arrays = [np.asarray(a.get_array(), dtype=float).ravel()
                  for a in ax.images + [c for c in ax.collections
                                        if hasattr(c, "get_coordinates")]]
        out.append({
            "title": ax.get_title(),
            "lines": [ln.get_xydata() for ln in ax.lines],
            "offsets": [np.asarray(c.get_offsets(), dtype=float)
                        for c in ax.collections
                        if not hasattr(c, "get_coordinates")],
            "arrays": arrays,
            "bars": [p.get_height() for p in ax.patches]})
    return out


def _same_drawing(got, want, rtol):
    assert len(got) == len(want)
    compared = 0
    for g, w in zip(got, want):
        assert g["title"] == w["title"]
        assert g["bars"] == pytest.approx(w["bars"], rel=rtol)
        compared += len(g["bars"])
        for key in ("lines", "offsets", "arrays"):
            assert len(g[key]) == len(w[key])
            for a, b in zip(g[key], w[key]):
                np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
                compared += np.size(a)
    assert compared > 0, "nothing drawn to compare"


@pytest.fixture(scope="module")
def jplotting():
    from akbx import plotting as jp

    return jp


def test_figures_draw_what_akbx_draws(engine_result, jplotting):
    """The same data through both packages' plotting draws the same
    points, lines, images and titles (the port's PSF image is an imshow
    where akbx's is a pcolormesh: the same values)."""
    import jax.numpy as jnp

    jp = jplotting
    sys_, res = engine_result
    det, valid = res.detcenter.numpy(), res.valid.numpy()
    rays, pts = res.trace.exit_rays.numpy(), res.trace.exit_points.numpy()
    x0 = float(sys_.s2f_middle)
    y = np.linspace(-1, 1, 32)
    img = np.exp(-np.add.outer(y**2, y**2) * 30)
    spots = RNG.normal(size=(5, 3, 40))
    offs = np.linspace(-1, 1, 5) * 1e-3
    mat = RNG.normal(size=(17, 17))
    cases = [
        ("spot_diagram", (det, valid), 0),
        ("around_focus_montage", (spots, offs), 0),
        ("wavefront_map", (mat, y[:17], y[:17]), 0),
        ("psf_cuts", (img, y * 1e-6, y * 1e-6), 0),
        ("legendre_modes", (np.array([1.0, 0.5, -0.2, 0.1]),
                            [(0, 0), (1, 0), (0, 1), (1, 1)]), 0),
    ]
    for name, args, rtol in cases:
        t_args = [torch.as_tensor(a) if isinstance(a, np.ndarray)
                  and name != "legendre_modes" else a for a in args]
        _same_drawing(_drawn(getattr(plotting, name)(*t_args)),
                      _drawn(getattr(jp, name)(*args)), rtol)
    for log in (False, True):
        got = _drawn(plotting.psf_image(torch.as_tensor(img),
                                        torch.as_tensor(y), torch.as_tensor(y),
                                        log=log))
        want = _drawn(jp.psf_image(img, y, y, log=log))
        np.testing.assert_allclose(got[0]["arrays"][0], want[0]["arrays"][0],
                                   rtol=1e-12)
    _same_drawing(
        _drawn(plotting.ray_sideview(res.trace.exit_rays,
                                     res.trace.exit_points, x0, 1e-3, 9, 9)),
        _drawn(jp.ray_sideview(jnp.asarray(rays), jnp.asarray(pts), x0, 1e-3,
                               9, 9)), 1e-12)


def test_design_figures_draw_what_akbx_draws(jplotting):
    """The design layouts and the design raytrace of the same ellipse
    (each package's own EllipseNA) draw the same lines and points."""
    from akbx import design as jdesign, design_na as jdesign_na

    jp = jplotting
    t1 = design.design_ell_v(48.6, 0.33, 0.006, 0.002, device="cpu")
    j1 = jdesign.design_ell_v(48.6, 0.33, 0.006, 0.002)
    for name in ("ellipse_layout", "incident_angles"):
        _same_drawing(_drawn(getattr(plotting, name)(t1, t1)),
                      _drawn(getattr(jp, name)(j1, j1)), 1e-12)
    assert (plotting.design_summary_text(t1, t1)
            == jp.design_summary_text(j1, j1))
    _same_drawing(
        _drawn(plotting.design_raytrace_plot(
            design_na.design_raytrace(t1, 2e-3, n_points=32))),
        _drawn(jp.design_raytrace_plot(
            jdesign_na.design_raytrace(j1, 2e-3, n_points=32))), 1e-9)
