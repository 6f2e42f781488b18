"""The port's paths around the kernels on one CUDA card: the CLI (trace,
align, propagate with its stage cache, trace --system, plot), gradient
alignment, the ray->wave handoff, the design and fabrication path (no
kernel launches), the native host engine on card tensors, the sharded
paths on a one-rank NCCL group and the dry run under torchrun.  Each is
held against the same run on the CPU, the f64 engine or path, or akbx's
bars.

Needs a CUDA card; skips otherwise.  This file imports no jax:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda*.py
"""

import contextlib
import dataclasses
import functools
import io as _io
import json
import os
import signal
import subprocess
import sys
import traceback
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from akbx_torch import (align, checkpoint, cli, config, convert, design,
                        design_na, export, fab, io, plotting, tooling, trace,
                        wave, wavefront)
from akbx_torch.analysis import legendre, psf, rectify
from akbx_torch.core import geometry as geo
from akbx_torch.core import precision as pr
from akbx_torch.kernels import huygens as hk
from akbx_torch.kernels import trace_kernel as tk
from akbx_torch.parallel import batching, fft as pfft, sharding as sh
from akbx_torch.systems import AlignParams, WOLTER_3_1_DEFAULT, build_wolter_3_1
from torch_parallel_worker import cloud, loss_fn_for

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
EUV = 13.5e-9
W = 257             # the wave cells' fan and grids, per axis: 66,049 points
N = 2048            # the align cells' fan: the alignment loop's and the
                    # sharded paths' (4,194,304 rays)
SUBSET = 2048       # targets of each wave stage held against the f64 path
# K3 vs its twin, of the field's scale (tests/test_torch_cuda.py's bar)
HUYGENS_REL = 1e-6
VEC = np.random.default_rng(1).normal(0.0, 1e-5, 26)   # a misalignment
# d l_o2 / d (na_o, x_3) of the exact NA design at cli design-na's defaults
# (50 digits; tests/test_torch_design.py::test_solve_na_constrained_gradient
# computes and holds them)
EXACT_DLO2 = (0.762520721630886, 1.0242128033621023)
PLOT_FIGURES = ("spot.png", "virtualSource.png", "wavefront.png", "PSF.png",
                "PSF_log.png", "psf_cuts.png", "around_focus.png")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _build(p):
    return build_wolter_3_1(WOLTER_3_1_DEFAULT, p)


def _launches():
    """K1's, K2's and K3's launches so far, once the card is idle."""
    torch.cuda.synchronize()
    return (tk.trace_deviation.launches, tk.detector.launches,
            hk.huygens.launches)


def _since(before):
    return tuple(a - b for a, b in zip(_launches(), before))


@pytest.fixture
def no_kernel(dev):
    """The test launches none of K1-K3."""
    before = _launches()
    yield
    assert _since(before) == (0, 0, 0)


def _cli(argv):
    """The JSON line that one call of the port's CLI prints last."""
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    assert rc == 0, (argv, rc)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _field_rel(got, want):
    """max |got - want| over max |want| of two (re, im) fields."""
    g, w = torch.complex(*got), torch.complex(*want)
    assert bool(torch.isfinite(g).all())
    return float((g - w).abs().max() / w.abs().max())


def _sides(dev):
    """The card and the CPU, each with its label."""
    return (("card", dev), ("cpu", torch.device("cpu")))


def _rel(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / abs(b) if b else abs(a - b)


# --- trace, align and the wave chain through the CLI ------------------------

def test_cli_trace_on_the_card(dev, tmp_path):
    """cli trace from a TraceConfig with the fast engine: autofocus at 21
    and the re-fan launch K1 twice and K2 once, no ray is lost; the same
    run stage by stage keeps the f64 engine's valid rays and its wave2 to
    1 nm (the fast-vs-f64 OPL bar), and its PV, PSF and Legendre fit are
    finite."""
    cfg = config.TraceConfig(n_rays_h=W, n_rays_v=W, defocus_for_wave=1e-2,
                             precision="pallas")
    path = str(tmp_path / "trace.json")
    config.save_config(cfg, path)
    io.write_optical_params(str(tmp_path), VEC)
    before = _launches()
    out = _cli(["trace", "--config", path, "--params",
                str(tmp_path / "optical_params.txt"), "--out", str(tmp_path),
                "--device", str(dev)])
    assert _since(before) == (2, 1, 0)
    assert out["valid_rays"] == W * W
    p = AlignParams.from_vector(io.read_optical_params(
        os.path.join(out["out_dir"], "optical_params.txt")), device=dev)
    system = _build(p)
    lam_nm = cfg.energy.wavelength_nm
    res = trace.run_config(system, cfg, defocus=p.defocus)
    mat, gy, gz = wavefront.wavefront_grid(res, W, W)
    rect = rectify.extract_square_region(mat / lam_nm, W)
    _, ips, _ = legendre.match_multi(rect[1:-2, 1:-2], 5)
    image = psf.psf_from_wavefront(mat, gy, gz, cfg.defocus_for_wave,
                                   cfg.energy.wavelength_m)
    res64 = trace.run_config(system, dataclasses.replace(
        cfg, precision="f64"), defocus=p.defocus)
    assert torch.equal(res.valid, res64.valid)
    assert float((res.wave2 - res64.wave2)[res.valid].abs().max()) <= 1.0
    assert np.isfinite(float(wavefront.pv_6sigma(mat / lam_nm)))
    assert bool(torch.isfinite(image["psf"]).all())
    assert bool(torch.isfinite(ips).all())


def test_cli_align_and_gradient_align_on_the_card(dev, tmp_path):
    """cli align at 21 rays over indices 2, 3 lowers the astigmatism;
    gradient_align, 20 Adam steps of the align loss over the four pitches
    from the seeded misalignment, launches K1 and K2 once a step and
    lowers the loss."""
    out = _cli(["align", "--rays", "21", "--indices", "2,3",
                "--no-autofocus", "--out", str(tmp_path), "--device",
                str(dev)])
    assert abs(out["abrr_after"][0]) < abs(out["abrr_before"][0])
    losses, steps = [], 20

    def loss_fn(v):
        r = trace.run(_build(AlignParams.from_vector(v)), N, N,
                      defocus=v[0], exit_pupil_uniform=False,
                      tilt_correction=True, precision="pallas")
        sy, sz = trace.spot_size(r.ddet32, r.valid)
        loss = (torch.sum(torch.where(r.valid, r.w32, 0.0) ** 2) * 1e18
                + sy + sz)
        losses.append(float(loss.detach()))
        return loss

    before = _launches()
    _, last = align.gradient_align(loss_fn, torch.tensor(VEC, device=dev),
                                   [2, 8, 14, 20], steps=steps, lr=1e-6)
    assert _since(before) == (steps, steps, 0)
    assert float(last) == losses[-1] < losses[0]


@pytest.mark.parametrize("system", ["kb", "tandem", "alternating"])
def test_cli_trace_every_system_on_the_card(dev, tmp_path, system):
    """cli trace --system at its default fan, autofocus on."""
    out = _cli(["trace", "--system", system, "--out", str(tmp_path),
                "--device", str(dev)])
    assert out["valid_rays"] > 0 and np.isfinite(out["pv_6sigma_lambda"])


def test_wave_handoff_chain_and_cli_propagate_on_the_card(dev, tmp_path):
    """Seeded misalignment -> autofocus -> f64 trace with the re-fan ->
    handoff directory -> propagate_stages (source, M1-M4, Image) and the
    defocus grid from M4, 66,049 points a surface: K3 six times, every
    field finite, each stage against the f64 path from the same input
    field on SUBSET seeded targets (akbx's 1e-5 of the field; source -> M1
    2e-3, the source 145 m away, ROADMAP F3).  K3 on the whole M4 -> Image
    stage, 66,049 x 66,049, against its twin: HUYGENS_REL of the field.
    cli propagate twice with its stage cache: K3 six times, then once, the
    same image."""
    p = align.auto_focus(_build, AlignParams.from_vector(
        torch.tensor(VEC, device=dev)), n=21, iters=5)
    s = _build(p)
    res = trace.run(s, W, W, defocus=p.defocus, defocus_wave=1e-3)
    d = io.run_directory(str(tmp_path), "akb_wave")
    export.wave_handoff(d, s, res, W, W, defocus_for_wave=1e-3)
    data = io.load_wave_data(d)
    stages = [{"points": data[f"M{i}"][:3], "ds": data[f"M{i}"][3],
               "name": f"M{i}"} for i in range(1, 5)]
    stages.append({"points": data["gridImage"], "name": "Image"})
    before = _launches()
    src = wave.point_source(tuple(data["source"]), device=dev)
    fields = wave.propagate_stages(src, stages, EUV)
    defocus = wave.propagate_field(fields[-2], data["gridDefocus"], EUV)
    assert _since(before) == (0, 0, 6)
    names = ["M1", "M2", "M3", "M4", "Image", "Defocus"]
    rng = np.random.default_rng(0)
    for name, fin, fout in zip(names, [src] + fields[:4] + [fields[3]],
                               fields + [defocus]):
        assert fout.n == W * W, name
        idx = torch.tensor(np.sort(rng.choice(W * W, SUBSET, replace=False)),
                           device=dev)
        want = wave.propagate(fin, fout.points[:, idx], EUV, backend="xla",
                              chunk=256)
        rel = _field_rel((fout.re[idx], fout.im[idx]), want)
        assert rel <= (2e-3 if name == "M1" else 1e-5), (name, rel)
    full = hk.kernel_args(fields[3], fields[4].points, EUV)
    got = hk.huygens(*full)
    torch.cuda.synchronize()
    assert _field_rel(got, hk.huygens_reference(*full)) <= HUYGENS_REL
    out, images = str(tmp_path / "propagate"), []
    for want in (6, 1):
        before = hk.huygens.launches
        _cli(["propagate", d, "--out", out, "--device", str(dev)])
        torch.cuda.synchronize()
        assert hk.huygens.launches - before == want
        images.append(np.load(os.path.join(out, "intensity_Image.npy")))
    assert np.array_equal(images[0], images[1])


# --- design and fabrication: no kernel, the card against the CPU ------------

def test_cli_design_kb_card_matches_cpu(dev, tmp_path, no_kernel):
    """cli design-kb on the card and on the CPU: the JSON's apertures and
    gap and kb_design.txt agree to 1e-12."""
    outs = [_cli(["design-kb", "--out", str(tmp_path / label), "--device",
                  str(d)]) for label, d in _sides(dev)]
    worst = max(_rel(outs[0][k], outs[1][k]) for k in ("na_h", "na_v", "gap"))
    files = [[float(ln.split(":")[1]) for ln in open(o["kb_design"])]
             for o in outs]
    worst = max([worst] + [_rel(a, b) for a, b in zip(*files)])
    assert worst <= 1e-12, worst


def test_cli_design_na_card_matches_cpu(dev, no_kernel):
    """cli design-na on the card and on the CPU: both meet akbx's bars on
    the design's checks, and their fields agree to 2e-3 (the Newton
    root's conditioning, ROADMAP F10)."""
    card, cpu = (_cli(["design-na", "--device", str(d)])
                 for d in (dev, torch.device("cpu")))
    for o in (card, cpu):
        assert abs(o["check_a_error"]) < 1e-10
        assert abs(o["check_na_i_error"]) < 1e-7
        assert abs(o["check_x_3_error"]) < 1e-4 and o["iterations"] < 50
    fields = [k for k in cpu if not k.startswith("check_")
              and k != "iterations"]
    assert max(_rel(card[k], cpu[k]) for k in fields) <= 2e-3


def test_na_design_gradient_on_the_card(dev, no_kernel):
    """The NA design's implicit gradient d l_o2 / d (na_o, x_3) on the card
    against the exact derivative and against the CPU's: 1e-2."""
    grads = []
    for d in (dev, torch.device("cpu")):
        v = torch.tensor([0.02, 0.55], dtype=torch.float64, device=d,
                         requires_grad=True)
        sol = design_na.solve_na_constrained(146.0, v[1], 1e-4, v[0])
        grads.append(torch.autograd.grad(sol.l_o2, v)[0].cpu().numpy())
    card, cpu = grads
    assert (np.abs(card - EXACT_DLO2) / np.abs(EXACT_DLO2)).max() <= 1e-2
    assert (np.abs(card - cpu) / np.abs(cpu)).max() <= 1e-2


def test_design_kb_card_matches_cpu(dev, monkeypatch, no_kernel):
    """design_kb with EllipseNA on the card and scipy's DE on the host,
    against the CPU's: the DE from the same inputs gives the same x; from
    the card's inputs the same x where they are the CPU's to the bit, and
    the H mirror's l_o2, x_1 and f to 1e-12 then, 1e-9 otherwise."""
    import scipy.optimize as so

    de, xs, designs = so.differential_evolution, {}, {}

    def recording(label):
        def record(*a, **kw):
            xs[label] = de(*a, **kw)
            return xs[label]
        return record

    case = (145.75, 1.05, 0.21, 0.0082, 0.0082, 0.32, 0.2287, 0.0)
    for label, d in _sides(dev):
        monkeypatch.setattr(so, "differential_evolution", recording(label))
        designs[label] = design.design_kb(*case, seed=0, device=d)
    v_cpu = designs["cpu"][0]
    monkeypatch.setattr(so, "differential_evolution", recording("same"))
    design.design_ell_h(types.SimpleNamespace(**{
        k: getattr(v_cpu, k).to(dev)
        for k in ("edge", "f", "l_i2", "theta_g1", "l_o2", "l_i1")}),
        0.32, 0.2287, 0.0, 0.0082, seed=0)
    assert np.array_equal(xs["same"].x, xs["cpu"].x)
    (v_card, h_card), (_, h_cpu) = designs["card"], designs["cpu"]
    same_inputs = all(
        np.float64(float(getattr(v_card, k))) == np.float64(float(getattr(
            v_cpu, k))) for k in ("edge", "f", "l_i2", "theta_g1", "l_o2"))
    if same_inputs:
        assert np.array_equal(xs["card"].x, xs["cpu"].x)
    worst = max(_rel(getattr(h_card, k), getattr(h_cpu, k))
                for k in ("l_o2", "x_1", "f"))
    assert worst <= (1e-12 if same_inputs else 1e-9), worst


def test_cli_sweep_kb_card_matches_cpu(dev, tmp_path, no_kernel):
    """cli sweep-kb over five designs on the card (the f64 engine) at W
    rays, cli trace's fan: its fit and PVs finite, its artifacts read
    back.  The same sweep at 33 rays on the card and on the CPU: NA
    1e-12, PV 1e-6 (the f64 re-fan amplifies the devices' rounding,
    ROADMAP F4)."""
    def sweep(rays, label, d):
        return _cli(["sweep-kb", "--num", "5", "--rays", str(rays), "--out",
                     str(tmp_path / label), "--device", str(d)])

    card = sweep(W, "card", dev)
    assert card["r2"] is not None and np.isfinite(card["r2"])
    assert np.all(np.isfinite(card["pv"]))
    data = tooling.collect_sweep(str(tmp_path / "card"), pv_index=-1)
    assert np.array_equal(data["NA_h"], card["na"])
    assert np.array_equal(data["pv"], card["pv"])
    assert len(data["folder"]) == 5
    n_modes = len(legendre.triangular_orders(5))
    for f in data["folder"]:
        ips = np.loadtxt(os.path.join(f, "inner_products.csv"), delimiter=",")
        assert np.all(np.isfinite(ips)) and ips.size == n_modes
    small, cpu = (sweep(33, label + "33", d) for label, d in _sides(dev))
    assert max(_rel(a, b) for a, b in zip(small["na"], cpu["na"])) <= 1e-12
    assert max(_rel(a, b) for a, b in zip(small["pv"], cpu["pv"])) <= 1e-6


def test_cli_fab_profiles_card_matches_cpu(dev, tmp_path, no_kernel):
    """cli fab-profiles at its default 100,000 points on the card and on
    the CPU: seven finite CSVs, within 1.5e-6 mm of each other (they print
    1e-6 mm, and an ulp of a mirror centre may flip a digit)."""
    for label, d in _sides(dev):
        _cli(["fab-profiles", "--out", str(tmp_path / label), "--device",
              str(d)])
    files = sorted(os.listdir(tmp_path / "card"))
    assert len(files) == 7
    for f in files:
        a, b = (np.loadtxt(tmp_path / t / f, delimiter=",", skiprows=1)
                for t in ("card", "cpu"))
        assert a.ndim == 2 and a.shape[0] > 10 and np.all(np.isfinite(a)), f
        assert a.shape == b.shape and np.abs(a - b).max() <= 1.5e-6, f


def test_traced_cloud_matches_the_analytic_profile(dev, no_kernel):
    """The hyperbola of WOLTER_3_1_DEFAULT's V pair traced by the f64
    engine (33 x 2049 points): its canonical profile against the analytic
    conic 1e-9 m; the side profile against fab's machining profile 1e-6
    mm after a linear detrend, compare_profiles 2e-4 mm; quadric_eval of
    the cloud 1e-9 on the card and against the CPU."""
    spec = WOLTER_3_1_DEFAULT
    s = _build(AlignParams.zeros(dev))
    res = trace.run(s, 33, 2049, defocus=0.0, exit_pupil_uniform=False,
                    tilt_correction=False)
    pts, coeffs = res.trace.points[0], s.mirrors[0].coeffs
    x_c, r = fab.canonical_conic_profile(pts, coeffs)
    y_ana = fab.hyperbola_profile(spec.a_hyp_v, spec.b_hyp_v, 0.0, x_c)
    assert float(np.abs(r - y_ana).max()) <= 1e-9
    order = np.argsort(x_c)
    x_c, r = x_c[order], r[order]
    prof = fab.sideview_profile(np.stack([x_c, 0 * x_c, r]))
    ana = fab.machining_profile(
        lambda x: fab.hyperbola_profile(spec.a_hyp_v, spec.b_hyp_v, 0.0, x),
        float(x_c.min() + x_c.max()) / 2, float(x_c.max() - x_c.min()),
        num=8000, pre_margin=(0.005, 0.02))
    x_a = ana["x_raw"] - np.min(ana["x_raw"])
    y_a = ana["y_raw"] - np.min(ana["y_raw"])
    x_t, y_t = prof[0] * 1e3, prof[1] * 1e3
    y_at = np.interp(x_t, x_a * 1e3, y_a * 1e3)
    dev_mm = y_t - (y_at - y_at.max() + y_t.max())
    dev_mm -= np.polyval(np.polyfit(x_t, dev_mm, 1), x_t)
    assert float(np.abs(dev_mm).max()) <= 1e-6
    resid = fab.compare_profiles(x_t, y_t, x_a * 1e3, y_a * 1e3, dx=0.05)[3]
    assert float(np.abs(resid).max()) <= 2e-4
    s_card = geo.quadric_eval(coeffs, pts)
    s_cpu = geo.quadric_eval(coeffs.cpu(), pts.cpu())
    assert float(s_card.abs().max()) <= 1e-9
    assert float((s_card.cpu() - s_cpu).abs().max()) <= 1e-9


def test_precision_helpers_on_card_tensors(dev, no_kernel):
    """stable_sqrt_diff on 2^20 paths near r_ref, a relative change of
    1e-12 to 1e-11: against r eps / 2 to 1e-3 (d2's three roundings move
    it by up to ~4e-4; akbx's bar) and the CPU's to 1e-15; kahan_sum as
    the CPU's, bit for bit."""
    rng = np.random.default_rng(14)
    f64 = dict(dtype=torch.float64, device=dev)
    r_ref = torch.tensor(rng.uniform(70.0, 150.0, 1 << 20), **f64)
    eps = torch.tensor(rng.choice([-1.0, 1.0], 1 << 20)
                       * 10.0 ** rng.uniform(-12.0, -11.0, 1 << 20), **f64)
    d2 = r_ref ** 2 * (1 + eps)
    sd = pr.stable_sqrt_diff(d2, r_ref)
    sd_cpu = pr.stable_sqrt_diff(d2.cpu(), r_ref.cpu())
    want = r_ref * eps / 2
    assert float(((sd - want).abs() / want.abs()).max()) <= 1e-3
    assert float((sd.cpu() - sd_cpu).abs().max()
                 / sd_cpu.abs().max()) <= 1e-15
    legs = torch.tensor(np.append(rng.uniform(1.0, 100.0, 4), 1e-10),
                        dtype=torch.float64)
    assert float(pr.kahan_sum(legs.to(dev))) == float(pr.kahan_sum(legs))


def test_native_backend_on_card_tensors(dev):
    """backend="native" (akbx's C++/OpenMP host engine, built at first
    use) on a 129^2 -> 129^2 stage of card tensors: its field back on the
    card, akbx's 3e-7 of the field against the f64 path; K3 1e-5."""
    src, tgt = cloud(dev, 129 * 129, 129 * 129, 14)
    nat = wave.propagate(src, tgt, EUV, backend="native")
    assert nat[0].device == tgt.device
    want = wave.propagate(src, tgt, EUV, backend="xla")
    assert _field_rel(nat, want) <= 3e-7
    assert _field_rel(wave.propagate(src, tgt, EUV, backend="pallas"),
                      want) <= 1e-5


# --- run tooling: cli plot and the dry run ----------------------------------

def test_cli_plot_on_the_card(dev, tmp_path, monkeypatch):
    """cli plot --device cuda: its seven figure calls in order, each on
    finite arrays, the PSF at 16 (W + 1) per side; the figures' drawing
    is held on the CPU (tests/test_torch_plotting.py), so the calls are
    recorded here, nothing drawn."""
    calls = []

    def recorder(name):
        def record(*args, path=None, **kw):
            arrays = [a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                      else a for a in args
                      if isinstance(a, (torch.Tensor, np.ndarray))]
            calls.append((os.path.basename(path), [a.shape for a in arrays],
                          all(np.isfinite(a).any() and not np.isinf(a).any()
                              for a in arrays)))
        return record

    for name in ("spot_diagram", "ray_sideview", "wavefront_map",
                 "psf_image", "psf_cuts", "around_focus_montage"):
        monkeypatch.setattr(plotting, name, recorder(name))
    made = _cli(["plot", "--rays", str(W), "--device", str(dev), "--out",
                 str(tmp_path)])
    assert [os.path.basename(f) for f in made["figures"]] == list(PLOT_FIGURES)
    assert [c[0] for c in calls] == list(PLOT_FIGURES)
    assert all(c[2] for c in calls)
    assert calls[3][1][0] == (16 * (W + 1),) * 2


def test_dry_run_under_torchrun_on_the_card(dev):
    """torchrun --nproc-per-node 1 -m akbx_torch.parallel.dryrun, a process
    group of its own, ends well within 300 s."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "1", "-m", "akbx_torch.parallel.dryrun"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, process_group=0)
    try:
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0 and "dryrun over" in out, out[-4000:]


# --- the sharded paths on a one-rank NCCL group, in a process of its own ----

# a fan too large for one run: 6.7e7 rays in 16 blocks of 4.2e6
STREAM_BIG, STREAM_BLOCK = 8192, 512
PSF_PUPIL = 258                      # x pad 16: a 4128^2 PSF, cli plot's


def _sharded_trace(mesh, vec):
    """sharded_trace without and with the re-fan and tilt: f64 as the
    unsharded run to 1e-12 m (one rank sums in the unsharded order); the
    K1 route (K1 once, twice with the re-fan; K2 none: the sharded runs
    finish in f64, as akbx) against the f64 engine: detcenter 5e-9 m,
    demeaned OPL 1e-9 m; valid rays the same."""
    system = _build(AlignParams.from_vector(vec))
    for refan in (False, True):
        kw = dict(exit_pupil_uniform=refan, tilt_correction=refan)
        gold = trace.run(system, N, N, vec[0], precision="f64", **kw)
        s64 = sh.sharded_trace(system, N, N, vec[0], mesh, precision="f64",
                               **kw)
        before = _launches()
        sk1 = sh.sharded_trace(system, N, N, vec[0], mesh,
                               precision="pallas", **kw)
        assert _since(before) == (2 if refan else 1, 0, 0), _since(before)
        assert torch.equal(s64.valid, gold.valid)
        assert torch.equal(sk1.valid, gold.valid)
        w = [r.total_dist - trace.masked_mean(r.total_dist, r.valid)
             for r in (gold, s64, sk1)]
        e64 = max(float((s64.detcenter - gold.detcenter).abs().max()),
                  float((s64.detcenter2 - gold.detcenter2).abs().max()),
                  float((w[1] - w[0]).abs().max()))
        e_k1 = (float((sk1.detcenter - gold.detcenter).abs().max()),
                float((w[2] - w[0]).abs().max()))
        assert e64 <= 1e-12 and e_k1[0] <= 5e-9 and e_k1[1] <= 1e-9, (
            refan, e64, e_k1)


def _sharded_huygens(mesh, dev):
    """huygens_sharded on W^2 -> W^2 points, the f64 path (K3 none), as
    the unsharded f64 path: |err| <= 1e-10 |f| + 1e-12."""
    src, tgt = cloud(dev, W * W, W * W, 15)
    ref = wave.propagate(src, tgt, EUV, chunk=1024, use_pallas=False)
    before = _launches()
    got = sh.huygens_sharded(src, tgt, EUV, mesh, chunk=1024)
    assert _since(before) == (0, 0, 0)
    err = max(float(((g - w).abs() - 1e-10 * w.abs()).max())
              for g, w in zip(got, ref))
    assert err <= 1e-12, err


def _sharded_psf(mesh, dev):
    """psf_fft_sharded as compute_psf_fft: the image coordinates equal,
    the values to rtol 1e-8 (+ 1e-10), a real loss's gradient 1e-7."""
    rng = np.random.default_rng(16)
    y = np.linspace(-1.0, 1.0, PSF_PUPIL)
    r2 = np.add.outer(y**2, y**2)
    opd_np = 5e-9 * r2 + 1e-9 * rng.normal(size=r2.shape)
    amp = torch.tensor(np.where(r2 <= 1.0, 1.0, np.nan), device=dev)
    weight = torch.tensor(rng.uniform(size=(16 * PSF_PUPIL,) * 2),
                          device=dev)
    out = []
    for fn in (functools.partial(pfft.psf_fft_sharded, mesh=mesh),
               psf.compute_psf_fft):
        opd = torch.tensor(opd_np, device=dev, requires_grad=True)
        img, x_im, _ = fn(opd, amp, EUV, 1e-6, 0.3, pad_factor=16)
        torch.sum(weight * img).backward()
        out.append((img.detach(), x_im, opd.grad))
    (i_s, x_s, g_s), (i_u, x_u, g_u) = out
    assert i_s.shape == (16 * PSF_PUPIL,) * 2 and torch.equal(x_s, x_u)
    err = float(((i_s - i_u).abs() - 1e-8 * i_u.abs()).max())
    grad = float((g_s - g_u).abs().max() / g_u.abs().max())
    assert err <= 1e-10 and grad <= 1e-7, (err, grad)


def _streamed(mesh, vec):
    """trace_streamed in blocks as the unstreamed f64 run: the valid count
    exact, centroid and extremes 1e-8, std 1e-6; a STREAM_BIG^2 fan
    reports each block in order and its statistics are finite."""
    system = _build(AlignParams.from_vector(vec))
    st = batching.trace_streamed(system, N, N, vec[0],
                                 block_rows=STREAM_BLOCK, mesh=mesh)
    res = trace.run(system, N, N, vec[0], precision="f64",
                    exit_pupil_uniform=False, tilt_correction=False)
    yz = res.detcenter[1:3, res.valid]

    def rel(a, b):
        return float(((a - b).abs() / b.abs()).max())

    assert int(st.n) == int(res.valid.sum())
    errs = (rel(st.centroid, yz.mean(dim=1)), rel(st.min_yz, yz.amin(dim=1)),
            rel(st.max_yz, yz.amax(dim=1)))
    std = rel(st.spot_std, yz.std(dim=1, correction=0))
    assert max(errs) <= 1e-8 and std <= 1e-6, (errs, std)
    calls = []
    big = batching.trace_streamed(system, STREAM_BIG, STREAM_BIG, vec[0],
                                  block_rows=STREAM_BLOCK, mesh=mesh,
                                  progress=lambda b, n: calls.append(b))
    assert calls == list(range(1, STREAM_BIG // STREAM_BLOCK + 1))
    assert np.isfinite([float(big.spot_std[0]), float(big.opl_std)]).all()
    assert float(big.n) > 0.9 * STREAM_BIG ** 2


def _train(mesh, dev, ckpt):
    """make_train_step with 3x3 figures on the four mirrors and akbx's
    train-step loss (tests/torch_parallel_worker.py): two Adam steps, the
    loss not rising (akbx's 1e-3), the gradient the unsharded one to
    1e-12 of its scale; a checkpoint after the first step restores onto
    the card, and the step resumed from it is the uninterrupted second
    step, bit for bit."""
    fig = np.random.default_rng(17).normal(0.0, 1e-9, (4, 3, 3))
    start = {"align": np.zeros(26), "figures": list(fig)}
    adam = functools.partial(torch.optim.Adam, lr=1e-10)
    step, _, _ = sh.make_train_step(WOLTER_3_1_DEFAULT, loss_fn_for(mesh),
                                    adam, N, N, mesh)
    params = convert.train_params_from_numpy(start, dev)
    opt, params, l1 = step(None, params)
    l1 = float(l1)
    grads = [t.grad.clone() for t in sh.param_list(params)]
    checkpoint.save_train_state(ckpt, 1, params, opt, extra={"loss": l1})
    _, params, l2 = step(opt, params)
    assert np.isfinite([l1, float(l2)]).all() and float(l2) <= l1 * 1.001
    _, loss_u, _ = sh.make_train_step(WOLTER_3_1_DEFAULT, loss_fn_for(None),
                                      adam, N, N, None)
    p_u = convert.train_params_from_numpy(start, dev)
    loss_u(p_u).backward()
    g_rel = max(float((g - u.grad).abs().max() / u.grad.abs().max())
                for g, u in zip(grads, sh.param_list(p_u)))
    assert g_rel <= 1e-12, g_rel
    state, s, extra = checkpoint.restore_train_state(ckpt)
    assert s == 1 and extra == {"loss": l1}
    assert state["params"]["align"].device == params["align"].device
    q = {"align": state["params"]["align"].clone().requires_grad_(),
         "figures": [f.clone().requires_grad_()
                     for f in state["params"]["figures"]]}
    opt_q = adam(sh.param_list(q))
    opt_q.load_state_dict(state["opt_state"])
    _, q, l2_q = step(opt_q, q)
    assert float(l2_q) == float(l2)
    assert all(torch.equal(a.detach(), b.detach())
               for a, b in zip(sh.param_list(params), sh.param_list(q)))


def _one_rank_world(store, ckpt, queue):
    """Rank 0 of a one-rank NCCL group: runs the sharded paths and their
    checks, and puts None or the traceback of what failed."""
    try:
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                world_size=1, rank=0)
        try:
            assert dist.get_backend() == "nccl"
            dev = torch.device("cuda", 0)
            mesh = sh.ray_mesh(device_type="cuda")
            vec = torch.tensor(VEC, device=dev)
            _sharded_trace(mesh, vec)
            _sharded_huygens(mesh, dev)
            _sharded_psf(mesh, dev)
            _streamed(mesh, vec)
            _train(mesh, dev, ckpt)
        finally:
            dist.destroy_process_group()
    except Exception:
        queue.put(traceback.format_exc())
        return
    queue.put(None)


def test_sharded_paths_on_a_one_rank_nccl_group(dev, tmp_path):
    """The sharded trace, Huygens, PSF, streamed fans and train step on a
    one-rank NCCL group, each against its unsharded function
    (``_one_rank_world``), in a spawned process so that a broken group
    cannot reach this one."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_one_rank_world, args=(
        str(tmp_path / "store"), str(tmp_path / "ckpt"), queue))
    proc.start()
    try:
        failed = queue.get(timeout=600)
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
    assert failed is None, failed
    assert proc.exitcode == 0
