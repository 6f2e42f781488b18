"""Parity of akbx_torch.wave (fields, quadrature weights, the f64 path,
the K3 path's gradients, the stage pipeline) and of the utilities it uses
with akbx, on the same numpy inputs."""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from akbx import utils as ju
from akbx import wave as jw
from akbx.core import trig as jtrig
from akbx_torch import convert, utils as tu
from akbx_torch import wave as tw
from akbx_torch.core import trig as ttrig

torch.set_num_threads(2)

EUV = 13.5e-9
HARD = 0.135e-9


def _cloud(n, center, scale, seed):
    rng = np.random.default_rng(seed)
    return np.asarray(center, float)[:, None] + rng.normal(size=(3, n)) * scale


def _field(n_src, seed):
    rng = np.random.default_rng(seed + 100)
    pts = _cloud(n_src, (145.0, 0.02, 0.0), 0.05, seed)
    u = rng.normal(size=n_src) + 1j * rng.normal(size=n_src)
    ds = np.abs(rng.normal(size=n_src)) * 1e-8
    return pts, u, ds


def _c(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_calc_ds_flat_grid():
    """A uniform planar grid with pitch (hx, hv): 2 hx hv everywhere, as
    akbx, <= 1e-12 relative."""
    n_v, n_h, hx, hv = 9, 11, 1e-3, 2e-3
    yy, zz = np.meshgrid(np.arange(n_h) * hx, np.arange(n_v) * hv)
    pts = np.stack([np.zeros_like(yy), yy, zz]).reshape(3, -1)
    t = tw.calc_ds(_t(pts), n_v, n_h).numpy()
    np.testing.assert_allclose(t, 2 * hx * hv, rtol=1e-12)
    np.testing.assert_allclose(
        t, np.asarray(jw.calc_ds(jnp.asarray(pts), n_v, n_h)), rtol=1e-12)


def test_calc_ds_seeded_grid_matches_akbx():
    rng = np.random.default_rng(4)
    n_v, n_h = 7, 8
    yy, zz = np.meshgrid(np.linspace(0, 1, n_h), np.linspace(0, 2, n_v))
    pts = np.stack([0.1 * rng.normal(size=yy.shape), yy, zz]).reshape(3, -1)
    np.testing.assert_allclose(
        tw.calc_ds(_t(pts), n_v, n_h).numpy(),
        np.asarray(jw.calc_ds(jnp.asarray(pts), n_v, n_h)), rtol=1e-12)


@pytest.mark.parametrize("lam,bar", [(EUV, 1e-7), (HARD, 1e-5)],
                         ids=["euv", "hard_xray"])
def test_f64_path_matches_akbx_xla(lam, bar):
    """Port f64 path vs akbx backend='xla', both f64, <= 1e-7 of max |u| at
    EUV: XLA:CPU may contract r's sum of squares into FMAs (~5e-8 rad of
    phase at EUV), and that phase error grows with k, so 1e-5 at 0.135 nm.
    Chunks of 64 targets over 200, with a ragged last chunk."""
    pts, u, ds = _field(300, 1)
    tgt = _cloud(200, (146.2, 0.0, -0.01), 0.02, 2)
    j = _c(*jw.propagate(jw.WaveField.from_complex(pts, u, ds),
                         jnp.asarray(tgt), lam, chunk=64, backend="xla"))
    t = _c(*tw.propagate(tw.WaveField.from_complex(pts, u, ds, device="cpu"),
                         _t(tgt), lam, chunk=64, backend="xla"))
    assert np.abs(t - j).max() <= bar * np.abs(j).max()


def test_point_source_spherical_wave():
    """The field of a point source is exp(-ikr)/r: |u| to 1e-12, phase to
    1e-6 rad (akbx's test_wave bars)."""
    src = tw.point_source((0.0, 0.0, 0.0), device="cpu")
    tgt = _cloud(50, (0.5, 0.0, 0.0), 0.001, 3)
    got = _c(*tw.propagate(src, _t(tgt), EUV, chunk=32, backend="xla"))
    r = np.linalg.norm(tgt, axis=0)
    ref = np.exp(-1j * np.mod(2 * np.pi / EUV * r, 2 * np.pi)) / r
    np.testing.assert_allclose(np.abs(got), 1 / r, rtol=1e-12)
    assert np.abs(np.angle(got / ref)).max() < 1e-6


def test_wave_field_constructors():
    pts, u, ds = _field(5, 2)
    a = tw.WaveField.from_complex(pts, u, ds, n_h=5, n_v=1, device="cpu")
    b = tw.WaveField.from_complex(_t(pts), torch.from_numpy(u), ds)
    for x, y in zip(a[:4], b[:4]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert a.points.dtype == torch.float64 and (a.n_h, a.n_v) == (5, 1)
    np.testing.assert_array_equal(a.u.numpy(), u)
    np.testing.assert_array_equal(a.intensity.numpy(),
                                  u.real ** 2 + u.imag ** 2)
    j = jw.WaveField.from_complex(pts, u, ds, 5, 1)
    c = convert.wave_field_from_numpy(
        {k: np.asarray(getattr(j, k)) for k in j._fields}, device="cpu")
    for x, y in zip(a, c):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    ones = tw.WaveField.from_complex(pts, np.ones(5), device="cpu")
    assert not ones.im.any() and bool((ones.ds == 1).all())


def test_sincos_reduced_matches_akbx():
    rng = np.random.default_rng(8)
    hi = rng.uniform(-1e11, 1e11, 64)
    lo = rng.uniform(-1e-6, 1e-6, 64)
    for t, j in zip(ttrig.sincos_reduced(_t(hi), _t(lo)),
                    jtrig.sincos_reduced(jnp.asarray(hi), jnp.asarray(lo))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-15)


@pytest.mark.parametrize("down", [(0, 0), (2, 4), (6, 2)])
def test_downsample_grid_matches_akbx(down):
    a = np.arange(4 * 9 * 16, dtype=float).reshape(4, -1)
    t, tv, th = tu.downsample_grid(_t(a), 9, 16, *down)
    j, jv, jh = ju.downsample_grid(jnp.asarray(a), 9, 16, *down)
    assert (tv, th) == (jv, jh)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    n, nv, nh = tu.downsample_grid(a[0], 9, 16, *down)
    np.testing.assert_array_equal(n, np.asarray(j)[:1])


def test_stage_timer_logs_and_marks_a_range():
    """One log line ``[name] <seconds> s`` as akbx's, and a profiler range
    of the same name."""
    lines = []
    with torch.profiler.profile() as prof:
        with tu.stage_timer("huygens:M1", log=lines.append):
            torch.ones(3).sum()
    assert len(lines) == 1 and lines[0].startswith("[huygens:M1] ")
    assert lines[0].endswith(" s")
    assert any(e.name == "huygens:M1" for e in prof.events())


def _mk(n_src, n_tgt, seed):
    """tests/test_kernels.py::_mk as numpy, the inputs of akbx's own
    gradient bars."""
    rng = np.random.default_rng(seed)
    src_pts = (np.array([145.0, 0.02, 0.0])[:, None]
               + rng.normal(size=(3, n_src)) * 0.05)
    tgt_pts = (np.array([146.0, 0.05, 0.01])[:, None]
               + rng.normal(size=(3, n_tgt)) * 0.02)
    u = rng.normal(size=n_src) + 1j * rng.normal(size=n_src)
    ds = np.abs(rng.normal(size=n_src)) * 1e-8
    return src_pts, u, ds, tgt_pts


def _grads_akbx(pts, u, ds, tgt, backend):
    src = jw.WaveField.from_complex(pts, u, ds)

    def loss(re, im, ds_, p, tp):
        r, i = jw.propagate(jw.WaveField(p, re, im, ds_), tp, EUV,
                            backend=backend)
        return jnp.sum(r**2 + i**2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        src.re, src.im, src.ds, src.points, jnp.asarray(tgt))]


def _grads_port(pts, u, ds, tgt, backend):
    leaves = [_t(u.real).clone(), _t(u.imag).clone(), _t(ds).clone(),
              _t(pts).clone(), _t(tgt).clone()]
    for x in leaves:
        x.requires_grad_(True)
    re, im = tw.propagate(tw.WaveField(leaves[3], *leaves[:3]), leaves[4],
                          EUV, backend=backend)
    torch.sum(re**2 + im**2).backward()
    return [x.grad.numpy() for x in leaves]


@pytest.mark.parametrize("inputs,names", [
    ((48, 40, 7), ("re", "im", "ds", "points")), ((32, 24, 9), ("targets",))],
    ids=["fields_and_points", "targets"])
def test_grad_through_k3_matches_akbx_and_f64(inputs, names):
    """Gradients through backend='pallas' (the twin forward, the exact f64
    backward) against jax.grad through akbx's 'pallas' and against the
    port's own 'xla', <= 2e-5 of each gradient's scale, on the inputs of
    akbx's own bars (tests/test_kernels.py): the forward's df32 error
    enters the gradient through the cotangent."""
    pts, u, ds, tgt = _mk(*inputs)
    g_t = _grads_port(pts, u, ds, tgt, "pallas")
    g_x = _grads_port(pts, u, ds, tgt, "xla")
    g_j = _grads_akbx(pts, u, ds, tgt, "pallas")
    every = ("re", "im", "ds", "points", "targets")
    for name, t, x, j in zip(every, g_t, g_x, g_j):
        if name not in names:
            continue
        assert np.all(np.isfinite(t)), name
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-5 * np.abs(j).max(),
                                   err_msg=name)
        np.testing.assert_allclose(t, x, rtol=0, atol=2e-5 * np.abs(x).max(),
                                   err_msg=name)


TARGETS_GRAD_BAR = 5e-5  # the card test's bar for the targets


def test_targets_grad_at_512x384_as_akbx_own_kernel():
    """The targets gradient through a df32 forward at 512 sources x 384
    targets, the inputs of the card's test of the gradient through K3
    (tests/test_torch_cuda.py): Re(conj(u) du/dt) cancels its leading
    -ik|u|^2 term, so the forward's ~1e-7 error grows there.
    akbx's own kernel misses 2e-5 of the scale on these inputs; the port's
    twin and akbx's kernel both hold TARGETS_GRAD_BAR against their own
    f64 paths.  Run with -s to print the two readings."""
    pts, u, ds, tgt = _mk(512, 384, 7)
    port = [_grads_port(pts, u, ds, tgt, b)[4] for b in ("pallas", "xla")]
    akbx = [_grads_akbx(pts, u, ds, tgt, b)[4] for b in ("pallas", "xla")]
    rel = {name: np.abs(g - x).max() / np.abs(x).max()
           for name, (g, x) in (("port twin", port), ("akbx kernel", akbx))}
    print("targets gradient vs the f64 path, 512 x 384, of its scale: "
          + "; ".join(f"{k} {v:.3e}" for k, v in rel.items()))
    assert rel["akbx kernel"] > 2e-5
    assert max(rel.values()) <= TARGETS_GRAD_BAR, rel


def test_grad_of_one_input_only():
    """A gradient asked of the targets alone: the other inputs get none."""
    pts, u, ds = _field(16, 3)
    src = tw.WaveField.from_complex(pts, u, ds, device="cpu")
    tgt = _t(_cloud(8, (146.0, 0.0, 0.0), 0.01, 4)).requires_grad_(True)
    re, im = tw.propagate(src, tgt, EUV)
    (g,) = torch.autograd.grad(torch.sum(re**2 + im**2), [tgt])
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_propagate_stages_matches_akbx(backend):
    """source -> M1 (with ds, 8x8) -> M2 -> Image, each stage from the
    previous field, port against akbx with the same backend: K3's bar
    (1e-5 of the stage's |u|) for 'pallas', 2e-7 for 'xla': from a point
    source each target's field is one term, so its relative error is the
    phase error itself, and at k r = 4.65e8 rad here one f64 rounding of
    r is 5.2e-8 rad (measured 1.01e-7 on M1, <= 4.7e-8 after)."""
    m1 = _cloud(64, (1.0, 0.0, 0.0), 0.01, 11)
    m2 = _cloud(49, (2.0, 0.0, 0.0), 0.01, 12)
    img = _cloud(36, (2.3, 0.0, 0.0), 1e-4, 13)
    ds1 = np.full(64, 1e-6)
    stages = [{"points": m1, "ds": ds1, "name": "M1", "n_h": 8, "n_v": 8},
              {"points": m2, "name": "M2"}, {"points": img, "name": "Image"}]
    j = jw.propagate_stages(jw.point_source(), stages, EUV, backend=backend)
    t = tw.propagate_stages(tw.point_source(device="cpu"), stages, EUV,
                            backend=backend)
    bar = 1e-5 if backend == "pallas" else 2e-7
    for fj, ft in zip(j, t):
        uj = _c(fj.re, fj.im)
        assert np.abs(_c(ft.re, ft.im) - uj).max() <= bar * np.abs(uj).max()
        np.testing.assert_array_equal(ft.ds.numpy(), np.asarray(fj.ds))
        assert (ft.n_h, ft.n_v) == (fj.n_h, fj.n_v)


def test_backend_selection():
    pts, u, ds = _field(8, 5)
    src = tw.WaveField.from_complex(pts, u, ds, device="cpu")
    tgt = _t(_cloud(4, (146.0, 0.0, 0.0), 0.01, 6))
    with pytest.raises(ValueError):
        tw.propagate(src, tgt, EUV, backend="mosaic")
    x = tw.propagate(src, tgt, EUV, backend="xla")
    # the native host engine (akbx's bar, tests/test_native.py); without a
    # compiler its build raises, never falling back
    if shutil.which("g++") is None:
        with pytest.raises(RuntimeError, match="native build failed"):
            tw.propagate(src, tgt, EUV, backend="native")
    else:
        n = tw.propagate(src, tgt, EUV, backend="native")
        scale = float(torch.sqrt(x[0] ** 2 + x[1] ** 2).max())
        for a, b in zip(n, x):
            assert float((a - b).abs().max()) <= 3e-7 * scale
    for kw in (dict(use_pallas=False), dict(backend="auto", use_pallas=False)):
        for a, b in zip(tw.propagate(src, tgt, EUV, **kw), x):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    p = tw.propagate(src, tgt, EUV, backend="pallas")
    for kw in (dict(), dict(use_pallas=True), dict(backend="xla",
                                                   use_pallas=True)):
        for a, b in zip(tw.propagate(src, tgt, EUV, **kw), p):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_k3_errors_propagate(monkeypatch):
    """A failing kernel raises; nothing falls back to the f64 path."""
    from akbx_torch.kernels import huygens as th

    def boom(*a, **k):
        raise RuntimeError("huygens: CUDA launch failed with error 98")

    monkeypatch.setattr(th, "huygens", boom)
    src = tw.point_source(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        tw.propagate(src, _t(_cloud(4, (1.0, 0, 0), 0.01, 1)), EUV)
