"""The port's native (C++/OpenMP) Huygens engine against akbx on the CPU:
the library build, ``wave.propagate(backend="native")`` and ``calc_ds``.

Inputs are made from a numpy seed.  The bar of the field is akbx's own
(tests/test_native.py): 3e-7 of the field's largest magnitude, because
FMA contraction under -march=native moves r by ~1 ulp, which at k r ~ 5e8
is ~1e-7 rad of phase.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from akbx import wave as jwave
from akbx_torch import native
from akbx_torch import wave as twave

torch.set_num_threads(2)

LAM = 13.5e-9
FIELD_REL = 3e-7


@pytest.fixture(scope="module")
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    native.load()


@pytest.fixture(scope="module")
def stage():
    """A seeded source cloud around x = 1 m with a complex field and
    quadrature weights, and a target cloud 0.5 m further on."""
    rng = np.random.default_rng(17)
    src = np.array([1.0, 0.0, 0.0])[:, None] + rng.normal(size=(3, 200)) * 0.01
    tgt = np.array([1.5, 0.0, 0.0])[:, None] + rng.normal(size=(3, 150)) * 0.01
    u = np.exp(1j * rng.uniform(0, 2 * np.pi, 200))
    ds = rng.uniform(0.5, 1.5, 200) * 1e-9
    return src, tgt, u, ds


def test_native_propagate_matches_akbx(gxx, stage):
    """backend="native" against akbx's exact f64 path (``"xla"``) and a
    numpy oracle of the sum; the results are f64 on the source's device."""
    src, tgt, u, ds = stage
    field = twave.WaveField.from_complex(src, u, ds, device="cpu")
    re, im = twave.propagate(field, torch.from_numpy(tgt), LAM,
                             backend="native")
    assert re.dtype == im.dtype == torch.float64
    assert re.device == field.points.device
    got = re.numpy() + 1j * im.numpy()

    jf = jwave.WaveField.from_complex(jnp.asarray(src), jnp.asarray(u),
                                      jnp.asarray(ds))
    jre, jim = jwave.propagate(jf, jnp.asarray(tgt), LAM, backend="xla")
    want = np.asarray(jre) + 1j * np.asarray(jim)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FIELD_REL * np.abs(want).max())

    k = 2 * np.pi / LAM
    w = u * ds
    r = np.sqrt(((tgt[:, :, None] - src[:, None, :]) ** 2).sum(axis=0))
    oracle = (w[None, :] * np.exp(-1j * k * r) / r).sum(axis=1)
    np.testing.assert_allclose(got, oracle, rtol=0,
                               atol=FIELD_REL * np.abs(oracle).max())


def test_native_calc_ds_and_threads(gxx):
    rng = np.random.default_rng(18)
    n_v, n_h = 7, 9
    yy, zz = np.meshgrid(np.linspace(0, 1, n_h), np.linspace(0, 2, n_v))
    pts = np.stack([0.05 * rng.normal(size=yy.shape), yy, zz]).reshape(3, -1)
    ours = native.calc_ds(torch.from_numpy(pts), n_v, n_h)
    assert ours.dtype == torch.float64
    want = np.asarray(jwave.calc_ds(jnp.asarray(pts), n_v, n_h))
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(
        ours.numpy(), twave.calc_ds(torch.from_numpy(pts), n_v, n_h).numpy(),
        rtol=1e-12)
    assert native.num_threads() >= 1


def test_native_refuses_grad_and_fallback(gxx, stage, tmp_path, monkeypatch):
    """No gradient through the host engine, and a failed build raises
    instead of giving way to another backend."""
    src, tgt, u, ds = stage
    field = twave.WaveField.from_complex(src, u, ds, device="cpu")
    pts = field.points.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        twave.propagate(field._replace(points=pts), torch.from_numpy(tgt),
                        LAM, backend="native")

    broken = tmp_path / "huygens.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="native build failed"):
            twave.propagate(field, torch.from_numpy(tgt), LAM,
                            backend="native")
        assert not list((tmp_path / "_build").rglob("*.so*"))
    finally:
        native.load.cache_clear()


def test_native_build_is_atomic(gxx, tmp_path):
    """Four processes build the library into one empty directory at once
    (as test workers do); each loads a whole library and runs it, and no
    temporary file is left behind."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, pathlib, torch\n"
            "from akbx_torch import native\n"
            "native.BUILD_ROOT = pathlib.Path(sys.argv[1])\n"
            "re, im = native.huygens_propagate(torch.zeros(3, 2), "
            "torch.ones(3, 1), torch.ones(1), torch.zeros(1), 1.0)\n"
            "assert native.num_threads() >= 1\n"
            "print(float(re[0]))\n")
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(tmp_path / "_build")], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        # r = sqrt(3) from (1, 1, 1) to the origin: cos(-k r) / r
        assert float(out.split()[-1]) == pytest.approx(
            np.cos(np.sqrt(3.0)) / np.sqrt(3.0), rel=1e-14)
    files = [f.name for f in (tmp_path / "_build").rglob("*") if f.is_file()]
    assert files == [native.LIB_NAME], files
