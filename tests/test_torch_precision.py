"""Parity of akbx_torch.core.precision with akbx.core.precision, the
device-dispatch rule, and the port's independence from jax.

Inputs are made from a numpy seed and fed to both packages.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from akbx.core import precision as jpr
from akbx_torch.core import precision as tpr
from akbx_torch.core import use_kernel

torch.set_num_threads(2)

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def _operands(np_dtype, n=4096, seed=0):
    """Seeded operands spread over many binades, with both signs."""
    rng = np.random.default_rng(seed)

    def one():
        return (rng.uniform(-1, 1, n) * 10.0 ** rng.integers(-6, 6, n)
                ).astype(np_dtype)

    return one(), one()


def _host(j):
    """A JAX result on the host, after its computation has finished."""
    return [np.array(x) for x in jax.block_until_ready(j)]


def _df_rel_err(a, b):
    """|a - b| / |a| for double-words given as (hi, lo) numpy pairs,
    evaluated in f64 without rounding away the lo words."""
    ha, la = (np.asarray(x, dtype=np.float64) for x in a)
    hb, lb = (np.asarray(x, dtype=np.float64) for x in b)
    return np.abs((ha - hb) + (la - lb)) / np.abs(ha)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_two_sum_identical(dt):
    """Error-free: both packages must give bit-identical (hi, lo)."""
    np_dt, t_dt = DTYPES[dt]
    a, b = _operands(np_dt)
    j = _host(jpr.two_sum(jnp.asarray(a), jnp.asarray(b)))
    t = tpr.two_sum(torch.from_numpy(a), torch.from_numpy(b))
    for jw, tw in zip(j, t):
        np.testing.assert_array_equal(jw, tw.numpy())


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_two_prod_identical(dt):
    """Error-free and contraction-immune: bit-identical (hi, lo), and
    hi + lo is the exact product."""
    np_dt, t_dt = DTYPES[dt]
    a, b = _operands(np_dt, seed=1)
    j = _host(jpr.two_prod(jnp.asarray(a), jnp.asarray(b)))
    t = tpr.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    for jw, tw in zip(j, t):
        np.testing.assert_array_equal(jw, tw.numpy())
    if dt == "f32":  # f32 products are exact in f64
        exact = a.astype(np.float64) * b.astype(np.float64)
        got = t.hi.double().numpy() + t.lo.double().numpy()
        np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("op", ["df_div", "df_sqrt", "df_rsqrt"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_df_ops_agree(op, dt):
    """Double-word div/sqrt/rsqrt agree to <= 2^-44 relative: both carry
    ~49 bits in f32 pairs (one Newton step on an f32 first guess whose
    last bit may differ between backends)."""
    np_dt, t_dt = DTYPES[dt]
    a, b = _operands(np_dt, seed=2)
    a, b = np.abs(a), np.abs(b)
    rng = np.random.default_rng(3)
    a_lo = (a * rng.uniform(-1, 1, a.size) * np.finfo(np_dt).eps / 4
            ).astype(np_dt)
    b_lo = (b * rng.uniform(-1, 1, b.size) * np.finfo(np_dt).eps / 4
            ).astype(np_dt)
    jx, jy = jpr.DF(jnp.asarray(a), jnp.asarray(a_lo)), \
        jpr.DF(jnp.asarray(b), jnp.asarray(b_lo))
    tx, ty = tpr.DF(torch.from_numpy(a), torch.from_numpy(a_lo)), \
        tpr.DF(torch.from_numpy(b), torch.from_numpy(b_lo))
    if op == "df_div":
        j, t = jpr.df_div(jx, jy), tpr.df_div(tx, ty)
    else:
        j, t = getattr(jpr, op)(jx), getattr(tpr, op)(tx)
    j = _host(j)
    rel = _df_rel_err(j, (t.hi.numpy(), t.lo.numpy()))
    if rel.max() > 2.0 ** -44:  # say which side is off the exact value
        x, y = (np.longdouble(v) + np.longdouble(w)
                for v, w in ((a, a_lo), (b, b_lo)))
        exact = {"df_div": x / y, "df_sqrt": np.sqrt(x),
                 "df_rsqrt": 1 / np.sqrt(x)}[op]
        off = {name: float(np.max(np.abs(
            np.longdouble(hi) + np.longdouble(lo) - exact) / exact))
            for name, (hi, lo) in (("akbx", j),
                                    ("port", (t.hi.numpy(), t.lo.numpy())))}
        pytest.fail(f"{op} {dt}: rel {rel.max():.3e}, vs exact {off}")


def test_df_add_mul_identical():
    """df_add / df_mul / df_mul_f / sum_segments run the same operations
    in the same order as akbx: bit-identical in f64."""
    a, b = _operands(np.float64, seed=4)
    c, d = _operands(np.float64, seed=5)
    jx, jy = jpr.DF(jnp.asarray(a), jnp.asarray(c * 1e-17)), \
        jpr.DF(jnp.asarray(b), jnp.asarray(d * 1e-17))
    tx, ty = tpr.DF(torch.from_numpy(a), torch.from_numpy(c * 1e-17)), \
        tpr.DF(torch.from_numpy(b), torch.from_numpy(d * 1e-17))
    pairs = [(jpr.df_add(jx, jy), tpr.df_add(tx, ty)),
             (jpr.df_mul(jx, jy), tpr.df_mul(tx, ty)),
             (jpr.df_mul_f(jx, 3.0), tpr.df_mul_f(tx, 3.0))]
    for j, t in pairs:
        j_hi, j_lo = _host(j)
        np.testing.assert_array_equal(j_hi, t.hi.numpy())
        np.testing.assert_array_equal(j_lo, t.lo.numpy())
    segs = [a, b, c, d]
    np.testing.assert_array_equal(
        _host([jpr.sum_segments([jnp.asarray(s) for s in segs])])[0],
        tpr.sum_segments([torch.from_numpy(s) for s in segs]).numpy())


@pytest.mark.parametrize("dt", list(DTYPES))
def test_dot3_norm3_df(dt):
    """The compensated dot product and norm of seeded 3-vectors."""
    np_dt, _ = DTYPES[dt]
    a, b = _operands(np_dt, n=6 * 512, seed=5)
    av, bv = a.reshape(3, -1), b.reshape(3, -1)
    j = jpr.dot3_df(*map(jnp.asarray, av), *map(jnp.asarray, bv))
    t = tpr.dot3_df(*map(torch.from_numpy, av), *map(torch.from_numpy, bv))
    j_hi, j_lo = _host(j)
    np.testing.assert_array_equal(j_hi, t.hi.numpy())
    np.testing.assert_array_equal(j_lo, t.lo.numpy())
    j_hi, j_lo = _host(jpr.norm3_df(*map(jnp.asarray, av)))
    t = tpr.norm3_df(*map(torch.from_numpy, av))
    scale = np.abs(j_hi)
    got = t.hi.numpy().astype(np.float64) + t.lo.numpy()
    want = j_hi.astype(np.float64) + j_lo
    # sqrt may round differently in the two libraries before the Newton
    # step, which restores the double-word value
    rel = 1e-12 if dt == "f32" else 1e-28
    assert np.max(np.abs(got - want) / scale) < rel


def test_kahan_sum_and_stable_sqrt_diff():
    """The compensated sum of OPL-like legs, and ``sqrt(d2) - r`` at a 146
    m path with a 1e-13 relative change (akbx's bar, 1e-3 relative, from
    tests/test_precision.py; here also the same value as akbx)."""
    rng = np.random.default_rng(6)
    legs = rng.uniform(1, 100, 5)
    legs[0] += 1e-10
    assert float(tpr.kahan_sum(torch.from_numpy(legs))) == float(
        jpr.kahan_sum(jnp.asarray(legs)))
    with pytest.raises(NotImplementedError):
        tpr.kahan_sum(torch.from_numpy(legs), axis=0)
    d2 = np.array([146.0**2 * (1 + 1e-13), 73.0**2 * (1 - 3e-12)])
    r = np.array([146.0, 73.0])
    t = tpr.stable_sqrt_diff(torch.from_numpy(d2), torch.from_numpy(r))
    want = r * (np.sqrt(np.array([1 + 1e-13, 1 - 3e-12])) - 1)
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-3)
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jpr.stable_sqrt_diff(jnp.asarray(d2),
                                                   jnp.asarray(r))))


def test_dispatch_rule():
    """CPU -> twin, CUDA -> kernel, any other device or a mix raises."""
    assert use_kernel(torch.zeros(2), torch.zeros(3)) is False
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        use_kernel(torch.zeros(2), torch.zeros(2, device="meta"))


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax and akbx unimported."""
    code = ("import importlib, pkgutil, sys\n"
            "import akbx_torch\n"
            "names = [m.name for m in pkgutil.walk_packages("
            "akbx_torch.__path__, 'akbx_torch.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "assert len(names) >= 30, names\n"
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'akbx.')) or m == 'akbx')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
