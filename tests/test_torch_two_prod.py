"""The port's float32 ``two_prod`` (a multiply and an FMA, taken through
float64 in PyTorch) against akbx's contraction-immune Dekker form, and
``akbx_torch/csrc/df32.cuh`` compiled for the host against the PyTorch
twins of its functions.

Inputs are made from numpy seeds and fed to both sides.

Where the two forms agree.  Both return the correctly rounded product and
its exact error term, so they are bit-identical wherever every partial
product of the Dekker form is a normal float32.  XLA on the CPU flushes
subnormals to zero, so akbx's form loses its smallest partial product
(ulp(a) ulp(b)) once |a b| falls below about 2^-78; numpy and PyTorch keep
subnormals, and there the Dekker form first differs where the error term
itself is subnormal (|a b| below about 2^-102).  The FMA form is exact
down to a single rounding of a subnormal error term.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from akbx.core import precision as jpr
from akbx_torch.core import precision as tpr

torch.set_num_threads(2)

F32 = np.float32
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _akbx(a, b):
    out = jax.block_until_ready(jpr.two_prod(jnp.asarray(a), jnp.asarray(b)))
    return np.array(out.hi), np.array(out.lo)


def _port(a, b):
    t = tpr.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    return t.hi.numpy(), t.lo.numpy()


def _assert_same_bits(got, want):
    """Bit-equal, except that a zero may carry either sign: the FMA form
    keeps the IEEE sign of a zero product, the Dekker form returns +0."""
    np.testing.assert_array_equal(got, want)
    nz = want != 0
    int_t = np.int32 if got.dtype == np.float32 else np.int64
    np.testing.assert_array_equal(got[nz].view(int_t), want[nz].view(int_t))


def _signed(rng, n):
    return rng.choice(np.array([-1.0, 1.0]), n)


def _random_pairs(n=1_200_000, seed=11):
    """Mantissas in [1, 2), both signs, exponents 2^-45..2^45, the pair's
    exponents summing to >= -78 so that XLA:CPU flushes no partial
    product of akbx's form."""
    rng = np.random.default_rng(seed)
    ea = rng.integers(-45, 46, n)
    eb = np.maximum(rng.integers(-45, 46, n), -78 - ea)
    a = _signed(rng, n) * rng.uniform(1.0, 2.0, n) * 2.0 ** ea
    b = _signed(rng, n) * rng.uniform(1.0, 2.0, n) * 2.0 ** eb
    return a.astype(F32), b.astype(F32)


def _special_pairs():
    """Zeros of both signs, powers of two, and products that tie at half
    an ulp: (1 + 2^-k)(1 + 2^-(24-k)) = 1 + 2^-k + 2^-(24-k) + 2^-24."""
    k = np.arange(1, 24)
    tie_a, tie_b = 1.0 + 2.0 ** -k, 1.0 + 2.0 ** -(24.0 - k)
    pow2 = 2.0 ** np.arange(-45, 46, 5)
    a = np.concatenate([[0.0, -0.0, 0.0, -0.0, 3.0, -3.0], pow2, -pow2,
                        tie_a, -tie_a, tie_a * 2.0 ** 20, tie_a * 2.0 ** -30])
    b = np.concatenate([[5.0, 5.0, -0.0, -0.0, 0.0, 0.0], pow2[::-1],
                        pow2 * 3.0, tie_b, tie_b, -tie_b * 2.0 ** 11,
                        tie_b * 2.0 ** -9])
    return a.astype(F32), b.astype(F32)


PAIRS = {"random": _random_pairs, "special": _special_pairs}


@pytest.mark.parametrize("which", sorted(PAIRS))
def test_f32_two_prod_matches_akbx_bit_for_bit(which):
    a, b = PAIRS[which]()
    for got, want in zip(_port(a, b), _akbx(a, b)):
        _assert_same_bits(got, want)


@pytest.mark.parametrize("which", sorted(PAIRS))
def test_f32_two_prod_sums_to_the_exact_product(which):
    """hi is the rounded product and hi + lo the exact one (48 bits, held
    by a float64)."""
    a, b = PAIRS[which]()
    hi, lo = _port(a, b)
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(hi, exact.astype(F32))
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, exact)
    assert hi.dtype == F32 and lo.dtype == F32


def _dekker_numpy(a, b):
    """akbx's two_prod, transcribed to numpy float32 (subnormals kept)."""

    def two_sum(x, y):
        s = x + y
        bb = s - x
        return s, (x - (s - bb)) + (y - bb)

    def fast_two_sum(x, y):
        s = x + y
        return s, y - (s - x)

    def split(x):
        t = F32(4097.0) * x
        hi = t - (t - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    c = two_sum(ah * bl, al * bh)
    p = two_sum(ah * bh, c[0])
    d = two_sum(p[1], c[1])
    q = two_sum(d[0], al * bl)
    r = fast_two_sum(p[0], q[0])
    s = two_sum(d[1], q[1])
    t = two_sum(r[1], s[0])
    return fast_two_sum(r[0], t[0] + (t[1] + s[1]))


def test_f32_two_prod_where_the_error_term_is_subnormal():
    """2^-124 <= |a b| < 2^-100: the error term lies below the normal
    range.  The FMA form still returns the rounded product and the error
    term rounded once (to within half a subnormal ulp, 2^-150); the Dekker
    form in IEEE float32 ends within 2^-148 of the same sum, though its
    words may differ.  (Under XLA:CPU akbx's form also flushes partial
    products here, so it is not the yardstick in this domain.)"""
    rng = np.random.default_rng(12)
    n = 400_000
    ea = rng.integers(-62, -38, n)
    eb = rng.integers(-124, -100, n) - ea
    a = (_signed(rng, n) * rng.uniform(1.0, 2.0, n) * 2.0 ** ea).astype(F32)
    b = (_signed(rng, n) * rng.uniform(1.0, 2.0, n) * 2.0 ** eb).astype(F32)
    exact = a.astype(np.float64) * b.astype(np.float64)
    assert 2.0 ** -124 <= np.abs(exact).min()
    assert np.abs(exact).max() < 2.0 ** -99
    hi, lo = _port(a, b)
    np.testing.assert_array_equal(hi, exact.astype(F32))
    np.testing.assert_array_equal(
        lo, (exact - hi.astype(np.float64)).astype(F32))
    assert np.abs(hi.astype(np.float64) + lo - exact).max() <= 2.0 ** -150
    assert (np.abs(lo[lo != 0]) < np.finfo(F32).tiny).any()
    d_hi, d_lo = _dekker_numpy(a, b)
    both = (d_hi.astype(np.float64) + d_lo) - (hi.astype(np.float64) + lo)
    assert np.abs(both).max() <= 2.0 ** -148
    # and the transcription is akbx's form: bit-equal to it on normal ground
    a2, b2 = _random_pairs(50_000, seed=13)
    for got, want in zip(_dekker_numpy(a2, b2), _akbx(a2, b2)):
        np.testing.assert_array_equal(got, want)


def test_f64_two_prod_keeps_the_dekker_form():
    """float64 has no wider type to take an FMA through: the Dekker form
    stays, bit for bit akbx's (the double-f64 placement's two_prod)."""
    rng = np.random.default_rng(14)
    n = 200_000
    a = _signed(rng, n) * rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(
        -100, 101, n)
    b = _signed(rng, n) * rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(
        -100, 101, n)
    got, want = _port(a, b), _akbx(a, b)
    assert got[0].dtype == np.float64 and got[1].dtype == np.float64
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int64), w.view(np.int64))
    assert (got[1] != 0).mean() > 0.9


def test_f32_two_prod_is_differentiable_like_a_product():
    a = torch.tensor([1.5, -2.25, 3.0], requires_grad=True)
    b = torch.tensor([0.3, 0.7, -1.1])
    p = tpr.two_prod(a, b)
    (p.hi + p.lo).sum().backward()
    torch.testing.assert_close(a.grad, b, rtol=1e-6, atol=0)


# --- df32.cuh compiled for the host ---------------------------------------

_SHIM_SOURCE = r"""
#include "df32_host_shim.h"
#include "df32.cuh"

extern "C" void shim_two_prod(const float* a, const float* b, float* hi,
                              float* lo, long n) {
  for (long i = 0; i < n; ++i) {
    df p = two_prod(a[i], b[i]);
    hi[i] = p.hi;
    lo[i] = p.lo;
  }
}

#define BINARY(NAME, FN)                                                  \
  extern "C" void NAME(const float* xh, const float* xl, const float* yh, \
                       const float* yl, float* hi, float* lo, long n) {   \
    for (long i = 0; i < n; ++i) {                                        \
      df r = FN({xh[i], xl[i]}, {yh[i], yl[i]});                          \
      hi[i] = r.hi;                                                       \
      lo[i] = r.lo;                                                       \
    }                                                                     \
  }
BINARY(shim_df_add, df_add)
BINARY(shim_df_mul, df_mul)
BINARY(shim_df_div, df_div)

extern "C" void shim_df_sqrt(const float* xh, const float* xl, float* hi,
                             float* lo, long n) {
  for (long i = 0; i < n; ++i) {
    df r = df_sqrt({xh[i], xl[i]});
    hi[i] = r.hi;
    lo[i] = r.lo;
  }
}
"""


@pytest.fixture(scope="module")
def shim(tmp_path_factory):
    """df32.cuh built for the host through tests/df32_host_shim.h."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("df32_shim")
    src = tmp / "shim.cpp"
    src.write_text(_SHIM_SOURCE)
    lib = tmp / "libdf32_shim.so"
    subprocess.run(
        [gxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
         "-I", str(ROOT / "tests"), "-I", str(ROOT / "akbx_torch" / "csrc"),
         "-o", str(lib), str(src)], check=True, capture_output=True,
        text=True, timeout=300)
    return ctypes.CDLL(str(lib))


def _df_operands(n=200_000, seed=21):
    """Seeded normalised df32 operands (|lo| <= ulp(hi)/2) over many
    binades, both signs."""
    rng = np.random.default_rng(seed)

    def one():
        x = (_signed(rng, n) * rng.uniform(1.0, 2.0, n)
             * 2.0 ** rng.integers(-20, 21, n))
        hi = x.astype(F32)
        return hi, (x - hi.astype(np.float64)).astype(F32)

    return one(), one()


def _call(fn, *arrays):
    n = arrays[0].size
    hi, lo = np.empty(n, F32), np.empty(n, F32)
    ptrs = [np.ascontiguousarray(x).ctypes.data_as(ctypes.c_void_p)
            for x in (*arrays, hi, lo)]
    fn.restype = None
    fn(*ptrs, ctypes.c_long(n))
    return hi, lo


def _twin_div(x, y):
    from akbx_torch.kernels.trace_kernel import _df_div

    return _df_div(x, y)


_TWINS = {"df_add": tpr.df_add, "df_mul": tpr.df_mul, "df_div": _twin_div}


@pytest.mark.parametrize("op", ["two_prod", "df_add", "df_mul", "df_div",
                                "df_sqrt"])
def test_df32_header_matches_the_twins_on_the_host(shim, op):
    """A transcription fault in df32.cuh shows here, before any card is
    involved: each function, compiled for the host, bit for bit against
    its PyTorch twin (df_div's twin is the trace kernel's ``_df_div``).
    df_sqrt starts from the correctly rounded root (``__fsqrt_rn``);
    ``torch.sqrt`` on the CPU is one ulp off it on a few inputs in a
    thousand, and there the two Newton-corrected results may differ in
    their last bits: bit-equal where the first guesses agree, within 2^-44
    elsewhere."""
    (xh, xl), (yh, yl) = _df_operands()
    t = torch.from_numpy
    same_guess = slice(None)
    if op == "two_prod":
        a, b = PAIRS["random"]()
        a = np.concatenate([a, PAIRS["special"]()[0]])
        b = np.concatenate([b, PAIRS["special"]()[1]])
        got = _call(shim.shim_two_prod, a, b)
        want = tpr.two_prod(t(a), t(b))
    elif op == "df_sqrt":
        xh, xl = np.abs(xh), np.where(xh < 0, -xl, xl)
        got = _call(shim.shim_df_sqrt, xh, xl)
        want = tpr.df_sqrt(tpr.DF(t(xh), t(xl)))
        rounded = np.sqrt(xh.astype(np.float64)).astype(F32)
        same_guess = torch.sqrt(t(xh)).numpy() == rounded
        assert same_guess.mean() > 0.98
        g64, w64 = (h.astype(np.float64) + lo for h, lo in
                    (got, (want.hi.numpy(), want.lo.numpy())))
        assert np.abs(g64 / w64 - 1.0).max() <= 2.0 ** -44
    else:
        got = _call(getattr(shim, f"shim_{op}"), xh, xl, yh, yl)
        want = _TWINS[op](tpr.DF(t(xh), t(xl)), tpr.DF(t(yh), t(yl)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.int32)[same_guess],
                                      w.numpy().view(np.int32)[same_guess])
