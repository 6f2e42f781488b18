"""Parity of the K3 twin (akbx_torch.kernels.huygens) with akbx's Pallas
Huygens kernel, run in interpret mode as tests/test_kernels.py runs it,
and with akbx's exact f64 path.  Both packages get the same numpy inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from akbx import wave as jw
from akbx.kernels import huygens as jh
from akbx_torch import wave as tw
from akbx_torch.kernels import huygens as th

torch.set_num_threads(2)

EUV = 13.5e-9
HARD = 0.135e-9
# akbx's bars for its df32 kernel against the f64 path
# (tests/test_kernels.py): 1e-5 relative at EUV, 2e-3 at 0.135 nm, where
# the phases are 100x larger
BAR = {EUV: 1e-5, HARD: 2e-3}


def _cloud(n_src=600, n_tgt=500, seed=0):
    """tests/test_kernels.py::_mk as numpy: sources near 145 m, targets
    near 146 m, random complex field, ds ~1e-8."""
    rng = np.random.default_rng(seed)
    src_pts = (np.array([145.0, 0.02, 0.0])[:, None]
               + rng.normal(size=(3, n_src)) * 0.05)
    tgt_pts = (np.array([146.0, 0.05, 0.01])[:, None]
               + rng.normal(size=(3, n_tgt)) * 0.02)
    u = rng.normal(size=n_src) + 1j * rng.normal(size=n_src)
    ds = np.abs(rng.normal(size=n_src)) * 1e-8
    return src_pts, u, ds, tgt_pts


def _both(src_pts, u, ds):
    return (jw.WaveField.from_complex(src_pts, u, ds),
            tw.WaveField.from_complex(src_pts, u, ds, device="cpu"))


def _c(re, im):
    return np.asarray(re) + 1j * np.asarray(im)


@pytest.mark.parametrize("lam", [EUV, HARD], ids=["euv", "hard_xray"])
@pytest.mark.parametrize("shape", [(600, 500, 0, None), (77, 45, 3, 16)],
                         ids=["600x500", "77x45_chunk16"])
def test_twin_matches_akbx_pallas_and_f64(lam, shape):
    """The twin (backend='pallas' on CPU tensors) against akbx's kernel
    (interpret mode; at 77 x 45 with akbx's tiles and the twin's target
    chunk forced small) and against akbx's f64 path, <= akbx's bars."""
    n_src, n_tgt, seed, chunk = shape
    src_pts, u, ds, tgt = _cloud(n_src, n_tgt, seed)
    js, ts = _both(src_pts, u, ds)
    tiles = dict(target_tile=16, source_tile=32) if chunk else {}
    j = _c(*jh.propagate_pallas(js, jnp.asarray(tgt), lam, interpret=True,
                                **tiles))
    x = _c(*jw.propagate(js, jnp.asarray(tgt), lam, backend="xla"))
    t = _c(*th.propagate_pallas(ts, torch.from_numpy(tgt), lam, chunk=chunk))
    scale = np.abs(x).max()
    assert np.abs(t - j).max() / scale < BAR[lam]
    assert np.abs(t - x).max() / scale < BAR[lam]
    if chunk is None:
        via = _c(*tw.propagate(ts, torch.from_numpy(tgt), lam,
                               backend="pallas"))
        np.testing.assert_array_equal(via, t)


@pytest.mark.parametrize("lam", [EUV, HARD], ids=["euv", "hard_xray"])
def test_per_pair_terms_match_akbx_kernel_and_exact(lam):
    """With one source, each target's sum is one f32 term.  On the same
    re-centred f64 geometry, the twin's df32 distance, phase reduction and
    sincos against akbx's kernel body and against the exact term of the
    same f32-split inputs (mpmath, 200 bits), <= akbx's bars.  Twin and
    akbx differ by ~4e-6 rad of phase at EUV, each ~3e-6 from exact: the
    df32 phase keeps ~2^-47 of k r, and XLA may contract df_mul's cross
    term where the twin rounds twice."""
    import mpmath

    src_pts, u, ds, tgt = _cloud(1, 500, 5)
    center = np.concatenate([src_pts, tgt], axis=1).mean(axis=1,
                                                         keepdims=True)
    src_c, tgt_c = src_pts - center, tgt - center
    w = (u * ds).real, (u * ds).imag
    k = 2 * np.pi / lam
    k_pair = np.array([np.float32(k), np.float32(k - float(np.float32(k)))])
    j = _c(*jh._huygens_pallas(jnp.asarray(tgt_c), jnp.asarray(src_c),
                               *[jnp.asarray(x) for x in w],
                               jnp.asarray(k_pair), interpret=True))
    t = _c(*th._huygens_pallas(torch.from_numpy(tgt_c),
                               torch.from_numpy(src_c),
                               *[torch.from_numpy(x) for x in w],
                               torch.from_numpy(k_pair)))
    scale = np.abs(j).max()
    assert np.abs(t - j).max() <= BAR[lam] * scale

    mpmath.mp.prec = 200

    def mp(x):  # an f64 value as the kernel sees it: its f32 (hi, lo)
        hi = float(np.float32(x))
        return mpmath.mpf(hi) + mpmath.mpf(float(np.float32(float(x) - hi)))

    kk = mp(k)
    wr, wi = (mpmath.mpf(float(np.float32(x[0]))) for x in w)
    for i in range(0, 500, 25):
        r = mpmath.sqrt(sum((mp(tgt_c[a, i]) - mp(src_c[a, 0])) ** 2
                            for a in range(3)))
        c, s = mpmath.cos(kk * r), -mpmath.sin(kk * r)
        exact = complex((c * wr - s * wi) / r, (s * wr + c * wi) / r)
        assert abs(t[i] - exact) <= BAR[lam] * scale


def test_tile_sums_partition():
    """f32 sums over tiles of TILE sources, added in tile order into an
    f32 total (as akbx's kernel keeps its f32 output across source tiles),
    with a ragged last tile and any target chunk; zero sources sum to
    zero."""
    src_pts, u, ds, tgt = _cloud(2 * th.TILE + 37, 50, 2)
    ts = tw.WaveField.from_complex(src_pts, u, ds, device="cpu")
    tgt_r, src_r, w, k_pair = th.kernel_args(ts, torch.from_numpy(tgt), EUV)
    k = th.DF(k_pair[0], k_pair[1])
    t = [th.DF(tgt_r[2 * r, :, None], tgt_r[2 * r + 1, :, None])
         for r in range(3)]
    want = torch.zeros(2, 50, dtype=torch.float32)
    for a in range(0, src_r.shape[1], th.TILE):
        s = [th.DF(src_r[2 * r, None, a:a + th.TILE],
                   src_r[2 * r + 1, None, a:a + th.TILE]) for r in range(3)]
        re, im = th.pair_terms(t, s, w[0, None, a:a + th.TILE],
                               w[1, None, a:a + th.TILE], k)
        want += torch.stack([re.sum(dim=-1), im.sum(dim=-1)])
    for chunk in (None, 7):
        got = th.huygens_reference(tgt_r, src_r, w, k_pair, chunk=chunk)
        for g, x in zip(got, want):
            assert g.dtype == torch.float64
            torch.testing.assert_close(g, x.double(), rtol=0, atol=0)
    re, im = th.huygens_reference(torch.zeros(6, 4), torch.zeros(6, 0),
                                  torch.zeros(2, 0), torch.ones(2))
    assert re.dtype == torch.float64 and not re.any() and not im.any()
    re, _ = th.huygens_reference(torch.zeros(6, 0), torch.zeros(6, 3),
                                 torch.zeros(2, 3), torch.ones(2))
    assert re.shape == (0,)


def test_wrapper_runs_twin_on_cpu_without_launch():
    src_pts, u, ds, tgt = _cloud(40, 30, 1)
    ts = tw.WaveField.from_complex(src_pts, u, ds, device="cpu")
    before = th.huygens.launches
    args = th.kernel_args(ts, torch.from_numpy(tgt), EUV)
    a = th.huygens(*args)
    b = th.huygens_reference(*args)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert th.huygens.launches == before


def test_wavenumber_pair_stays_on_the_host():
    """``kernel_args`` keeps k's f32 pair on the host (the kernel takes it
    by value), and the wrapper refuses one that is elsewhere."""
    src_pts, u, ds, tgt = _cloud(5, 4, 3)
    ts = tw.WaveField.from_complex(src_pts, u, ds, device="cpu")
    args = th.kernel_args(ts, torch.from_numpy(tgt), EUV)
    assert args[3].device.type == "cpu" and args[3].dtype == torch.float32
    k = 2 * np.pi / EUV
    assert float(args[3][0].double() + args[3][1].double()) == pytest.approx(
        k, rel=2.0 ** -45)
    with pytest.raises(ValueError, match="host"):
        th.huygens(*args[:3], torch.zeros(2, device="meta"))


def test_wrapper_rejects_other_devices():
    t = torch.zeros(6, 8, device="meta")
    with pytest.raises(ValueError):
        th.huygens(t, t, torch.zeros(2, 8, device="meta"),
                   torch.zeros(2, device="meta"))
    with pytest.raises(ValueError):
        th.huygens(torch.zeros(6, 8), t, torch.zeros(2, 8, device="meta"),
                   torch.zeros(2))
