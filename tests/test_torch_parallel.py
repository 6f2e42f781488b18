"""akbx_torch.parallel against akbx: ray-sharded trace, sharded and ring
Huygens, streamed fans, the sharded FFT and PSF, the sharded train step and
the dry run.

The multi-rank paths run once per module, in a gloo world of four spawned
CPU processes (``tests/torch_parallel_worker.py``, which imports no jax);
the tests below assert on what rank 0 returns.  Per-ray results are
gathered over the ranks first.  To spare XLA:CPU compiles, the port's
sharded outputs are held against akbx's unsharded functions (akbx's own
tests/test_sharding.py holds akbx's sharded outputs against those), and the
FFT against akbx's ``make_fft2`` on the conftest's 8-device CPU mesh.
Bars are akbx's: tests/test_sharding.py, test_batching.py, test_fft.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from akbx import trace as jtr, wave as jwave
from akbx.analysis import psf as jpsf
from akbx.parallel import fft as jfft
from akbx.parallel import sharding as jsh
from akbx.systems import (AlignParams as JAlign, WOLTER_3_1_DEFAULT as JSPEC,
                          build_wolter_3_1 as jbuild)

import torch_parallel_worker as worker
from akbx_torch import convert
from akbx_torch.parallel import dryrun
from akbx_torch.parallel import sharding as sh

WORLD = 4
RNG = np.random.default_rng(21)


def _huygens_inputs():
    def cloud(x0, n):
        return np.array([x0, 0.0, 0.0])[:, None] + RNG.normal(size=(3, n)) * 0.01

    src, tgt = cloud(1.0, 96), cloud(1.5, 160)
    u0 = np.exp(1j * RNG.uniform(0, 2 * np.pi, 96))
    out = {"huygens": {"src": src, "tgt": tgt, "u_re": u0.real,
                       "u_im": u0.imag, "ds": np.full(96, 1e-6)}}
    for key, (m, n) in (("ring", (128, 128)), ("ring_ragged", (100, 90))):
        u = np.exp(1j * RNG.uniform(0, 2 * np.pi, m)) * 1e-6
        out[key] = {"src": cloud(1.0, m), "tgt": cloud(1.5, n),
                    "w_re": u.real, "w_im": u.imag}
    return out


def _fft_inputs():
    y = np.linspace(-1, 1, 48)
    amp = np.ones((48, 48))
    amp[0, :] = np.nan  # NaN handling must match
    y16 = np.linspace(-1, 1, 16)
    amp16 = np.ones((16, 16))
    amp16[0, :] = np.nan
    return {"u": RNG.normal(size=(64, 48)) + 1j * RNG.normal(size=(64, 48)),
            "v": RNG.normal(size=(32, 32)) + 1j * RNG.normal(size=(32, 32)),
            "r": RNG.normal(size=(40, 24)) + 0j,
            "x": RNG.normal(size=(16, 16)),
            "w": RNG.normal(size=(16, 16)) + 1j * RNG.normal(size=(16, 16)),
            "opd": 5e-9 * np.add.outer(y**2, y**2), "amp": amp,
            "opd16": 5e-9 * np.add.outer(y16**2, y16**2), "amp16": amp16}


def _train_inputs():
    figures = [np.zeros((3, 3)) for _ in range(4)]
    figures[0][1, 0] = 5e-9  # a 5 nm tilt-like error, as akbx's test
    figures[2] += np.random.default_rng(5).normal(0.0, 1e-10, (3, 3))
    params = {"align": np.zeros(26), "figures": figures}
    rng = np.random.default_rng(6)

    def tree(scale):
        return {"align": np.abs(rng.normal(0.0, scale, 26)),
                "figures": [np.abs(rng.normal(0.0, scale, (3, 3)))
                            for _ in range(4)]}

    # a mid-run Adam state, in optax's structure
    return {"params": params,
            "adam": {"mu": tree(1e3), "nu": tree(1e12), "count": 3}}


INPUTS = {**_huygens_inputs(), "fft": _fft_inputs(),
          "train": _train_inputs()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Rank 0's results of every task, and every rank's, from one gloo
    world of WORLD spawned processes."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    procs = [ctx.Process(target=worker.run,
                         args=(r, WORLD, store, INPUTS, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        got = dict(queue.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r, v in got.items():
        assert not isinstance(v, str), f"rank {r} failed:\n{v}"
    assert all(p.exitcode == 0 for p in procs)
    return got


@pytest.fixture(scope="module")
def jsys():
    return jbuild(JSPEC, JAlign.zeros())


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


# --- sharding ----------------------------------------------------------------

def test_shard_rays_and_gather(ranks):
    """shard_rays gives each rank its contiguous columns (akbx's layout:
    blocks in rank order, padded to a multiple of P * multiple and
    trimmed), and gather_rays puts them back, bools included."""
    a = np.arange(3 * 99, dtype=np.float64).reshape(3, 99)
    for multiple, widths in ((1, [25, 25, 25, 24]), (8, [32, 32, 32, 3])):
        got = ranks[0]["shard"][multiple]
        assert [ranks[r]["shard_widths"][multiple] if r else got[0]
                for r in range(WORLD)] == widths
        np.testing.assert_array_equal(got[1], a)
        np.testing.assert_array_equal(got[2], a[0])
        np.testing.assert_array_equal(got[3], a[0] > 150)


def test_sharded_trace_matches_akbx_unsharded(ranks, jsys):
    """akbx's tests/test_sharding.py case at a ragged fan (99 rays on 4
    ranks): every ray at 1e-12 m of akbx's unsharded f64 run, and the
    per-ray outputs really sharded (widths 25, 25, 25, 24)."""
    got = ranks[0]["trace"][("f64", "sharded")]
    j = jtr.run(jsys, worker.N_H, worker.N_V, defocus=0.0,
                exit_pupil_uniform=False, tilt_correction=False)
    np.testing.assert_allclose(got["detcenter"], np.asarray(j.detcenter),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got["valid"], np.asarray(j.valid))
    widths = [ranks[r]["trace_widths"][("f64", "sharded")]
              if r else got["width"] for r in range(WORLD)]
    assert widths == [25, 25, 25, 24]


@pytest.mark.parametrize("case", sorted(set(worker.TRACE_CASES)
                                         - {"pallas_refan_tilt"}))
def test_sharded_trace_matches_unsharded(ranks, case):
    """The f64 and df32 engines, with the tilt removal (mean and extremes)
    and the exit-pupil re-fan, sharded against the same run unsharded: the
    re-fan's centre row and column are gathered from their ranks and the
    reductions are summed over the ranks, so only the order of the sums
    differs (bars 1e-12 m, 1e-12 rad; wave2 1e-6 nm)."""
    s, u = (ranks[0]["trace"][(case, k)] for k in ("sharded", "unsharded"))
    for f in ("detcenter", "detcenter2"):
        np.testing.assert_allclose(s[f], u[f], rtol=0, atol=1e-12)
    for f in ("total_dist", "total_dist2"):
        np.testing.assert_allclose(s[f] - s[f].mean(), u[f] - u[f].mean(),
                                   rtol=0, atol=1e-12)
    np.testing.assert_allclose(s["wave2"], u["wave2"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(s["valid"], u["valid"])
    for f in ("rand_p0h", "rand_p0v"):
        np.testing.assert_array_equal(s[f], u[f])
    for f in ("theta_y", "theta_z", "focus_apprx"):
        np.testing.assert_allclose(s[f], u[f], rtol=0, atol=1e-12)
    np.testing.assert_allclose(s["spot"], u["spot"], rtol=1e-10)


def test_sharded_pallas_route_matches_f64_engine(ranks):
    """Sharded, precision='pallas' traces each shard on K1 (here its twin)
    against the whole fan's chief ray and finishes in f64, akbx's route
    (unsharded, it runs the fast engine): it holds the fast engine's bars
    against the f64 engine and against the fast engine (detcenter 5e-9 m,
    demeaned OPL 1e-9 m, valid identical)."""
    s = ranks[0]["trace"][("pallas_refan_tilt", "sharded")]
    for case in ("f64_refan_tilt", "pallas_refan_tilt"):
        u = ranks[0]["trace"][(case, "unsharded")]
        np.testing.assert_allclose(s["detcenter"], u["detcenter"], rtol=0,
                                   atol=5e-9)
        np.testing.assert_allclose(s["total_dist"] - s["total_dist"].mean(),
                                   u["total_dist"] - u["total_dist"].mean(),
                                   rtol=0, atol=1e-9)
        np.testing.assert_array_equal(s["valid"], u["valid"])


def _jfield(h):
    return jwave.WaveField.from_complex(h["src"], h["u_re"] + 1j * h["u_im"],
                                        h["ds"])


def test_huygens_sharded_matches_akbx(ranks):
    """Targets sharded in blocks of 128 (160 targets: 128, 32, 0, 0),
    source replicated; akbx's bars (rtol 1e-10, atol 1e-12)."""
    h = INPUTS["huygens"]
    re, im, _ = ranks[0]["huygens"]["sharded"]
    jre, jim = jwave.propagate(_jfield(h), jnp.asarray(h["tgt"]),
                               worker.WAVELENGTH, chunk=64, use_pallas=False)
    np.testing.assert_allclose(re, np.asarray(jre), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(im, np.asarray(jim), rtol=1e-10, atol=1e-12)
    widths = [ranks[r]["huygens_widths"]["sharded"] if r
              else ranks[0]["huygens"]["sharded"][2] for r in range(WORLD)]
    assert widths == [128, 32, 0, 0]


@pytest.mark.parametrize("key", ["ring", "ring_ragged"])
def test_huygens_ring_matches_akbx(ranks, key):
    """Sources and targets sharded, source blocks passed round the ring
    (zero-weight padding on the ragged 100 sources, 90 targets); akbx's
    bars (rtol 1e-9, atol 1e-11)."""
    d = INPUTS[key]
    re, im, _ = ranks[0]["huygens"][key]
    field = jwave.WaveField(jnp.asarray(d["src"]), jnp.asarray(d["w_re"]),
                            jnp.asarray(d["w_im"]),
                            jnp.ones(d["src"].shape[1]), 0, 0)
    jre, jim = jwave.propagate(field, jnp.asarray(d["tgt"]),
                               worker.WAVELENGTH, chunk=64, use_pallas=False)
    np.testing.assert_allclose(re, np.asarray(jre), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(im, np.asarray(jim), rtol=1e-9, atol=1e-11)
    # with the spans on: one ring, P sums, P - 1 waits; the same fields
    got = ranks[0]["huygens"][key + "_spans"]
    assert got["paths"] == sorted(["ring"] + ["ring/ring.sum"] * WORLD
                                  + ["ring/ring.wait"] * (WORLD - 1))
    assert got["same"]


# --- batching ----------------------------------------------------------------

def test_spot_stats_match_akbx():
    """SpotStats' zero, merge and moments against akbx's on the same
    sums."""
    from akbx.parallel import batching as jb
    from akbx_torch.parallel import batching as tb

    rng = np.random.default_rng(9)
    blocks = [(float(n), rng.normal(size=2), rng.uniform(1, 2, 2) * n,
               rng.normal(), rng.uniform(1, 2) * n, rng.normal(size=2),
               rng.normal(size=2) + 3) for n in (5, 7)]
    t, j = tb.SpotStats.zero("cpu"), jb.SpotStats.zero()
    for b in blocks:
        t = t.merge(tb.SpotStats(*(torch.as_tensor(np.asarray(x))
                                   for x in b)))
        j = j.merge(jb.SpotStats(*(jnp.asarray(x) for x in b)))
    for f in ("centroid", "spot_std", "opl_std", "min_yz", "max_yz", "n"):
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), rtol=1e-15)


def test_trace_streamed_matches_unstreamed(ranks, jsys):
    """A 16x24 fan in blocks of 7 rows (an uneven, NaN-padded tail block)
    sharded over 4 ranks: akbx's bars against the unstreamed f64 run
    (count exact, centroid and extremes rtol 1e-8, std 1e-6), against
    akbx's and the port's; progress is called once per block."""
    st = ranks[0]["streamed"]
    j = jtr.run(jsys, 16, 24, defocus=0.0, exit_pupil_uniform=False,
                tilt_correction=False)
    for det, valid in ((np.asarray(j.detcenter), np.asarray(j.valid)),
                       (st["det"], st["valid"])):
        yz = det[1:3, valid]
        assert st["n"] == valid.sum()
        np.testing.assert_allclose(st["centroid"], yz.mean(axis=1),
                                   rtol=1e-8)
        np.testing.assert_allclose(st["spot_std"], yz.std(axis=1),
                                   rtol=1e-6)
        np.testing.assert_allclose(st["min_yz"], yz.min(axis=1), rtol=1e-8)
        np.testing.assert_allclose(st["max_yz"], yz.max(axis=1), rtol=1e-8)
    np.testing.assert_allclose(st["opl_std"], float(jnp.std(j.total_dist)),
                               rtol=1e-6)
    assert st["calls"] == [(b, 4) for b in range(1, 5)]


# --- fft -------------------------------------------------------------------

def _jmesh():
    return jsh.ray_mesh(8, devices=jax.devices("cpu")[:8])


def test_sharded_fft2_matches_akbx(ranks):
    """fft2, ifft2 and their round trip at akbx's bars; the output stays
    row-sharded (16 of 64 rows on each rank); sides not divisible by the
    mesh raise."""
    f, got = INPUTS["fft"], ranks[0]["fft"]
    want = np.asarray(jfft.make_fft2(_jmesh())(jnp.asarray(f["u"])))
    np.testing.assert_allclose(got["fft2"], want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got["fft2"], np.fft.fft2(f["u"]), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(got["ifft2"], np.fft.ifft2(f["v"]),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["roundtrip"], f["r"], atol=1e-10)
    assert [ranks[r]["fft_local_shape"] if r else got["fft2_local_shape"]
            for r in range(WORLD)] == [(16, 48)] * WORLD
    assert len(got["raised"]) == 2
    assert all("divisible" in e for e in got["raised"])


def test_sharded_fft2_vjp(ranks):
    """The sharded transform's backward (torch's conjugate convention)
    against torch.fft.fft2's own autograd and akbx's jax.grad, at 1e-9."""
    f, got = INPUTS["fft"], ranks[0]["fft"]
    fft2 = jfft.make_fft2(_jmesh())
    w = jnp.asarray(f["w"])

    def f_akbx(x):
        return jnp.abs(jnp.sum(w * fft2(x.astype(jnp.complex128)))) ** 2

    g_j = np.asarray(jax.grad(f_akbx)(jnp.asarray(f["x"])))
    np.testing.assert_allclose(got["vjp"], got["vjp_torch"], rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(got["vjp"], g_j, rtol=1e-9, atol=1e-9)


def test_psf_fft_sharded_matches_akbx(ranks):
    """The sharded PSF against akbx's unsharded compute_psf_fft (values
    rtol 1e-8, coordinates exact-ish), and the gradient of one pixel at
    akbx's bar (rtol 1e-7)."""
    f, got = INPUTS["fft"], ranks[0]["fft"]
    args = (13.5e-9, 1e-4, 0.1)
    i1, x1, y1 = jpsf.compute_psf_fft(f["opd"], f["amp"], *args,
                                      pad_factor=2)
    np.testing.assert_allclose(got["psf"][0], np.asarray(i1), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(got["psf"][1], np.asarray(x1), rtol=1e-12)
    np.testing.assert_allclose(got["psf"][2], np.asarray(y1), rtol=1e-12)
    amp16 = jnp.asarray(f["amp16"])

    def pixel(opd):
        img, _, _ = jpsf.compute_psf_fft(opd, amp16, *args, pad_factor=2)
        return img[10, 10]

    g_j = np.asarray(jax.grad(pixel)(jnp.asarray(f["opd16"])))
    np.testing.assert_allclose(got["psf_grad"], g_j, rtol=1e-7, atol=1e-12)


# --- the train step ---------------------------------------------------------

@pytest.fixture(scope="module")
def akbx_train():
    """akbx's gradient of its train-step loss at the same parameters
    (jax.grad through its f64 engine) and its Adam update from the same
    optax state."""
    def loss_fn(sys_, res):  # worker.loss_fn_for's
        w = res.total_dist - jtr.masked_mean(res.total_dist, res.valid)
        return jnp.sum(jnp.where(res.valid, w, 0.0) ** 2) * 1e18

    opt = optax.adam(worker.LR)
    _, loss, _ = jsh.make_train_step(JSPEC, loss_fn, opt, worker.TRAIN_FAN,
                                     worker.TRAIN_FAN, None)
    t = INPUTS["train"]
    params = jax.tree.map(jnp.asarray, t["params"])
    grads = jax.jit(jax.grad(loss), compiler_options={
        "xla_backend_optimization_level": 0})(params)
    a = t["adam"]
    state = opt.init(params)
    state = (state[0]._replace(count=jnp.asarray(a["count"], jnp.int32),
                               mu=jax.tree.map(jnp.asarray, a["mu"]),
                               nu=jax.tree.map(jnp.asarray, a["nu"])),
             *state[1:])
    updates, _ = opt.update(grads, state, params)
    return {"grads": grads, "state": state, "params": params, "opt": opt,
            "after": optax.apply_updates(params, updates)}


def _leaves(tree):
    return [np.asarray(x) for x in sh.param_list(tree)]


def test_train_step_loss_non_increasing(ranks):
    """akbx's train-step case at a 9x9 fan over 4 ranks: two Adam steps on
    a perturbed figure, the loss finite and non-increasing."""
    l0, l1, l2 = ranks[0]["train"]["losses"]
    assert np.isfinite([l0, l1, l2]).all()
    assert l1 == pytest.approx(l0, rel=1e-12)
    assert l2 <= l0 * 1.001


# The sharded gradient sums each rank's rays and then the ranks, the
# unsharded one all rays at once.  The per-ray terms of this loss's gradient
# cancel ~1e6-fold, so the two sum orders alone move each group by up to
# ~1e-9 of its largest component (measured 2.2e-11 to 8.4e-10 at 4 ranks on
# the CPU, with and without tilt removal and pivoted OPL); one rank sums in
# the one order (chip_smoke.py's [15] holds 1e-12 there).  A P-fold or
# 1/P-fold gradient, or one missing the other ranks' rays, is off by O(1).
GRAD_SHARD_REL = 1e-8


def test_train_step_gradient_equals_unsharded(ranks):
    """The reduced gradient on every rank is the unsharded gradient, to
    the sum order's rounding (GRAD_SHARD_REL of each group's largest
    component): a P-fold or 1/P-fold error, or a missing sum over the
    ranks, fails."""
    t = ranks[0]["train"]
    for r in range(WORLD):
        grads = ranks[r]["train_grads"] if r else t["grads"]
        for g, u in zip(grads, t["grads_unsharded"], strict=True):
            assert _rel(g, u) <= GRAD_SHARD_REL
            assert _rel(g * WORLD, u) > 1 and _rel(g / WORLD, u) > 0.5


def test_train_step_gradient_matches_akbx(ranks, akbx_train):
    """Against akbx's jax.grad through its f64 engine: each component at
    1e-3, floor 1e-6 of the largest (akbx's gradient bar)."""
    j = _leaves(akbx_train["grads"])
    scale = max(np.abs(x).max() for x in j)
    for g, w in zip(ranks[0]["train"]["grads"], j, strict=True):
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-6 * scale)


def test_adam_state_from_optax(akbx_train):
    """optax's Adam state carried into torch.optim.Adam: with akbx's
    gradient, one torch step lands where one optax step does."""
    t = INPUTS["train"]
    params = convert.train_params_from_numpy(t["params"], "cpu")
    a = t["adam"]
    opt = convert.adam_state_from_optax(
        torch.optim.Adam(sh.param_list(params), lr=worker.LR), a["mu"],
        a["nu"], a["count"])
    for p, g in zip(sh.param_list(params), _leaves(akbx_train["grads"])):
        p.grad = torch.tensor(g)
    opt.step()
    for p, want, p0 in zip(sh.param_list(params),
                           _leaves(akbx_train["after"]),
                           _leaves(t["params"])):
        np.testing.assert_allclose(p.detach().numpy() - p0, want - p0,
                                   rtol=1e-12, atol=1e-24)


def test_train_step_from_akbx_state(ranks, akbx_train):
    """One sharded port step from akbx's converted Adam state is akbx's
    optax step on the port's gradient (1e-12 of each update), a gradient
    that is akbx's own at akbx's bar (test_train_step_gradient_matches_
    akbx; Adam normalizes each component by its own history, so a bar on
    the gradient is not one on the step)."""
    t, a = ranks[0]["train"], akbx_train
    grads = {"align": jnp.asarray(t["grads_akbx_state"][0]),
             "figures": [jnp.asarray(g) for g in t["grads_akbx_state"][1:]]}
    updates, _ = a["opt"].update(grads, a["state"], a["params"])
    want = _leaves(optax.apply_updates(a["params"], updates))
    for got, w, p0 in zip(t["after_akbx_state"], want,
                          _leaves(INPUTS["train"]["params"]), strict=True):
        np.testing.assert_allclose(got - p0, w - p0, rtol=1e-12,
                                   atol=1e-24)
    for g, u in zip(t["grads_akbx_state"], t["grads_unsharded"]):
        assert _rel(g, u) <= GRAD_SHARD_REL


# --- the dry run ------------------------------------------------------------

def test_dryrun(ranks, tmp_path):
    """The dry run at world size 1 in process (gloo) and at 4 ranks: a
    finite loss, the same on both."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        one = dryrun.dryrun(sh.ray_mesh(device_type="cpu"))
    finally:
        dist.destroy_process_group()
    four = ranks[0]["train"]["dryrun"]
    assert np.isfinite(one) and np.isfinite(four)
    assert four == pytest.approx(one, rel=1e-12)


def test_convert_train_params():
    """akbx's parameter dict becomes leaf tensors that take a gradient."""
    t = INPUTS["train"]["params"]
    p = convert.train_params_from_numpy(t, "cpu")
    assert p["align"].requires_grad and p["align"].shape == (26,)
    assert [f.shape for f in p["figures"]] == [(3, 3)] * 4
    np.testing.assert_array_equal(p["figures"][0].detach().numpy(),
                                  t["figures"][0])
    assert all(x.is_leaf for x in sh.param_list(p))


def test_compute_psf_fft_default_transform_unchanged():
    """compute_psf_fft's new ``fft2_shifted_fn``: left at None it runs the
    transform it always ran, bit for bit the same as passing that
    transform in, and still akbx's at 1e-8."""
    from akbx_torch.analysis import psf as tpsf

    f = INPUTS["fft"]
    opd, amp = torch.as_tensor(f["opd"]), torch.as_tensor(f["amp"])
    args = (13.5e-9, 1e-4, 0.1)
    default = tpsf.compute_psf_fft(opd, amp, *args, return_efield=True)
    given = tpsf.compute_psf_fft(
        opd, amp, *args, return_efield=True,
        fft2_shifted_fn=lambda u: torch.fft.fftshift(
            torch.fft.fft2(torch.fft.ifftshift(u))))
    for a, b in zip(default, given, strict=True):
        assert torch.equal(a, b)
    i1, _, _ = jpsf.compute_psf_fft(f["opd"], f["amp"], *args)
    np.testing.assert_allclose(default[0].numpy(), np.asarray(i1),
                               rtol=1e-8, atol=1e-10)
