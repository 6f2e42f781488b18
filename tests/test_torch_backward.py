"""The fast engine's backward: gradients of the bench loss through
``trace.run(precision="pallas")`` against akbx's ``jax.grad`` of the same
loss, and within the port against its f64 engine, at a 9x9 fan; the
backward launches no kernel; ``trace_pallas`` differentiates as
``trace_dev32``.  The port's backward twin runs in float64, akbx's in
float32 (ROADMAP F6).

Bar, akbx's own (tests/test_trace_pallas.py): |g - g_ref| below 1e-3 of
|g_ref|, floored at 1e-6 of the gradient's largest entry."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from akbx import systems as jsys
from akbx import trace as jtr
from akbx_torch import systems as tsys
from akbx_torch import trace as ttr

torch.set_num_threads(2)

N = 9
SEEDED = np.random.default_rng(1).normal(0.0, 1e-5, 26)
VECS = {"zero": np.zeros(26), "seeded": SEEDED}
GRAD_REL = 1e-3


def _loss(mod, res, dev_fields):
    """bench_common.make_step's losses: on the f32 deviation fields
    (``dev_fields``) or on the f64 fields."""
    tr = jtr if mod == "akbx" else ttr
    where = jnp.where if mod == "akbx" else torch.where
    total = jnp.sum if mod == "akbx" else torch.sum
    if dev_fields:
        w, det = res.w32, res.ddet32
    else:
        w = res.total_dist - tr.masked_mean(res.total_dist, res.valid)
        det = res.detcenter
    sy, sz = tr.spot_size(det, res.valid)
    return total(where(res.valid, w, 0.0) ** 2) * 1e18 + sy + sz


def port_grad(vec, precision="pallas", dev_fields=True, **kw):
    v = torch.tensor(vec, dtype=torch.float64, requires_grad=True)
    s = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                              tsys.AlignParams.from_vector(v))
    kw.setdefault("exit_pupil_uniform", False)
    res = ttr.run(s, N, N, defocus=v[0], precision=precision, **kw)
    _loss("port", res, dev_fields and precision == "pallas").backward()
    return v.grad.numpy()


def rel_err(g, ref):
    scale = np.abs(ref).max()
    return float((np.abs(g - ref)
                  / np.maximum(np.abs(ref), scale * 1e-6)).max())


@pytest.fixture(scope="module")
def akbx_grads():
    """akbx's jax.grad of the deviation-field bench loss through
    precision='pallas' (its plain-f32 twin's VJP), one compile for both
    vectors.  XLA compiles it at its lowest optimization level: the same
    function with fewer compiler passes, ~150 s on one core instead of
    ~185 s."""
    def loss(vec):
        s = jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT,
                                  jsys.AlignParams.from_vector(vec))
        res = jtr.run(s, N, N, defocus=vec[0], exit_pupil_uniform=False,
                      precision="pallas")
        return _loss("akbx", res, True)

    grad = jax.jit(jax.grad(loss), compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})
    return {k: np.asarray(grad(jnp.asarray(v))) for k, v in VECS.items()}


@pytest.mark.parametrize("which", sorted(VECS))
def test_grad_matches_akbx(akbx_grads, which):
    """The same loss and precision in both packages: akbx's float32 twin
    carries its rounding, the port's float64 twin next to none, so the
    two sit as far apart as akbx's gradient from the f64 engine's
    (measured 4.4e-4 at zero, 4.8e-4 seeded; with a float32 twin in the
    port, 5.7e-4 and 6.0e-4).  The gradient is dense, and exactly 0 only
    where the f64 engine's is (at zero 3 channels, components 6, 18 and
    25: with the tilt angles reduced in f32, ROADMAP F9, one of them took
    rounding noise)."""
    g = port_grad(VECS[which])
    assert np.isfinite(g).all() and np.count_nonzero(g) >= 23
    g64 = port_grad(VECS[which], precision="f64")
    assert ((g == 0) <= (g64 == 0)).all()
    assert rel_err(g, akbx_grads[which]) < GRAD_REL


@pytest.mark.parametrize("which", sorted(VECS))
def test_grad_matches_port_f64(which):
    """The f64-field loss through the fast path against the f64 engine's
    (akbx's TestBackward::test_grad_matches_f64_path, within the port;
    measured 5.5e-7 at zero, 9.7e-7 seeded)."""
    g64 = port_grad(VECS[which], precision="f64")
    assert rel_err(port_grad(VECS[which], dev_fields=False), g64) < GRAD_REL


@pytest.mark.parametrize("which", sorted(VECS))
def test_dev_loss_grad_matches_f64_field_loss(which):
    """The deviation-field loss and the f64-field loss through the fast
    path share one twin VJP (akbx's test_dev_loss_grad_matches; measured
    2.0e-7 at zero, 1.2e-7 seeded)."""
    g_dev = port_grad(VECS[which])
    assert rel_err(g_dev, port_grad(VECS[which], dev_fields=False)) < GRAD_REL


@pytest.mark.parametrize("kw", [dict(tilt_correction=False),
                                dict(tilt_mode="extremes")],
                         ids=["no_tilt", "extremes"])
def test_grad_options_match_port_f64(kw):
    """Without tilt removal, and with the extremes beam-axis estimator:
    the fast path's gradient against the f64 engine's (measured 6.9e-7
    and 6.8e-7)."""
    g64 = port_grad(SEEDED, precision="f64", **kw)
    assert rel_err(port_grad(SEEDED, dev_fields=False, **kw), g64) < GRAD_REL


class _Counting:
    """Stands in for the kernel module and counts each wrapper's calls."""

    def __init__(self, module):
        self._module = module
        self.calls = {"trace_deviation": 0, "detector": 0}

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if name not in self.calls:
            return fn

        def counted(*args):
            self.calls[name] += 1
            return fn(*args)

        return counted


def test_backward_launches_no_kernel(monkeypatch):
    """K1 and K2 run once each in the forward and never in the backward;
    a loss of w32 alone reaches the parameters (w32 is demeaned, so its
    plain sum has a zero gradient: the squares here)."""
    counting = _Counting(ttr.tk)
    monkeypatch.setattr(ttr, "tk", counting)
    v = torch.tensor(SEEDED, requires_grad=True)
    s = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                              tsys.AlignParams.from_vector(v))
    r = ttr.run(s, N, N, defocus=v[0], exit_pupil_uniform=False,
                precision="pallas")
    assert counting.calls == {"trace_deviation": 1, "detector": 1}
    (r.w32 ** 2).sum().backward()
    assert counting.calls == {"trace_deviation": 1, "detector": 1}
    assert torch.isfinite(v.grad).all() and int((v.grad != 0).sum()) >= 20


def test_refan_backward(monkeypatch):
    """With the exit-pupil re-fan the fast path runs K1 twice (pre-trace
    and run_fast) and K2 once, and its gradient (through the re-fanned
    angles too) agrees with the f64 engine's re-fanned one (measured
    1.6e-6)."""
    counting = _Counting(ttr.tk)
    monkeypatch.setattr(ttr, "tk", counting)
    g = port_grad(SEEDED, dev_fields=False, exit_pupil_uniform=True)
    assert counting.calls == {"trace_deviation": 2, "detector": 1}
    g64 = port_grad(SEEDED, precision="f64", exit_pupil_uniform=True)
    assert rel_err(g, g64) < GRAD_REL


def test_trace_pallas_differentiates_as_trace_dev32():
    """trace_pallas's backward is the VJP of trace_dev32's deviation
    chain in the backward twin's arithmetic (float64): a loss on its
    points, directions and segments has the same gradient through
    either: the same operations, the gradients of the mirrors' tensors
    summed in another order (in float32, measured 1.5e-9 of one
    component, 1.8e-12 of the largest); 1e-10 of the largest."""
    def grad(fn):
        v = torch.tensor(SEEDED, requires_grad=True)
        s = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                                  tsys.AlignParams.from_vector(v))
        rays = ttr.ray_fan(ttr.fan_angles(s.fan_h, 5),
                           ttr.fan_angles(s.fan_v, 5))
        r = fn(s, rays, s.source[:, None].expand(3, 25))
        loss = (sum(torch.sum(p ** 2) for p in r.points)
                + sum(torch.sum(d[1:] * 1e3) for d in r.directions[1:])
                + sum(torch.sum(t) for t in r.segments))
        loss.backward()
        return v.grad.numpy()

    g_dev = grad(lambda *a: ttr.trace_dev32(*a, dtype=torch.float64))
    np.testing.assert_allclose(grad(ttr.trace_pallas), g_dev, rtol=0,
                               atol=1e-10 * np.abs(g_dev).max())
