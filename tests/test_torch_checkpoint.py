"""akbx_torch.checkpoint: akbx's tests/test_checkpoint.py cases on
torch.save (train state, latest step, empty directory, wave fields), a
bit-for-bit resume of the train step, and wave fields read across the two
packages' files."""

import numpy as np
import pytest

import torch

from akbx import checkpoint as jck, wave as jwave
from akbx_torch import checkpoint as ck, convert
from akbx_torch.parallel import sharding as sh
from akbx_torch.systems import WOLTER_3_1_DEFAULT
from akbx_torch.wave import WaveField


def make_state():
    params = {"align": torch.arange(26, dtype=torch.float64) * 1e-6,
              "figures": [torch.ones((2, 3), dtype=torch.float64) * i
                          for i in range(4)]}
    for t in sh.param_list(params):
        t.requires_grad_()
    opt = torch.optim.Adam(sh.param_list(params), lr=1e-3)
    for t in sh.param_list(params):
        t.grad = torch.full_like(t, 0.5)
    opt.step()
    return params, opt


def test_roundtrip(tmp_path):
    params, opt = make_state()
    d = str(tmp_path / "ckpt")
    ck.save_train_state(d, 7, params, opt, extra={"loss": 1.25})
    state, step, extra = ck.restore_train_state(d, device="cpu")
    assert step == 7
    assert extra == {"loss": 1.25}
    assert torch.equal(state["params"]["align"], params["align"].detach())
    assert torch.equal(state["params"]["figures"][3],
                       params["figures"][3].detach())
    saved = opt.state_dict()
    assert state["opt_state"]["param_groups"] == saved["param_groups"]
    for k, v in saved["state"].items():
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state["opt_state"]["state"][k][name], v[name])


def test_latest_step_resume(tmp_path):
    params, opt = make_state()
    d = str(tmp_path / "ckpt")
    for s in (1, 5, 3):
        ck.save_train_state(d, s, params, opt)
    assert ck.latest_step(d) == 5
    _, step, _ = ck.restore_train_state(d, device="cpu")
    assert step == 5


def test_empty_dir(tmp_path):
    state, step, extra = ck.restore_train_state(str(tmp_path / "none"),
                                                device="cpu")
    assert state is None and step is None and extra is None


def test_restore_defaults_to_the_card(tmp_path):
    """Without ``device`` the state lands on the card (each rank on its
    own), never silently on the CPU: here, without one, torch raises."""
    params, opt = make_state()
    d = str(tmp_path / "ckpt")
    ck.save_train_state(d, 1, params, opt)
    if torch.cuda.is_available():
        state, _, _ = ck.restore_train_state(d)
        assert state["params"]["align"].is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            ck.restore_train_state(d)


def _loss_fn(sys_, res):
    from akbx_torch import trace

    w = res.total_dist - trace.masked_mean(res.total_dist, res.valid)
    return torch.sum(torch.where(res.valid, w, 0.0) ** 2) * 1e18


def test_resume_is_bit_for_bit(tmp_path):
    """Two train steps straight through, and one step, a checkpoint, a
    restore into fresh tensors and a fresh optimizer, and the second step:
    the same parameters, bit for bit."""
    step, _, _ = sh.make_train_step(
        WOLTER_3_1_DEFAULT, _loss_fn,
        lambda ts: torch.optim.Adam(ts, lr=1e-10), 5, 5, None)
    fig = np.zeros((3, 3))
    fig[1, 0] = 5e-9
    start = {"align": np.zeros(26), "figures": [fig] * 4}

    p = convert.train_params_from_numpy(start, "cpu")
    opt, p, _ = step(None, p)
    d = str(tmp_path / "ckpt")
    ck.save_train_state(d, 1, p, opt)
    _, p, loss2 = step(opt, p)

    state, s, _ = ck.restore_train_state(d, device="cpu")
    assert s == 1
    q = {"align": state["params"]["align"].clone().requires_grad_(),
         "figures": [f.clone().requires_grad_()
                     for f in state["params"]["figures"]]}
    opt2 = torch.optim.Adam(sh.param_list(q), lr=1e-10)
    opt2.load_state_dict(state["opt_state"])
    _, q, loss2b = step(opt2, q)
    assert float(loss2b) == float(loss2)
    for a, b in zip(sh.param_list(p), sh.param_list(q), strict=True):
        assert torch.equal(a.detach(), b.detach())


def test_wavefield_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(3, 12))
    u = rng.normal(size=12) + 1j * rng.normal(size=12)
    f = WaveField.from_complex(torch.as_tensor(pts), torch.as_tensor(u),
                               torch.full((12,), 1e-6, dtype=torch.float64),
                               4, 3)
    ck.save_wavefield(str(tmp_path), "M1", f)
    g = ck.load_wavefield(str(tmp_path), "M1", device="cpu")
    assert torch.equal(g.re, f.re) and torch.equal(g.im, f.im)
    np.testing.assert_array_equal(g.points.numpy(), pts)
    assert (g.n_h, g.n_v) == (4, 3)
    assert ck.load_wavefield(str(tmp_path), "missing", device="cpu") is None


def test_wavefield_files_read_across(tmp_path):
    """Each package reads the other's wave-field files unchanged."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(3, 10))
    u = rng.normal(size=10) + 1j * rng.normal(size=10)
    ds = np.full(10, 2e-6)
    jck.save_wavefield(str(tmp_path / "j"), "M2",
                       jwave.WaveField.from_complex(pts, u, ds, 5, 2))
    t = ck.load_wavefield(str(tmp_path / "j"), "M2", device="cpu")
    np.testing.assert_array_equal(t.re.numpy() + 1j * t.im.numpy(), u)
    np.testing.assert_array_equal(t.ds.numpy(), ds)
    ck.save_wavefield(str(tmp_path / "t"), "M3", t)
    j = jck.load_wavefield(str(tmp_path / "t"), "M3")
    np.testing.assert_array_equal(np.asarray(j.points), pts)
    assert (j.n_h, j.n_v) == (5, 2)
