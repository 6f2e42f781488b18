"""K4's wrapper on the CPU: the twin, ``huygens_tile`` over target chunks,
bit for bit as the ring ran it; in-place accumulation; no launch; its
checks; and ``huygens_ring``'s sum through it once a step (the kernel
itself: tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from akbx_torch.kernels import huygens_f64 as mod
from akbx_torch.kernels.huygens_f64 import huygens_f64, huygens_tile
from akbx_torch.parallel import sharding as sh

F64 = torch.float64
EUV = 13.5e-9
K = 2.0 * np.pi / EUV


def _problem(n, m, seed=0):
    """Targets on a mirror 146 m from the sources (akbx's source -> M1
    distance), seeded weights, and accumulators already holding a sum."""
    rng = np.random.default_rng(seed)
    src = np.array([0.0, 0.0, 0.0])[:, None] + rng.normal(size=(3, m)) * 1e-3
    tgt = (np.array([146.0, 0.03, 0.01])[:, None]
           + rng.normal(size=(3, n)) * np.array([[0.02], [1e-3], [1e-3]]))
    w = rng.normal(size=(2, m)) * 1e-8
    acc = rng.normal(size=(2, n)) * 1e-10
    t = [torch.tensor(x, dtype=F64) for x in (tgt, src, w[0], w[1], acc[0],
                                              acc[1])]
    return t


def _ring_sum(tgt, src, w_re, w_im, acc_re, acc_im, chunk):
    """The ring's per-step sum as it was before K4: the chunks' results
    concatenated, then added."""
    parts = [huygens_tile(tgt[:, c:c + chunk], src, w_re, w_im, K)
             for c in range(0, tgt.shape[1], chunk)]
    if not parts:
        return acc_re, acc_im
    return (acc_re + torch.cat([re for re, _ in parts]),
            acc_im + torch.cat([im for _, im in parts]))


@pytest.mark.parametrize("n,m,chunk", [
    (100, 33, 1), (100, 33, 7), (100, 33, 64), (257, 33, 1024),
    (130, 40, 130), (131, 40, 130), (0, 33, 64), (65, 1, 16), (64, 9, 16)],
    ids=["chunk1", "chunk7", "ragged64", "one-chunk", "exact", "ragged-by-1",
         "no-targets", "point-source", "padded-point-source"])
def test_twin_is_the_rings_chunked_sum_bit_for_bit(n, m, chunk,
                                                   monkeypatch):
    """On CPU tensors the wrapper runs ``huygens_tile`` over chunks of
    ``CHUNK`` targets: the same bits as the ring's sum before K4, for
    ragged last chunks, no targets and a point source (with and without
    the ring's zero-weight padding); and it launches nothing."""
    monkeypatch.setattr(mod, "CHUNK", chunk)
    tgt, src, w_re, w_im, acc_re, acc_im = _problem(n, m, seed=n + m + chunk)
    if m == 9:   # one source and the ring's padding: zero weights at 0
        src[:, 1:] = 0.0
        w_re[1:] = 0.0
        w_im[1:] = 0.0
    want = _ring_sum(tgt, src, w_re, w_im, acc_re, acc_im, chunk)
    before = huygens_f64.launches
    huygens_f64(tgt, src, w_re, w_im, K, acc_re, acc_im)
    assert huygens_f64.launches == before
    for got, w in zip((acc_re, acc_im), want):
        assert torch.equal(got, w)
        assert torch.isfinite(got).all()


def test_accumulates_in_place():
    """The sums land in the given tensors, added to what they held; the
    other arguments are left as they were."""
    tgt, src, w_re, w_im, acc_re, acc_im = _problem(50, 20, seed=3)
    held = (acc_re.clone(), acc_im.clone())
    ins = [x.clone() for x in (tgt, src, w_re, w_im)]
    ptrs = (acc_re.data_ptr(), acc_im.data_ptr())
    assert huygens_f64(tgt, src, w_re, w_im, K, acc_re, acc_im) is None
    assert (acc_re.data_ptr(), acc_im.data_ptr()) == ptrs
    zero = torch.zeros_like(acc_re)
    fresh = (zero, zero.clone())
    huygens_f64(tgt, src, w_re, w_im, K, *fresh)
    for got, h, f in zip((acc_re, acc_im), held, fresh):
        assert not torch.equal(got, h)
        assert torch.equal(got, h + f)
    for a, b in zip(ins, (tgt, src, w_re, w_im)):
        assert torch.equal(a, b)


def _bad(case):
    tgt, src, w_re, w_im, acc_re, acc_im = _problem(12, 10, seed=5)
    args = [tgt, src, w_re, w_im, K, acc_re, acc_im]
    if case == "f32-targets":
        args[0] = tgt.float()
    elif case == "f32-weights":
        args[2] = w_re.float()
    elif case == "f32-accumulator":
        args[6] = acc_im.float()
    elif case == "weights-length":
        args[3] = torch.zeros(11, dtype=F64)
    elif case == "accumulator-length":
        args[5] = torch.zeros(13, dtype=F64)
    elif case == "two-row-targets":
        args[0] = tgt[:2].contiguous()
    elif case == "non-contiguous-targets":
        args[0] = torch.zeros((24, 3), dtype=F64).t()[:, ::2]
    elif case == "non-contiguous-sources":
        args[1] = src.t().contiguous().t()
    elif case == "non-contiguous-weights":
        args[2] = torch.zeros(20, dtype=F64)[::2]
    elif case == "mixed-devices":
        args[5] = torch.zeros(12, dtype=F64, device="meta")
    return args


@pytest.mark.parametrize("case", [
    "f32-targets", "f32-weights", "f32-accumulator", "weights-length",
    "accumulator-length", "two-row-targets", "non-contiguous-targets",
    "non-contiguous-sources", "non-contiguous-weights", "mixed-devices"])
def test_refuses(case):
    """f32 inputs, mismatched shapes, non-contiguous inputs and tensors on
    two devices raise before anything is summed."""
    args = _bad(case)
    held = (args[5].clone() if args[5].device.type == "cpu" else None)
    with pytest.raises(ValueError):
        huygens_f64(*args)
    if held is not None:
        assert torch.equal(args[5], held)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield sh.ray_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("inp", [0, 1, 2, 3],
                         ids=["targets", "sources", "re-weights",
                              "im-weights"])
def test_kernel_refuses_inputs_that_require_grad(monkeypatch, inp):
    """K4 records no gradient: where the kernel would run, an input that
    requires grad raises under grad mode, before the library is loaded;
    under ``no_grad`` the same call goes on to the launch."""
    from akbx_torch.kernels import _build

    class Loaded(Exception):
        pass

    def load(*a, **kw):
        raise Loaded

    monkeypatch.setattr(mod, "use_kernel", lambda *t: True)
    monkeypatch.setattr(_build, "load", load)
    args = list(_problem(12, 10, seed=6))
    args[inp] = args[inp].clone().requires_grad_(True)
    ins = args[:4] + [K] + args[4:]
    with pytest.raises(ValueError, match="gradient"):
        huygens_f64(*ins)
    with torch.no_grad(), pytest.raises(Loaded):
        huygens_f64(*ins)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield sh.ray_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def _one_rank_ring_sum(tgt, src, w_re, w_im):
    """What a one-rank ring sums before K4: the sources padded with
    zero-weight sources at the origin to a multiple of 8, in chunks of
    1,024 targets, added to zeros."""
    pad = -src.shape[1] % 8
    z = torch.zeros(pad, dtype=F64)
    zero = torch.zeros(tgt.shape[1], dtype=F64)
    return _ring_sum(tgt, torch.cat([src, torch.zeros((3, pad), dtype=F64)],
                                    dim=1),
                     torch.cat([w_re, z]), torch.cat([w_im, z]), zero,
                     zero.clone(), 1024)


def _counting(monkeypatch):
    calls, k4 = [], mod.huygens_f64

    def counting(*a, **kw):
        calls.append(tuple(a[0].shape))
        return k4(*a, **kw)

    monkeypatch.setattr(mod, "huygens_f64", counting)
    return calls


@pytest.mark.parametrize("route", ["no-grad-inputs", "under-no_grad"])
def test_ring_routes_to_k4_without_a_gradient(one_rank, monkeypatch, route):
    """Without a gradient to record the ring sums through ``huygens_f64``
    once a step, with the bits of its sum before K4."""
    tgt, src, w_re, w_im, _, _ = _problem(90, 100, seed=8)
    calls = _counting(monkeypatch)
    want = _one_rank_ring_sum(tgt, src, w_re, w_im)
    if route == "under-no_grad":
        with torch.no_grad():
            got = sh.huygens_ring(src, w_re.clone().requires_grad_(True),
                                  w_im, tgt, EUV, one_rank)
    else:
        got = sh.huygens_ring(src, w_re, w_im, tgt, EUV, one_rank)
    assert calls == [(3, 90)]
    for g, w in zip(got, want):
        assert not g.requires_grad
        assert torch.equal(g, w)


def test_ring_on_the_cpu_keeps_the_gradient(one_rank, monkeypatch):
    """On the CPU the ring's one ``huygens_f64`` call a step runs the twin,
    which records the gradient: the values and the weights' gradient are
    those of the sum before K4, bit for bit."""
    tgt, src, w_re, w_im, _, _ = _problem(90, 100, seed=9)
    g_re, g_im = _problem(90, 100, seed=10)[4:]
    calls = _counting(monkeypatch)
    grads = []
    for ring in (True, False):
        w = w_re.clone().requires_grad_(True)
        out = (sh.huygens_ring(src, w, w_im, tgt, EUV, one_rank) if ring
               else _one_rank_ring_sum(tgt, src, w, w_im))
        assert out[0].requires_grad
        (out[0] @ g_re + out[1] @ g_im).backward()
        grads.append((out[0].detach(), out[1].detach(), w.grad))
    assert calls == [(3, 90)]
    for a, b in zip(*grads):
        assert torch.equal(a, b)
