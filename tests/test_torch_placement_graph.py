"""The Wolter III+I build as a memoised layout and a capturable placement
(``systems._layout_3_1``, ``systems._place_3_1``), on the CPU, where
``akbx_torch.graphs.call`` runs the placement eagerly.  Each case runs
for ``precise`` True and False and ``unit_coupled`` False, True and "h".
The graphs themselves are the card's (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from akbx_torch import graphs, systems, utils
from akbx_torch.systems import (AlignParams, WOLTER_3_1_DEFAULT,
                                WOLTER_3_1_SETTING1, build_wolter_3_1)

F64 = torch.float64
MODES = [pytest.param(p, u, id=f"{'df' if p else 'f64'}-{u}")
         for p in (True, False) for u in (False, True, "h")]
VEC = np.random.default_rng(17).normal(0.0, 1e-5, 26)
# what a capture may not contain: a tensor made from host data (and its
# copy to the card), a read of a value back to the host, a shape that
# depends on values
HOST_OPS = {torch.ops.aten.lift_fresh, torch.ops.aten.lift_fresh_copy,
            torch.ops.aten._to_copy, torch.ops.aten._local_scalar_dense,
            torch.ops.aten.is_nonzero, torch.ops.aten.equal,
            torch.ops.aten.nonzero}


def _step(spec=WOLTER_3_1_DEFAULT, **kw):
    """A build at ``VEC`` and the gradient of a loss on every mirror's
    coefficients and center: (the system's tensors, the gradient)."""
    v = torch.tensor(VEC, dtype=F64, requires_grad=True)
    s = build_wolter_3_1(spec, AlignParams.from_vector(v), **kw)
    w = torch.Generator().manual_seed(0)
    loss = sum((m.coeffs * torch.randn(10, generator=w, dtype=F64)).sum()
               + (m.center * torch.randn(3, generator=w, dtype=F64)).sum()
               for m in s.mirrors)
    loss.backward()
    return ([t for m in s.mirrors for t in m]
            + [s.s2f_middle, s.fan_h, s.fan_v, s.source, s.valid], v.grad)


def _same(a, b):
    ta, ga = a
    tb, gb = b
    assert len(ta) == len(tb)
    for x, y in zip(ta + [ga], tb + [gb]):
        assert torch.equal(x, y)
        if x.is_floating_point():
            assert torch.equal(torch.signbit(x), torch.signbit(y))


@pytest.mark.parametrize("precise,unit_coupled", MODES)
def test_layout_is_memoised(monkeypatch, precise, unit_coupled):
    """A second build with the same spec and options reuses the layout and
    returns what a build on a cleared cache returns, gradient included,
    in tensors of its own; another spec or option makes its own."""
    monkeypatch.setattr(systems, "_LAYOUTS", {})
    kw = dict(precise=precise, unit_coupled=unit_coupled)
    first = _step(**kw)
    first = ([t.clone() for t in first[0]], first[1])
    (key, lay), = systems._LAYOUTS.items()
    eager = graphs.eager
    second = _step(**kw)
    assert graphs.eager == eager + 1
    assert list(systems._LAYOUTS) == [key] and systems._LAYOUTS[key] is lay
    _same(first, second)

    for t in second[0][:-1]:
        t.detach().add_(1.0)   # the returned tensors, not the layout's
    _same(first, _step(**kw))
    systems._LAYOUTS.clear()
    _same(first, _step(**kw))
    assert len(systems._LAYOUTS) == 1

    _step(**kw, fan_centering="mean")
    _step(**kw, source_shift=(0.0, 1e-4, 0.0))
    _step(WOLTER_3_1_SETTING1, **kw)
    _step(precise=not precise, unit_coupled=unit_coupled)
    assert len(systems._LAYOUTS) == 5


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add(func.overloadpacket)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("precise,unit_coupled", MODES)
def test_placement_is_capture_safe(precise, unit_coupled):
    """With the layout made, the placement and its backward make no
    tensor from host data, read nothing back to the host and make no
    shape from a value: what a CUDA graph's capture allows."""
    _step(precise=precise, unit_coupled=unit_coupled)
    lay = systems._layout_3_1(WOLTER_3_1_DEFAULT, (0.0, 0.0, 0.0), "theta1",
                              precise, False, torch.device("cpu"))
    v = torch.tensor(VEC, dtype=F64, requires_grad=True)
    p = AlignParams.from_vector(v)
    with _Ops() as ops:
        outs = systems._place_3_1(lay, unit_coupled, p.astig_h, p.hyp_v,
                                  p.hyp_h, p.ell_v, p.ell_h)
        diff = [o for o in outs if o.requires_grad]
        torch.autograd.grad(diff, [v], [torch.ones_like(o) for o in diff])
    assert len(diff) == 6
    assert not ops.seen & HOST_OPS, ops.seen & HOST_OPS
    assert torch.ops.aten.mul in ops.seen


def test_off_the_card_the_placement_runs_eagerly():
    """On the CPU ``graphs.call`` runs the function, counted as eager, and
    captures nothing."""
    before = (graphs.captures, graphs.replays, graphs.eager)
    cache = {}
    x = torch.ones(3, dtype=F64, requires_grad=True)
    out, = graphs.call(cache, "k", lambda t: (t * 2,), (x,))
    assert torch.equal(out, 2 * x.detach()) and out.requires_grad
    assert (graphs.captures, graphs.replays, graphs.eager) == (
        before[0], before[1], before[2] + 1)
    assert cache == {}


def test_layout_made_in_inference_mode_serves_a_gradient(monkeypatch):
    """The layout and the shared constants are made outside inference
    mode even where the first build runs inside it, so that a later
    build can save them for its backward."""
    monkeypatch.setattr(systems, "_LAYOUTS", {})
    monkeypatch.setattr(utils, "_CONSTANTS", {})
    with torch.inference_mode():
        build_wolter_3_1(WOLTER_3_1_DEFAULT,
                         AlignParams.zeros(torch.device("cpu")))
    _, grad = _step()
    assert torch.isfinite(grad).all() and bool((grad != 0).any())
