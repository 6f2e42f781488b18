"""The operation counts behind the kernels' bounds, counted on the twins
(on the CPU, at one pair / one ray): every f32 ``two_prod`` counts as 2
(a multiply and an FMA, as the kernels run it), whatever tensor passes
the twin's detour through f64 takes.  The counts, and so the bounds, are
those of the Dekker-form twins before them, and the ones
``portbench/roofline.py`` freezes."""

import contextlib
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from akbx_torch import trace
from akbx_torch.kernels import huygens as hk
from akbx_torch.kernels import trace_kernel as tk
from akbx_torch.systems import (AlignParams, WOLTER_3_1_DEFAULT,
                                WOLTER_3_3_TANDEM_DEFAULT, build_wolter_3_1,
                                build_wolter_3_3_tandem)

torch.set_num_threads(2)

# aten ops that move or make data rather than compute on it
_MOVES = {"view", "_unsafe_view", "reshape", "expand", "select", "slice",
          "unsqueeze", "squeeze", "t", "transpose", "permute", "clone",
          "copy_", "detach", "alias", "lift_fresh", "lift_fresh_copy",
          "zeros_like", "ones_like", "full_like", "empty_like", "zeros",
          "ones", "full", "empty", "new_zeros", "scalar_tensor", "fill_",
          "zero_", "stack", "cat", "index", "index_put_", "as_strided",
          "unbind", "split", "_local_scalar_dense", "empty_strided",
          # sign changes fold into the operands of the next instruction
          "neg", "abs"}
_REDUCTIONS = {"sum", "mean", "amax", "amin"}


class OpCount(TorchDispatchMode):
    """Counts the operations of the ops run under it: one per output
    element of an elementwise op, one per input element of a reduction;
    none for data movement and sign changes, nor while ``paused``.  A sin,
    a division or a square root counts as one, so the count is a floor."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if self.paused:
            pass
        elif name in _REDUCTIONS:
            self.ops += args[0].numel()
        elif name not in _MOVES and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


@contextlib.contextmanager
def two_prods_as_fma(counter):
    """Counts every ``two_prod`` of akbx_torch as the kernels run it:
    p = a b and e = fma(a, b, -p), two operations per element, not the
    tensor passes of the twin's detour through f64.  ``counter.calls``
    counts the ``two_prod`` calls."""
    from akbx_torch.core import precision

    twin = precision.two_prod
    counter.calls = 0

    def two_prod(a, b):
        counter.paused = True
        try:
            out = twin(a, b)
        finally:
            counter.paused = False
        counter.ops += 2 * out.hi.numel()
        counter.calls += 1
        return out

    mods = [m for k, m in list(sys.modules.items())
            if k.startswith("akbx_torch") and getattr(m, "two_prod", None)
            is twin]
    for m in mods:
        m.two_prod = two_prod
    try:
        yield
    finally:
        for m in mods:
            m.two_prod = twin


def count_ops(fn, *args):
    """(operations, two_prod calls) of ``fn(*args)`` on CPU copies of
    ``args``, with every two_prod at 2 operations per element."""
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    with OpCount() as c, two_prods_as_fma(c):
        fn(*cpu)
    return c.ops, c.calls


def k1_inputs(s):
    """K1's arguments for one ray of a 5x5 fan through the placed system
    ``s``, and the chief's f64 outgoing direction after each mirror."""
    rays = trace.ray_fan(trace.fan_angles(s.fan_h, 5),
                         trace.fan_angles(s.fan_v, 5))
    n = rays.shape[1]
    src = s.source[:, None].expand(3, n)
    chief_d0, chief_p0, c64 = trace._fast_scalars(s, rays, src, n // 2)
    return (tk.pack_consts(c64), (src - chief_p0)[:, 3:4].contiguous(),
            (rays - chief_d0)[:, 3:4].contiguous(), len(s.mirrors)), c64.Dn


@pytest.fixture(scope="module")
def trace_inputs():
    """K1's and K2's arguments for one ray of a 5x5 fan (K2: two planes)."""
    dev = torch.device("cpu")
    s = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.zeros(dev))
    k1, Dns = k1_inputs(s)
    t1 = tk.trace_deviation_reference(*k1)
    R = torch.eye(3, dtype=torch.float64)
    planes = torch.cat([
        tk.pack_det_consts(R, Dns[-1], torch.tensor(t, dtype=torch.float64),
                           torch.tensor(t, dtype=torch.float64))
        for t in (0.2, 0.201)])
    k2 = (planes, t1[0][9:12], t1[1][9:12], t1[2][9:12], t1[3][9:12], t1[6],
          t1[7])
    return {"K1": (tk.trace_deviation_reference, k1),
            "K2": (tk.detector_reference, k2)}


@pytest.mark.parametrize("kernel,ops,two_prods", [
    ("K1", 8572, 4 * 77), ("K2", 1582, 18 + 2 * 17), ("K3", 266, 7)])
def test_operations_per_ray_or_pair(trace_inputs, kernel, ops, two_prods):
    if kernel == "K3":
        fn, args = hk.huygens_reference, (
            torch.zeros(6, 1), torch.ones(6, 1), torch.ones(2, 1),
            torch.ones(2))
    else:
        fn, args = trace_inputs[kernel]
    assert count_ops(fn, *args) == (ops, two_prods)


def test_k1_operations_per_ray_on_the_tandem():
    """K1 on the Wolter III+III tandem's mirrors counts what it counts on
    III+I's: 2,142 operations a mirror and 4 more a ray, the frozen count
    that ``k1_roofline.align`` divides by at four mirrors."""
    s = build_wolter_3_3_tandem(WOLTER_3_3_TANDEM_DEFAULT,
                                AlignParams.zeros(torch.device("cpu")))
    k1, _ = k1_inputs(s)
    assert count_ops(tk.trace_deviation_reference, *k1) == (
        4 * 2142 + 4, 4 * 77)


def test_counting_leaves_two_prod_in_place():
    from akbx_torch.core import precision

    before = precision.two_prod
    count_ops(hk.huygens_reference, torch.zeros(6, 1), torch.ones(6, 1),
              torch.ones(2, 1), torch.ones(2))
    assert precision.two_prod is before and hk.two_prod is before
    assert tk.two_prod is before


def test_k4_operations_per_pair():
    """K4's f64 operations a pair, counted on its twin: what one more
    source adds to one target's elementwise ops (a division, a square
    root, a sine counted as one; a two_prod as 2), and the contraction's 4
    FMAs (``count_ops`` counts a matrix-vector product once an output):
    the 57 that chip_smoke.py's bound of K4 divides by."""
    from akbx_torch.kernels import huygens_f64 as k4

    def count(m):
        t = torch.full((3, 1), 146.0, dtype=torch.float64)
        s = torch.rand((3, m), dtype=torch.float64)
        w = torch.ones(m, dtype=torch.float64)
        acc = torch.zeros(1, dtype=torch.float64)
        return count_ops(k4.huygens_f64_reference, t, s, w, w, 4.6e8, acc,
                         acc.clone())[0]

    assert count(2) - count(1) + 4 == 57
