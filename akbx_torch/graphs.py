"""Replay of a function of a few tensors from CUDA graphs, forward and
backward.

:func:`call` runs ``fn(*inputs)``, which returns a tuple of tensors.  On a
card it captures ``fn`` once per key into a forward graph and, where some
input requires grad, a backward graph (``torch.autograd.grad`` of the
outputs that require grad in the inputs that do), and replays them after:
a call copies the inputs into the graphs' static inputs, replays the
forward and returns clones of its outputs; their backward copies the
output gradients in, replays the backward and returns clones of the input
gradients.  A graph replays the kernels it captured, in the same order on
the same values, so a replay returns what the eager call returns, bit for
bit, and costs one launch of the host's time where the eager call costs
one launch an operator.

``fn`` must be capturable: no tensor made from host data, no ``.item()``,
no Python branch on a tensor's value, its outputs' shapes fixed by its
inputs' shapes.

``fn`` runs eagerly instead on the CPU, while the current stream is
capturing, under a functorch transform, forward-mode AD, inference mode or
a dispatch mode.  A backward whose forward's saved values a later replay
of the same graph has overwritten, or one that builds a graph of its own
(``create_graph``), runs ``fn`` again eagerly from the saved inputs.

Counts since import, read as the kernels' ``launches`` are: ``captures``
(graph pairs captured), ``replays`` (forward replays) and ``eager``
(eager runs of ``fn``, forward or backward).
"""

from __future__ import annotations

import torch
import torch.autograd.forward_ad as fwad
from torch.utils._python_dispatch import _get_current_dispatch_mode

captures = 0
replays = 0
eager = 0

# eager runs before each capture, outside it: lazy initialisation (cuBLAS
# handles, autograd's device threads, the allocator's pools) must not
# happen inside the capture (torch.cuda.make_graphed_callables' default)
_WARMUP = 3


def _capturable(inputs) -> bool:
    return (inputs[0].is_cuda
            and not torch.cuda.is_current_stream_capturing()
            and not torch._C._are_functorch_transforms_active()
            and fwad._current_level < 0
            and not torch.is_inference_mode_enabled()
            and _get_current_dispatch_mode() is None)


def call(cache: dict, key, fn, inputs) -> tuple:
    """``fn(*inputs)``: replayed from the graphs of ``cache[key, ...]``
    where the call allows (captured on the first such call), else eager.
    ``cache`` belongs to the caller and lives as long as what ``fn``
    closes over; the key adds the inputs' shapes, dtypes and device, the
    grad mode and which inputs require grad."""
    global eager
    inputs = tuple(inputs)
    if not _capturable(inputs):
        eager += 1
        return tuple(fn(*inputs))
    grad = torch.is_grad_enabled()
    full = (key, inputs[0].device, grad) + tuple(
        (x.shape, x.dtype, grad and x.requires_grad) for x in inputs)
    entry = cache.get(full)
    if entry is None:
        entry = cache[full] = _Graphs(fn, inputs, grad)
    if entry.diff_in:
        return _Replay.apply(entry, *inputs)
    with torch.no_grad():
        return entry.forward(inputs)


class _Graphs:
    """One capture of ``fn``: its static inputs and outputs, its forward
    graph and, where an input requires grad, its backward graph."""

    def __init__(self, fn, inputs, grad: bool):
        global captures
        self.fn = fn
        self.dev = inputs[0].device
        self.need = tuple(grad and x.requires_grad for x in inputs)
        self.diff_in = tuple(j for j, n in enumerate(self.need) if n)
        self.generation = 0
        with torch.cuda.device(self.dev):
            self.static_in = tuple(x.detach().clone() for x in inputs)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(_WARMUP):
                    self._run_leaves()
            torch.cuda.current_stream().wait_stream(side)

            self.fwd = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.fwd):
                leaves, outs = self._leaves_and_outputs()
            self.static_out = tuple(o.detach() for o in outs)
            self.diff_out = tuple(i for i, o in enumerate(outs)
                                  if o.requires_grad)
            self.bwd = None
            if self.diff_in:
                self.static_gout = tuple(torch.zeros_like(outs[i])
                                         for i in self.diff_out)
                self.bwd = torch.cuda.CUDAGraph()
                # retain_graph: the forward's saved values stay where
                # the backward reads them, so that one forward replay
                # serves several backward replays
                with torch.cuda.graph(self.bwd, pool=self.fwd.pool()):
                    gin = torch.autograd.grad(
                        [outs[i] for i in self.diff_out],
                        [leaves[j] for j in self.diff_in],
                        self.static_gout, allow_unused=True,
                        retain_graph=True)
                self.static_gin = gin
        captures += 1

    def _leaves_and_outputs(self):
        leaves = tuple(x.detach().requires_grad_(n)
                       for x, n in zip(self.static_in, self.need))
        with torch.set_grad_enabled(bool(self.diff_in)):
            return leaves, tuple(self.fn(*leaves))

    def _run_leaves(self):
        leaves, outs = self._leaves_and_outputs()
        diff = [o for o in outs if o.requires_grad]
        if diff:
            torch.autograd.grad(diff, [leaves[j] for j in self.diff_in],
                                [torch.zeros_like(o) for o in diff],
                                allow_unused=True)

    def forward(self, inputs) -> tuple:
        """Replay the forward on ``inputs``; clones of its outputs."""
        global replays
        with torch.cuda.device(self.dev):
            for s, x in zip(self.static_in, inputs):
                s.copy_(x)
            self.fwd.replay()
            self.generation += 1
            replays += 1
            return tuple(o.clone() for o in self.static_out)

    def backward(self, grads) -> tuple:
        """Replay the backward on the gradients of the outputs that
        require grad; clones of the inputs' gradients (None where unused)."""
        with torch.cuda.device(self.dev):
            for s, g in zip(self.static_gout, grads):
                s.copy_(g)
            self.bwd.replay()
            return tuple(None if g is None else g.clone()
                         for g in self.static_gin)


class _Replay(torch.autograd.Function):
    """The graphs of one capture as one autograd node."""

    @staticmethod
    def forward(ctx, entry, *inputs):
        outs = entry.forward(inputs)
        ctx.entry, ctx.generation = entry, entry.generation
        ctx.save_for_backward(*inputs)
        ctx.mark_non_differentiable(*(o for i, o in enumerate(outs)
                                      if i not in entry.diff_out))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        global eager
        entry = ctx.entry
        gout = [grads[i] for i in entry.diff_out]
        create = torch.is_grad_enabled()
        if ctx.generation == entry.generation and not create:
            gin = entry.backward(gout)
        else:
            eager += 1
            inputs = ctx.saved_tensors
            with torch.enable_grad():
                outs = entry.fn(*inputs)
                gin = torch.autograd.grad(
                    [outs[i] for i in entry.diff_out],
                    [inputs[j] for j in entry.diff_in], gout,
                    allow_unused=True, create_graph=create)
        out = [None] * len(entry.need)
        for j, g in zip(entry.diff_in, gin):
            out[j] = g
        return (None, *out)
