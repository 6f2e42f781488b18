"""Ray and target sharding over ``torch.distributed`` (port of
:mod:`akbx.parallel.sharding`).

akbx drives a ``jax.sharding.Mesh`` from one process and lets XLA insert
the collectives.  The port is SPMD in PyTorch's idiom: one process per
card (``torchrun --nproc-per-node N``), NCCL on the card and gloo on the
CPU, and a one-dimensional ``DeviceMesh`` with the dimension ``"rays"``
(:func:`ray_mesh`) in place of akbx's ``Mesh``.  Every rank calls each
function with the same arguments.

* Per-ray (or per-target) outputs stay sharded: rank ``r`` holds the
  columns :func:`shard_bounds` gives it, contiguous blocks in rank order.
  :func:`gather_rays` assembles the global array where a caller needs it.
* Scalars and reductions over rays come back replicated on every rank: a
  local sum followed by an ``all_reduce`` (:func:`all_sum`), never a mean
  of local means, which is wrong on ragged shards.
* Collectives that a gradient flows through are the differentiable ones of
  ``torch.distributed.nn.functional``.  Their backward is the same
  collective on the cotangents: every rank's copy of a replicated loss
  sends its cotangent to every shard, so the gradients of a replicated
  parameter, summed over the ranks, are the world size times the gradient
  of the one loss.  :func:`reduce_grads` sums them and divides by the
  world size; summing alone over-counts, and skipping the sum misses the
  other ranks' rays.
"""

from __future__ import annotations

import math
import os
import warnings

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dfn

from akbx_torch import default_device, spans


def ray_mesh(n_devices: int | None = None, device_type: str | None = None,
             axis: str = "rays"):
    """The one-dimensional ``DeviceMesh`` over every rank of the default
    process group, which the caller has initialised.  ``device_type``
    defaults to the card's (:func:`akbx_torch.default_device`); on the
    card each rank uses its ``LOCAL_RANK``'s device (0 without one)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("ray_mesh needs torch.distributed's default "
                           "process group: call init_process_group first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} needs a world of that "
                         f"size, got {world}")
    device_type = device_type or default_device().type
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _group(mesh):
    return mesh.get_group(0)


def shard_bounds(n: int, mesh, multiple: int = 1) -> tuple[int, int]:
    """This rank's columns ``[lo, hi)`` of ``n``: blocks of
    ``ceil(n / (P multiple)) * multiple`` in rank order, the last ones
    short or empty (akbx's padding to a multiple of ``P * multiple``,
    trimmed to ``n``)."""
    p = mesh.size()
    c = -(-n // (p * multiple)) * multiple
    lo = min(n, mesh.get_local_rank() * c)
    return lo, min(n, lo + c)


def shard_rays(mesh, *arrays, multiple: int = 1):
    """This rank's columns (last axis) of each (3, N) or (N,) array."""
    out = []
    for a in arrays:
        lo, hi = shard_bounds(a.shape[-1], mesh, multiple)
        out.append(a[..., lo:hi])
    return tuple(out) if len(out) > 1 else out[0]


def _quiet(collective, *args, **kw):
    # torch.distributed.nn.functional warns that it is deprecated; it is
    # the differentiable form of these collectives
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return collective(*args, **kw)


def all_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the ranks (differentiable); ``x`` itself without
    a mesh."""
    if mesh is None:
        return x
    return _quiet(dfn.all_reduce, x, group=_group(mesh))


def rank_min(x: torch.Tensor, mesh) -> torch.Tensor:
    """Elementwise least of every rank's ``x`` (differentiable); ``x``
    itself without a mesh."""
    if mesh is None:
        return x
    return torch.stack(_quiet(dfn.all_gather, x.contiguous(),
                              group=_group(mesh))).amin(dim=0)


def rank_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """Elementwise largest of every rank's ``x`` (differentiable)."""
    if mesh is None:
        return x
    return torch.stack(_quiet(dfn.all_gather, x.contiguous(),
                              group=_group(mesh))).amax(dim=0)


def all_min(x: torch.Tensor, mesh) -> torch.Tensor:
    """The least element of ``x`` over every rank (differentiable)."""
    if mesh is None:
        return torch.min(x)
    # an empty shard contributes the identity
    return rank_min(torch.min(torch.cat([x.reshape(-1),
                                         x.new_full((1,), math.inf)])), mesh)


def all_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """The largest element of ``x`` over every rank (differentiable)."""
    if mesh is None:
        return torch.max(x)
    return rank_max(torch.max(torch.cat([x.reshape(-1),
                                         x.new_full((1,), -math.inf)])), mesh)


def take_columns(x: torch.Tensor, idx: torch.Tensor, lo: int, mesh):
    """Columns ``idx`` (global indices) of the ray-sharded ``x`` whose
    first local column is global ``lo``, replicated on every rank: each
    owner contributes its columns and the rest zeros to one
    :func:`all_sum`."""
    if mesh is None:
        return x[..., idx]
    n_loc = x.shape[-1]
    loc = idx - lo
    mine = (loc >= 0) & (loc < n_loc)
    if n_loc:
        vals = torch.where(mine, x[..., loc.clamp(0, n_loc - 1)], 0.0)
    else:
        vals = x.new_zeros(x.shape[:-1] + idx.shape)
    return all_sum(vals, mesh)


def gather_rays(x: torch.Tensor, mesh) -> torch.Tensor:
    """The global array of a ray-sharded ``x`` (last axis), on every rank
    (differentiable for floating tensors)."""
    group = _group(mesh)
    n_loc = torch.tensor([x.shape[-1]], device=x.device)
    sizes = [torch.zeros_like(n_loc) for _ in range(mesh.size())]
    dist.all_gather(sizes, n_loc, group=group)
    sizes = [int(s) for s in sizes]
    is_bool = x.dtype == torch.bool
    y = x.to(torch.uint8) if is_bool else x
    pad = max(sizes) - y.shape[-1]
    if pad:
        y = torch.cat([y, y.new_zeros(y.shape[:-1] + (pad,))], dim=-1)
    parts = _quiet(dfn.all_gather, y, group=group)
    out = torch.cat([p[..., :s] for p, s in zip(parts, sizes)], dim=-1)
    return out.bool() if is_bool else out


def param_list(params) -> list:
    """The tensors of a train-step parameter dict, in the port's order:
    ``align``, then each mirror's figure coefficients."""
    return [params["align"], *params["figures"]]


def reduce_grads(tensors, mesh) -> None:
    """Make each replicated tensor's ``.grad`` the gradient of the one
    loss: the sum over the ranks divided by the world size (see the
    module's docstring)."""
    if mesh is None:
        return
    for t in tensors:
        if t.grad is not None:
            dist.all_reduce(t.grad, group=_group(mesh))
            t.grad.div_(mesh.size())


def sharded_trace(system, n_h: int, n_v: int, defocus, mesh, **kw):
    """:func:`akbx_torch.trace.run` with the fan sharded over ``mesh``:
    each rank traces its columns of the one fan; per-ray fields come back
    sharded, the tilt angles and the focus replicated."""
    from akbx_torch import trace as tr

    return tr.run(system, n_h, n_v, defocus, ray_sharding=mesh, **kw)


def huygens_sharded(source, target_points, wavelength, mesh,
                    chunk: int = 1024):
    """Huygens propagation with the targets sharded (blocks of a multiple
    of 128, as akbx pads them) and the source replicated.  Each rank runs
    the f64 path (``use_pallas=False``, as akbx does) on its targets and
    returns their (re, im)."""
    from akbx_torch import wave

    lo, hi = shard_bounds(target_points.shape[1], mesh, multiple=128)
    return wave.propagate(source, target_points[:, lo:hi], wavelength,
                          chunk=chunk, use_pallas=False)


@spans.spanned("ring")
def huygens_ring(source_points, source_re_w, source_im_w, target_points,
                 wavelength, mesh):
    """Ring-scheduled Huygens: sources and targets both sharded.

    Each rank holds a block of the sources (padded with zero weights to
    equal blocks of a multiple of 8, as akbx pads them) and its targets
    (blocks of a multiple of 8).  At each of the P steps it integrates the
    resident source block into its targets in f64 while the block travels
    on to rank ``r + 1`` and the next one arrives from ``r - 1``
    (``batch_isend_irecv``, double-buffered).  P - 1 transfers: a one-rank
    ring sends nothing.  ``source_re_w/im_w`` already include the ds
    quadrature weights.  Returns this rank's (re, im).

    The sum is :func:`akbx_torch.kernels.huygens_f64.huygens_f64`, once
    a step: K4 on the card, which records no gradient (an input that
    requires grad under grad mode raises), its twin on the CPU.
    """
    from akbx_torch.kernels.huygens_f64 import huygens_f64

    k = 2.0 * math.pi / wavelength
    p, r = mesh.size(), mesh.get_local_rank()
    group = _group(mesh)
    m = source_points.shape[1]
    cm = -(-m // (p * 8)) * 8
    lo, hi = min(m, r * cm), min(m, (r + 1) * cm)
    # one (5, cm) buffer per block: points, then the weighted field
    cur = source_points.new_zeros((5, cm))
    cur[:3, :hi - lo] = source_points[:, lo:hi]
    cur[3, :hi - lo] = source_re_w[lo:hi]
    cur[4, :hi - lo] = source_im_w[lo:hi]
    t_lo, t_hi = shard_bounds(target_points.shape[1], mesh, multiple=8)
    tp = target_points[:, t_lo:t_hi].contiguous()
    acc_re = tp.new_zeros(tp.shape[1])
    acc_im = tp.new_zeros(tp.shape[1])
    send_to = dist.get_global_rank(group, (r + 1) % p)
    recv_from = dist.get_global_rank(group, (r - 1) % p)
    for step in range(p):
        reqs = []
        if step < p - 1:
            nxt = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, send_to, group),
                dist.P2POp(dist.irecv, nxt, recv_from, group)])
        with spans.span("ring.sum"):
            huygens_f64(tp, cur[:3], cur[3], cur[4], k, acc_re, acc_im)
        if reqs:
            with spans.span("ring.wait"):
                for q in reqs:
                    q.wait()
            cur = nxt
    return acc_re, acc_im


def make_train_step(spec, loss_fn, optimizer, n_h: int, n_v: int, mesh,
                    unit_coupled: bool = False):
    """The multi-device training step (BASELINE config 5): mirror figure
    errors and alignment by gradient descent over a ray-sharded fan.

    ``loss_fn(system, engine_result) -> scalar`` sees this rank's shard of
    the result and returns the replicated loss (reduce over rays with
    :func:`all_sum` and ``trace.masked_mean(..., mesh=mesh)``).
    ``optimizer`` builds a ``torch.optim`` optimizer from a list of
    tensors (e.g. ``functools.partial(torch.optim.Adam, lr=1e-10)``); it
    is the port's ``optax`` transform, and the optimizer it builds holds
    the state.  ``params = {"align": (26,), "figures": [per-mirror
    coefficient tensors]}``, replicated, with ``requires_grad`` set.

    Returns ``(step, loss, build)``: ``step(opt_state, params) ->
    (opt_state, params, loss)`` updates ``params`` in place, where
    ``opt_state`` is the optimizer (``None`` builds it on
    :func:`param_list` of ``params``); ``loss(params)`` and
    ``build(params)`` are the loss and the system of the step.
    """
    from akbx_torch import trace as tr
    from akbx_torch.systems import AlignParams, build_wolter_3_1

    def build(params):
        align = AlignParams.from_vector(params["align"])
        sys_ = build_wolter_3_1(spec, align, unit_coupled=unit_coupled)
        mirrors = tuple(m._replace(fig_coeffs=f)
                        for m, f in zip(sys_.mirrors, params["figures"]))
        return sys_._replace(mirrors=mirrors)

    def loss(params):
        sys_ = build(params)
        res = tr.run(sys_, n_h, n_v, defocus=params["align"][0],
                     exit_pupil_uniform=False, ray_sharding=mesh)
        return loss_fn(sys_, res)

    def step(opt_state, params):
        tensors = param_list(params)
        if opt_state is None:
            opt_state = optimizer(tensors)
        opt_state.zero_grad(set_to_none=True)
        val = loss(params)
        val.backward()
        reduce_grads(tensors, mesh)
        opt_state.step()
        return opt_state, params, val.detach()

    return step, loss, build
