"""Huygens wave chains across cards: the chains of ``wave``, each stage
run as ``parallel.sharding.huygens_ring`` over every rank of the run.

Each rank holds a block of a stage's sources and a block of its targets;
the source blocks travel round the ring (P - 1 transfers) while every
rank sums them into its targets on the program's f64 path.  After each
stage every rank gathers the stage's whole field, which the next stage
takes as its sources, as a user's chain would.  The handoffs are those
of ``wave`` (made by the plain reference on rank 0 and sent to every
rank), so is the check, on rank 0 once the window has closed.

The traffic file's keys are ``wave``'s, and ``warm_chains``: the chains
of the set-up's warm-up.
"""

from __future__ import annotations

import contextlib
import types

import numpy as np
import torch

from portbench.kinds import wave

NAMES, FROM = wave.NAMES, wave.FROM


def _broadcast(x: torch.Tensor, mesh) -> torch.Tensor:
    import torch.distributed as dist
    from akbx_torch.parallel import sharding as sh

    x = x.contiguous()
    dist.broadcast(x, dist.get_global_rank(sh._group(mesh), 0),
                   group=sh._group(mesh))
    return x


def gather(x: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """The whole (n,) array from every rank's block of ``shard_bounds(n,
    mesh, multiple=8)``, on every rank."""
    import torch.distributed as dist
    from akbx_torch.parallel import sharding as sh

    p = mesh.size()
    c = -(-n // (p * 8)) * 8
    buf = x.new_zeros(c)
    buf[:x.shape[0]] = x
    out = [torch.empty_like(buf) for _ in range(p)]
    dist.all_gather(out, buf, group=sh._group(mesh))
    return torch.cat(out)[:n]


def setup(ctx, spans):
    t = ctx.traffic
    vecs = np.random.default_rng(ctx.seed).normal(
        0.0, float(t["sigma"]), (int(t["geometries"]), 26))
    geoms = []
    for v in vecs:
        source, pts, ds = wave.handoff(ctx.config["system"], v, t, ctx.device)
        geoms.append((_broadcast(source, ctx.mesh),
                      [_broadcast(p, ctx.mesh) for p in pts],
                      [_broadcast(d, ctx.mesh) for d in ds]))
    st = types.SimpleNamespace(ctx=ctx, geoms=geoms, mesh=ctx.mesh,
                               lam=float(t["wavelength"]), chains=[])
    n = geoms[0][1][0].shape[1]
    st.pairs = [n * (1 if f < 0 else geoms[0][1][f].shape[1]) for f in FROM]
    warm = [None] * int(t["warm_chains"]) + ([spans] if ctx.trace else [])
    for i, sp in enumerate(warm):
        step(st, i, sp)
    from portbench.harness import sync

    sync(ctx.device)
    spans.resolve()
    spans.ms.clear()
    st.chains.clear()
    return st


def step(st, i: int, spans):
    """Chain ``i``: the point source through every stage, each stage on
    the ring, its field gathered on every rank."""
    from akbx_torch.parallel import sharding as sh

    g = i % len(st.geoms)
    source, pts, ds = st.geoms[g]
    dev = st.ctx.device
    fields = []
    for j, f in enumerate(FROM):
        if f < 0:
            src = source[:, None]
            w_re = torch.ones(1, dtype=torch.float64, device=dev)
            w_im = torch.zeros_like(w_re)
        else:
            src = pts[f]
            w_re, w_im = fields[f][0] * ds[f], fields[f][1] * ds[f]
        # the span holds the ring alone: a rank leaves it when its own
        # last block is summed, so the spans of the ranks differ by their
        # work and their waits, and the gather after it evens them out
        with (spans.span("stage_src" if f < 0 else "stage")
              if spans is not None else contextlib.nullcontext()):
            re, im = sh.huygens_ring(src, w_re, w_im, pts[j], st.lam,
                                     st.mesh)
        n = pts[j].shape[1]
        fields.append((gather(re, n, st.mesh), gather(im, n, st.mesh)))
    st.chains.append((g, fields))


window = wave.window


def roofline(st, n_steps: int) -> dict:
    """The ring runs the program's f64 path: no kernel of the port."""
    return {}


free = wave.free
check = wave.check
control = wave.control
