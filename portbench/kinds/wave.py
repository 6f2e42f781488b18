"""Huygens wave chains: the closed loop of wave-optical propagation runs.

Set-up makes ``geometries`` handoffs from the seed: each a misalignment
(normal with ``sigma`` around the design's vector 0) of the
configuration's system, traced by the plain reference at ``side`` x
``side`` rays (a uniform fan, the exit tilt removed), every mirror's
points and the source turned into the exit beam's frame, the Huygens
weights ``ds`` of each surface, and ``side`` x ``side`` grids on the
focal plane (half-size ``image_half_size``) and on the plane
``defocus_for_wave`` behind it (half-size ``2e-7 + defocus_for_wave * na
* 2``), as the program's wave handoff lays them out.

Each step is one chain through the program at ``wavelength``:
``wave.propagate_stages`` from a point source over M1..M4 and the focal
grid, then the defocused grid from M4, cycling through the handoffs.
With spans on, the chain runs its stages one call each, a span around
each.

The check, once the window has closed: for ``checked_chains`` chains
drawn from the seed among those the window ran, and its last, every
stage's field at ``checked_targets`` targets drawn from the seed against
the plain f64 Huygens sum from that stage's input, the program's own
field of the stage before (the point source for M1):
``m1_field_rel`` (source -> M1) and ``field_rel`` (the other stages),
each the largest |u - u_ref| over the largest |u_ref|.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from portbench import roofline as rf

F64 = torch.float64
NAMES = ("M1", "M2", "M3", "M4", "Image", "Defocus")
# the stage each stage propagates from (-1: the point source)
FROM = (-1, 0, 1, 2, 3, 3)


def handoff(cfg, vec, t, device):
    """One handoff of the configuration at the 26-vector ``vec``, made by
    its plain reference (``portbench.resolve``): (source (3,),
    [points (3, N) of M1..M4, the focal grid, the defocused grid], [ds of
    M1..M4])."""
    from portbench.kinds.align import _system
    from portbench.reference import huygens as ref_huygens
    from portbench.resolve import reference_modules

    ref_systems, ref_trace = reference_modules(cfg)
    side = int(t["side"])
    v = torch.as_tensor(vec, dtype=F64, device=device)
    system = _system(ref_systems, cfg, device)(v)
    with torch.no_grad():
        res = ref_trace.run(system, side, v[0], surfaces=True)
        if not bool(res.valid.all()):
            raise RuntimeError("portbench: a handoff ray missed a mirror")
        x2 = system.s2f_middle + v[0] + float(t["defocus_for_wave"])
        det2 = ref_trace.detector_points(res.points[-1], res.exit_dirs, x2)
        half2 = 2e-7 + float(t["defocus_for_wave"]) * float(t["na"]) * 2
        grids = [ref_huygens.detector_grid(res.detcenter, res.valid, side,
                                           float(t["image_half_size"])),
                 ref_huygens.detector_grid(det2, res.valid, side, half2)]
        ds = [ref_huygens.calc_ds(p, side, side) for p in res.points]
    return res.source, list(res.points) + grids, ds


def setup(ctx, spans):
    from akbx_torch.kernels import huygens as hk

    t = ctx.traffic
    vecs = np.random.default_rng(ctx.seed).normal(
        0.0, float(t["sigma"]), (int(t["geometries"]), 26))
    geoms = [handoff(ctx.config["system"], v, t, ctx.device) for v in vecs]
    st = types.SimpleNamespace(ctx=ctx, geoms=geoms,
                               lam=float(t["wavelength"]), chains=[], hk=hk)
    n = geoms[0][1][0].shape[1]
    st.pairs = [n * (1 if f < 0 else geoms[0][1][f].shape[1]) for f in FROM]
    for i, sp in enumerate([None] * 2 + [spans] * (2 if ctx.trace else 0)):
        step(st, i, sp)
    from portbench.harness import sync

    sync(ctx.device)
    spans.resolve()
    spans.ms.clear()
    st.chains.clear()
    st.launches0 = hk.huygens.launches
    return st


def _source(st, g):
    from akbx_torch import wave

    return wave.point_source(st.geoms[g][0], device=st.ctx.device)


def step(st, i: int, spans):
    """Chain ``i``: the point source through every stage."""
    from akbx_torch import wave

    g = i % len(st.geoms)
    _, pts, ds = st.geoms[g]
    stages = [{"points": pts[j], "ds": ds[j], "name": NAMES[j]}
              for j in range(4)] + [{"points": pts[4], "name": NAMES[4]}]
    if spans is None or not spans.on:
        fields = wave.propagate_stages(_source(st, g), stages, st.lam)
        fields.append(wave.propagate_field(fields[3], pts[5], st.lam))
    else:
        fields = []
        for j, f in enumerate(FROM):
            src = _source(st, g) if f < 0 else fields[f]
            with spans.span("stage_src" if f < 0 else "stage"):
                if j < 5:
                    out = wave.propagate_stages(src, [stages[j]], st.lam)[0]
                else:
                    out = wave.propagate_field(src, pts[5], st.lam)
            fields.append(out)
    st.chains.append((g, [(f.re, f.im) for f in fields]))


def window(st, n_steps: int) -> dict:
    """Stages attempted and failed (a field not finite), the source-target
    pairs of the stages that did not fail, K3's launches.  The check
    draws from these ``n_steps`` chains alone, not from those of a
    profiled window after them."""
    st.n_window = n_steps
    bad = 0
    good_pairs = 0
    for _, fields in st.chains[:n_steps]:
        for (re, im), pairs in zip(fields, st.pairs):
            if bool(torch.isfinite(re).all() and torch.isfinite(im).all()):
                good_pairs += pairs
            else:
                bad += 1
    out = {"attempted": n_steps * len(NAMES), "failed": bad,
           "work": good_pairs, "work_unit": "pairs"}
    if hasattr(st, "hk"):
        out["launches"] = {"K3": st.hk.huygens.launches - st.launches0}
    return out


def roofline(st, n_steps: int) -> dict:
    """The least device time of K3 over ``n_steps`` chains."""
    n = st.geoms[0][1][0].shape[1]
    shapes = [(n, 1 if f < 0 else st.geoms[0][1][f].shape[1]) for f in FROM]
    return {"huygens_kernel":
            n_steps * sum(rf.k3_seconds(a, b) for a, b in shapes)}


def free(st):
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def sampled_chains(st, seed: int) -> list:
    n_done = st.n_window
    count = min(int(st.ctx.traffic["checked_chains"]), n_done)
    rng = np.random.default_rng([seed, 2])
    picked = {int(j) for j in rng.choice(n_done, count, replace=False)}
    return sorted(picked | {n_done - 1})


def compare(st, seed: int, chains) -> dict:
    """The numbers of the check for ``chains``: a list of (handoff index,
    [(re, im) of each stage]), the program's or a stand-in's."""
    from portbench.reference import huygens as ref_huygens

    dev = st.ctx.device
    rng = np.random.default_rng([seed, 3])
    out = {"m1_field_rel": 0.0, "field_rel": 0.0}
    for g, fields in chains:
        source, pts, ds = st.geoms[g]
        for j, f in enumerate(FROM):
            n_t = pts[j].shape[1]
            idx = torch.as_tensor(np.sort(rng.choice(
                n_t, min(int(st.ctx.traffic["checked_targets"]), n_t),
                replace=False)), device=dev)
            if f < 0:
                one = torch.ones(1, dtype=F64, device=dev)
                src = (source[:, None], one, torch.zeros_like(one), one)
            else:
                re, im = fields[f]
                src = (pts[f], re.to(dev), im.to(dev), ds[f])
            ref = torch.complex(*ref_huygens.huygens(*src, pts[j][:, idx],
                                                     st.lam))
            got = torch.complex(fields[j][0].to(dev)[idx],
                                fields[j][1].to(dev)[idx])
            rel = float((got - ref).abs().max() / ref.abs().max())
            key = "m1_field_rel" if f < 0 else "field_rel"
            out[key] = max(out[key], rel) if np.isfinite(rel) else float(
                "inf")
    return out


def check(st, seed: int) -> dict:
    return compare(st, seed, [st.chains[c] for c in sampled_chains(st, seed)])


def control(st, seed: int, dtype=torch.float32) -> dict:
    """The check's numbers with the plain Huygens sum in ``dtype`` put in
    the program's place, every stage from its own stage before."""
    from portbench.reference import huygens as ref_huygens

    dev = st.ctx.device
    chains = []
    for c in sampled_chains(st, seed):
        g = st.chains[c][0]
        source, pts, ds = st.geoms[g]
        fields = []
        for j, f in enumerate(FROM):
            if f < 0:
                one = torch.ones(1, dtype=F64, device=dev)
                src = (source[:, None], one, torch.zeros_like(one), one)
            else:
                src = (pts[f], *fields[f], ds[f])
            fields.append(ref_huygens.huygens(*src, pts[j], st.lam,
                                              dtype=dtype, block=2048))
        chains.append((g, fields))
    return compare(st, seed, chains)
