#!/usr/bin/env python3
"""Where KB's bench-loss gradient on the fast engine departs from the f64
engine's, by fan size.

Run from the repository root, on the card (default) or the CPU:

    python3 chip_gradient_probe.py [--device cpu] [--sizes 64,256,2048]

KB (akbx's KB7 design) at chip_smoke.py's seeded misalignment after its
auto_focus at 21.  At each n x n fan, the gradient of chip_smoke.py's
f64-field bench loss with respect to the 26-vector:

* ``fast``: the fast engine (K1 and K2 forward, the float64 twin's VJP);
  ``fast_hi``: the same with the tilt-removal angles and pivot reduced
  from K1's f32 hi words, as akbx reduces them (ROADMAP F9);
* ``f64``: the f64 engine, the OPL summed as ``trace.run`` sums it (the
  compensated ``sum_segments``), and ``f64_plain_sum`` with a plain f64
  sum of the legs instead;
* ``f64_J@fast_hi``: the f64 engine's Jacobian applied to the loss's
  cotangent taken at ``fast_hi``'s values (OPL and detector points),
  and ``f64_J@df32`` to the cotangent at the df32 engine's.

The gradient is the Jacobian of the fields applied to the cotangent at
the fields' values, so ``f64_J@fast_hi`` against ``fast_hi`` is the part
of ``fast_hi`` vs ``f64`` that comes from the two engines' Jacobians,
and against ``f64`` the part from their values; ``f64_J@df32`` weighs
them against a third engine's.  Prints one JSON line a size: the tilt
angles' distance from the f64 engine's (rad), and for each pair of
gradients chip_smoke.py's ``grad_rel`` (the largest |g - g_ref| over
max(|g_ref|, 1e-6 of g_ref's largest)), the worst component's index and
its |g_ref| over the largest.
"""

import argparse
import contextlib
import json
import types

import numpy as np
import torch

import chip_smoke as cs


@contextlib.contextmanager
def plain_leg_sum():
    """``trace.run`` sums the legs in plain f64 while open."""
    from akbx_torch.core import precision

    kept = precision.sum_segments
    precision.sum_segments = lambda legs: sum(legs)
    try:
        yield
    finally:
        precision.sum_segments = kept


@contextlib.contextmanager
def hi_word_tilt():
    """While open, the fast engine's forward reduces the tilt angles and
    pivot from the f32 hi words of K1's deviations (its twin, which
    differentiates, keeps float64)."""
    from akbx_torch import trace

    kept = trace._tilt_stats, trace._pre_tilt_focus

    def hi(x):
        return x if x.requires_grad else x.float()

    trace._tilt_stats = lambda D4, dd4, *a: kept[0](D4, hi(dd4), *a)
    trace._pre_tilt_focus = lambda P4, D4, det_x, dq4, dd4, valid: kept[1](
        P4, D4, det_x, hi(dq4), hi(dd4), valid)
    try:
        yield
    finally:
        trace._tilt_stats, trace._pre_tilt_focus = kept


def cotangent(res):
    """The f64-field loss's cotangent at ``res``'s OPL and detector
    points."""
    total = res.total_dist.detach().requires_grad_(True)
    det = res.detcenter.detach().requires_grad_(True)
    loss = cs.f64_field_loss(types.SimpleNamespace(
        total_dist=total, detcenter=det, valid=res.valid))
    return torch.autograd.grad(loss, (total, det))


def applied(vec, n, build, precision, cot):
    """``precision``'s engine's Jacobian applied to the cotangent
    ``cot``."""
    from akbx_torch import trace

    v = vec.detach().clone().requires_grad_(True)
    res = trace.run(build(v), n, n, defocus=v[0], exit_pupil_uniform=False,
                    tilt_correction=True, precision=precision)
    ct, cd = cot
    ok = res.valid
    (torch.sum(ct * torch.where(ok, res.total_dist, 0.0))
     + torch.sum(cd * torch.where(ok, res.detcenter, 0.0))).backward()
    return v.grad


def values(vec, n, build, precision):
    from akbx_torch import trace

    with torch.no_grad():
        return trace.run(build(vec), n, n, defocus=vec[0],
                         exit_pupil_uniform=False, tilt_correction=True,
                         precision=precision)


def worst(g, ref):
    rel = ((g - ref).abs()
           / torch.clamp_min(ref.abs(), 1e-6 * ref.abs().max()))
    i = int(rel.argmax())
    return float(rel[i]), i, float(ref[i].abs() / ref.abs().max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default="64,256,512,1024,2048")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("chip_gradient_probe: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    build = cs.new_systems(dev)["kb"]
    vec = torch.tensor(np.random.default_rng(cs.SEED + 1).normal(
        0.0, 1e-5, 26), dtype=torch.float64, device=dev)
    vec = cs.focused(build, vec)
    print(f"device {dev}; KB7 at the focused seeded vector", flush=True)
    for n in (int(s) for s in args.sizes.split(",")):
        grads = {
            "fast": cs.grad_step(vec, n, cs.f64_field_loss, build=build)[1],
            "f64": cs.grad_step(vec, n, cs.f64_field_loss, "f64",
                                build=build)[1],
        }
        with hi_word_tilt():
            grads["fast_hi"] = cs.grad_step(vec, n, cs.f64_field_loss,
                                            build=build)[1]
            fast_hi = values(vec, n, build, "pallas")
        with plain_leg_sum():
            grads["f64_plain_sum"] = cs.grad_step(
                vec, n, cs.f64_field_loss, "f64", build=build)[1]
        gold = values(vec, n, build, "f64")
        row = {"device": str(dev), "n": n}
        for label, res in (("fast", values(vec, n, build, "pallas")),
                           ("fast_hi", fast_hi)):
            row[f"theta {label} - f64"] = [
                float(getattr(res, f) - getattr(gold, f))
                for f in ("theta_y", "theta_z")]
        grads["f64_J@fast_hi"] = applied(vec, n, build, "f64",
                                         cotangent(fast_hi))
        grads["f64_J@df32"] = applied(vec, n, build, "f64", cotangent(
            values(vec, n, build, "df32")))
        del fast_hi, gold
        for a, b in (("fast", "f64"), ("fast_hi", "f64"),
                     ("f64_plain_sum", "f64"),
                     ("f64_J@fast_hi", "fast_hi"), ("f64_J@fast_hi", "f64"),
                     ("f64_J@df32", "f64")):
            row[f"{a} vs {b}"] = worst(grads[a], grads[b])
        print(json.dumps(row), flush=True)
        del grads
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
