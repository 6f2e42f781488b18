"""Alignment steps: the closed loop of an alignment or tolerancing run.

Each step builds the configuration's system from a 26-vector (placement
and misalignment), traces an ``fan`` x ``fan`` fan through it with
``trace.run(precision=...)`` (no exit-pupil re-fan, tilt removal), takes
the bench loss on the deviation fields and its gradient in the 26-vector.
The vectors are drawn before the window from the seed, normal with
``sigma`` around the design's vector 0, so every step is new.

The check runs once the window has closed and the program's state is
freed.  The plain f64 reference (``portbench/reference``) builds and
traces the same vectors again and differentiates its own loss:

* ``loss_rel``, ``grad_rel``: every sampled step's loss and gradient
  (``checked_steps`` steps drawn from the seed among those the window
  ran, the kept ones among them);
* ``detcenter_m``, ``w32_m``, ``ddet32_m``, ``valid_diff``: the fields of
  two kept steps, one drawn from the seed among the first eight and the
  window's last: the focal-plane points, the demeaned OPL and the
  detector deviations from the chief, over the valid rays, and the number
  of rays whose validity differs;
* ``coeffs_rel``: the placed mirrors' quadric coefficients of those two
  steps, the placement's worst mirror.

Only the window's steps are checked, not those of a profiled window after
it.  The control (``control.py``) is the program with its own path below
the configuration's precision switched on, where the configuration names
one, else the plain reference in float32 in the program's place.

The traffic file's keys: ``fan``, ``sigma``, ``vectors`` (how many are
drawn; the window cycles through them), ``precision``, ``checked_steps``,
``profile_steps``.  The configuration's ``system`` names the spec class,
its factory and arguments, and the system builder, by the same names in
``akbx_torch.systems`` and in the reference's systems module
(``portbench.resolve``: ``reference`` and ``reference_trace`` name the
configuration's modules of ``portbench/reference``), and may
name in ``lower_options`` the builder's options of its lower path.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from portbench import roofline as rf
from portbench.resolve import find, reference_modules

F64 = torch.float64


def _system(module, cfg, device, **options):
    """The builder ``v -> OpticalSystem`` of the configuration in
    ``module`` (the program's ``systems`` or the reference's), with the
    builder's keyword ``options``."""
    args = cfg["args"]
    if cfg.get("factory"):
        spec = find(module, cfg["spec"] + "." + cfg["factory"])(
            **args, device=device)
    else:
        spec = find(module, cfg["spec"])(**args)
    builder = find(module, cfg["builder"])
    return lambda v: builder(spec, module.AlignParams.from_vector(v),
                             **options)


def bench_loss(res):
    """The bench's loss on the fast engine's f32 deviation fields: the
    squared demeaned OPL deviation (m, scaled by 1e18) over the valid rays
    plus the spot's two standard deviations."""
    from akbx_torch import trace

    sy, sz = trace.spot_size(res.ddet32, res.valid)
    return (torch.sum(torch.where(res.valid, res.w32, 0.0) ** 2) * 1e18
            + sy + sz)


def setup(ctx, spans):
    from akbx_torch import systems
    from akbx_torch.kernels import trace_kernel as tk

    t = ctx.traffic
    st = types.SimpleNamespace(
        ctx=ctx, n=int(t["fan"]), precision=t["precision"],
        vecs=torch.tensor(np.random.default_rng(ctx.seed).normal(
            0.0, float(t["sigma"]), (int(t["vectors"]), 26)), dtype=F64,
            device=ctx.device),
        build=_system(systems, ctx.config["system"], ctx.device),
        mirrors=int(ctx.config["mirrors"]), losses=[], grads=[], kept={},
        keep_first=int(np.random.default_rng([ctx.seed, 4]).integers(0, 8)),
        tk=tk)
    # every shape of the window, and of the traced window, twice
    for i, sp in enumerate([None] * 2 + [spans] * (2 if ctx.trace else 0)):
        step(st, i, sp)
    from portbench.harness import sync

    sync(ctx.device)
    spans.resolve()
    spans.ms.clear()
    st.losses.clear()
    st.grads.clear()
    st.kept.clear()
    st.launches0 = (tk.trace_deviation.launches, tk.detector.launches)
    return st


def _fields(res, system):
    """The outputs of a step that the check compares: the trace's fields
    and the placed mirrors' quadric coefficients."""
    return {"detcenter": res.detcenter.detach(), "w32": res.w32.detach(),
            "ddet32": res.ddet32.detach(), "valid": res.valid.detach(),
            "coeffs": _coeffs(system)}


def _coeffs(system):
    """The (mirrors, 10) quadric coefficients of a placed system."""
    return torch.stack([m.coeffs.detach() for m in system.mirrors])


def _run_options(st, v) -> dict:
    return dict(defocus=v[0], exit_pupil_uniform=False,
                tilt_correction=True, precision=st.precision)


def _traced(st, build, v):
    """The program's step at the leaf ``v`` through ``build``: (system,
    result, loss), the gradient left in ``v.grad``."""
    from akbx_torch import trace

    system = build(v)
    res = trace.run(system, st.n, st.n, **_run_options(st, v))
    loss = bench_loss(res)
    loss.backward()
    return system, res, loss


def step(st, i: int, spans):
    """Step ``i``: build, trace, loss, gradient.  With ``spans`` on, the
    same step cut at the program's layer boundaries: the build, the
    forward (``trace.run`` and the loss), the trace's backward (the twin's
    VJP, down to the mirrors' tensors) and the build's backward."""
    from akbx_torch import trace
    from akbx_torch.surfaces import Mirror

    v = st.vecs[i % st.vecs.shape[0]].clone().requires_grad_(True)
    if spans is None or not spans.on:
        system, res, loss = _traced(st, st.build, v)
    else:
        run = _run_options(st, v)
        with spans.span("build"):
            system = st.build(v)
        with spans.span("trace_fwd"):
            tensors = trace._tensors_of(system)
            leaves = [x.detach().requires_grad_(x.requires_grad)
                      for x in tensors]
            k = len(Mirror._fields)
            mirrors = tuple(Mirror(*leaves[j:j + k])
                            for j in range(0, len(leaves), k))
            res = trace.run(system._replace(mirrors=mirrors), st.n, st.n,
                            **run)
            loss = bench_loss(res)
        with spans.span("trace_bwd"):
            need = [j for j, x in enumerate(tensors) if x.requires_grad]
            loss.backward(inputs=[v] + [leaves[j] for j in need])
        with spans.span("build_bwd"):
            reached = [j for j in need if leaves[j].grad is not None]
            torch.autograd.backward([tensors[j] for j in reached],
                                    [leaves[j].grad for j in reached])
    st.losses.append(loss.detach())
    st.grads.append(v.grad)
    if i == st.keep_first:
        st.kept["first"] = (i, _fields(res, system))
    st.kept["last"] = (i, _fields(res, system))


def window(st, n_steps: int) -> dict:
    """The window's counts: steps attempted, failed (a loss or gradient
    not finite), rays traced forward and backward by the steps that did
    not fail, kernel launches.  The check draws from these ``n_steps``
    steps alone, and the kept fields are the window's: steps that run
    after it (a profiled window) are not checked."""
    st.n_window, st.kept_window = n_steps, dict(st.kept)
    losses = torch.stack(st.losses[:n_steps])
    grads = torch.stack(st.grads[:n_steps])
    ok = torch.isfinite(losses) & torch.isfinite(grads).all(dim=1)
    for i, f in st.kept.values():
        if not all(bool(torch.isfinite(f[k]).all())
                   for k in ("detcenter", "w32", "ddet32")):
            ok[i] = False
    good = int(ok.sum())
    tk = st.tk
    return {"attempted": n_steps, "failed": n_steps - good,
            "work": good * st.n ** 2, "work_unit": "rays",
            "launches": {"K1": tk.trace_deviation.launches - st.launches0[0],
                         "K2": tk.detector.launches - st.launches0[1]}}


def roofline(st, n_steps: int) -> dict:
    """The least device time of the kernels of ``n_steps`` steps, by the
    name of each kernel (``portbench.roofline``)."""
    return {"trace_deviation_kernel":
            n_steps * rf.k1_seconds(st.n ** 2, st.mirrors)}


def free(st):
    """Drop the program's state, keep its outputs."""
    st.build = None
    st.losses = torch.stack(st.losses).cpu()
    st.grads = torch.stack(st.grads).cpu()
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def sampled_steps(st, seed: int) -> list:
    n_done = st.n_window
    count = min(int(st.ctx.traffic["checked_steps"]), n_done)
    rng = np.random.default_rng([seed, 1])
    picked = {int(j) for j in rng.choice(n_done, count, replace=False)}
    picked |= {i for i, _ in st.kept_window.values()}
    return sorted(picked)


def reference_step(cfg, v, n: int, device, dtype=F64):
    """The plain reference's step at ``v``: the system placed in f64, then
    the trace and loss in ``dtype``; returns (loss, gradient, result,
    system)."""
    ref_systems, ref_trace = reference_modules(cfg)
    build = _system(ref_systems, cfg, device)
    v = v.detach().clone().to(device).requires_grad_(True)
    system = build(v)
    if dtype != F64:
        system = cast_system(system, dtype)
    res = ref_trace.run(system, n, v[0].to(dtype))
    loss = ref_trace.bench_loss(res)
    loss.backward()
    return loss.detach().double(), v.grad.detach(), res, system


def cast_system(system, dtype):
    """The placed system with every floating tensor in ``dtype``."""
    def cast(x):
        return x.to(dtype) if x.is_floating_point() else x

    mirrors = tuple(type(m)(*(cast(x) for x in m)) for m in system.mirrors)
    return system._replace(mirrors=mirrors, s2f_middle=cast(system.s2f_middle),
                           fan_h=cast(system.fan_h), fan_v=cast(system.fan_v),
                           source=cast(system.source))


def _field_numbers(fields, ref, ref_system, n: int, ref_trace) -> dict:
    """The kept step's fields against the reference's result and placed
    system (``ref_trace``: the reference's trace module)."""
    v = ref.valid
    det = fields["detcenter"].to(v.device).double()
    w_ref = ref_trace.demeaned_opl(ref).detach().double()
    det_ref = ref.detcenter.detach().double()
    chief = (n * n) // 2
    ddet_ref = det_ref - det_ref[:, chief:chief + 1]
    both = v & fields["valid"].to(v.device)

    def worst(x):
        x = x[..., both].abs()
        return float(x.max()) if x.numel() else float("inf")

    return {"detcenter_m": worst(det - det_ref),
            "w32_m": worst(fields["w32"].to(v.device).double() - w_ref),
            "ddet32_m": worst(fields["ddet32"].to(v.device).double()
                              - ddet_ref),
            "valid_diff": float((fields["valid"].to(v.device) != v).sum()),
            "coeffs_rel": _coeffs_rel(fields["coeffs"].to(v.device),
                                      _coeffs(ref_system))}


def _coeffs_rel(c, ref):
    """The placement's worst mirror: the largest |c - ref| of a mirror's
    quadric coefficients over the largest |ref| of that mirror."""
    c, ref = c.double(), ref.double()
    return float(((c - ref).abs().amax(dim=1)
                  / ref.abs().amax(dim=1)).max())


def _grad_rel(g, ref):
    """Largest |g - ref| over max(|ref|, 1e-6 of ref's largest entry)."""
    scale = ref.abs().max()
    return float(((g - ref).abs()
                  / torch.clamp_min(ref.abs(), 1e-6 * scale)).max())


def _worse(a: float, b: float) -> float:
    """The larger of two readings; a reading that is not a number is
    infinitely bad."""
    return max(a, b) if np.isfinite(b) else float("inf")


def compare(st, seed: int, produce) -> dict:
    """The numbers of the check: ``produce(i, v)`` gives the loss,
    gradient and kept fields (or None) of step ``i`` at vector ``v``, as
    the program gave them or as a stand-in computes them."""
    cfg, dev = st.ctx.config["system"], st.ctx.device
    ref_trace = reference_modules(cfg)[1]
    out = {"loss_rel": 0.0, "grad_rel": 0.0, "detcenter_m": 0.0,
           "w32_m": 0.0, "ddet32_m": 0.0, "valid_diff": 0.0,
           "coeffs_rel": 0.0}
    kept = {i: f for i, f in st.kept_window.values()}
    for i in sampled_steps(st, seed):
        v = st.vecs[i % st.vecs.shape[0]]
        loss, grad, fields = produce(i, v)
        ref_loss, ref_grad, ref, ref_system = reference_step(cfg, v, st.n,
                                                             dev)
        ref_loss, ref_grad = ref_loss.cpu(), ref_grad.cpu()
        out["loss_rel"] = _worse(out["loss_rel"], float(
            (loss.double() - ref_loss).abs() / ref_loss.abs()))
        out["grad_rel"] = _worse(out["grad_rel"],
                                 _grad_rel(grad.double(), ref_grad))
        if i in kept and fields is not None:
            for k, x in _field_numbers(fields, ref, ref_system, st.n,
                                       ref_trace).items():
                out[k] = _worse(out[k], x)
        del ref
    return out


def check(st, seed: int) -> dict:
    kept = {i: f for i, f in st.kept_window.values()}
    return compare(st, seed, lambda i, v: (st.losses[i], st.grads[i],
                                           kept.get(i)))


def control(st, seed: int) -> dict:
    """The check's numbers for the control of ``correct``: the program
    with its own path below the configuration's precision switched on,
    where the configuration names one (``system.lower_options``, the
    builder's options of that path), else the plain reference in float32
    in the program's place."""
    lower = st.ctx.config["system"].get("lower_options")
    if lower:
        return rerun(st, seed, **lower)
    return control_reference(st, seed)


def rerun(st, seed: int, **options) -> dict:
    """The check's numbers of the program's step computed again at every
    sampled step's vector, built with the builder's ``options``: the
    control where they switch on the program's lower path, a fault's
    reading where a fault is planted in the program."""
    from akbx_torch import systems

    build = _system(systems, st.ctx.config["system"], st.ctx.device,
                    **options)

    def produce(i, v):
        v = v.clone().requires_grad_(True)
        system, res, loss = _traced(st, build, v)
        return loss.detach().cpu(), v.grad.cpu(), _fields(res, system)

    return compare(st, seed, produce)


def control_reference(st, seed: int, dtype=torch.float32) -> dict:
    """The check's numbers with the reference in ``dtype`` put in the
    program's place."""
    cfg, dev = st.ctx.config["system"], st.ctx.device
    ref_trace = reference_modules(cfg)[1]

    def produce(i, v):
        loss, grad, res, system = reference_step(cfg, v, st.n, dev, dtype)
        chief = (st.n ** 2) // 2
        det = res.detcenter.detach()
        fields = {"detcenter": det, "valid": res.valid,
                  "w32": ref_trace.demeaned_opl(res).detach(),
                  "ddet32": det - det[:, chief:chief + 1],
                  "coeffs": _coeffs(system)}
        return loss.cpu(), grad.cpu(), fields

    return compare(st, seed, produce)
