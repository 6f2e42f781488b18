"""The ranks of tests/test_torch_parallel.py: one gloo world of spawned CPU
processes runs every sharded function of ``akbx_torch.parallel`` once and
returns rank 0's results (with every rank's shard widths) as numpy.

This module imports torch and akbx_torch only, never jax: the workers
start from a fresh import of it.
"""

from __future__ import annotations

import functools
import traceback

import numpy as np
import torch
import torch.distributed as dist

from akbx_torch import convert, spans, trace
from akbx_torch.parallel import batching, dryrun, fft as pfft
from akbx_torch.parallel import sharding as sh
from akbx_torch.systems import AlignParams, WOLTER_3_1_DEFAULT, build_wolter_3_1
from akbx_torch.utils import to_numpy
from akbx_torch.wave import WaveField

N_H, N_V = 9, 11        # 99 rays: ragged shards (25, 25, 25, 24) on 4 ranks
TRACE_CASES = {
    "f64": dict(precision="f64", exit_pupil_uniform=False,
                tilt_correction=False),
    "f64_refan_tilt": dict(precision="f64"),
    "f64_extremes": dict(precision="f64", exit_pupil_uniform=False,
                         tilt_mode="extremes"),
    "pallas_refan_tilt": dict(precision="pallas"),
    "df32_refan_tilt": dict(precision="df32"),
}
TRACE_FIELDS = ("detcenter", "detcenter2", "total_dist", "total_dist2",
                "wave2", "valid")
WAVELENGTH = 13.5e-9
TRAIN_FAN = 9
LR = 1e-10


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def cloud(dev, n, m, seed):
    """A seeded field of ``m`` sources near 145 m and ``n`` targets near
    146 m (akbx's kernel tests, tests/test_kernels.py::_mk): (WaveField,
    targets (3, n) f64)."""
    rng = np.random.default_rng(seed)
    src = np.array([145.0, 0.02, 0.0])[:, None] + rng.normal(size=(3, m)) * 0.05
    tgt = np.array([146.0, 0.05, 0.01])[:, None] + rng.normal(size=(3, n)) * 0.02
    u = rng.normal(size=m) + 1j * rng.normal(size=m)
    ds = np.abs(rng.normal(size=m)) * 1e-8
    return (WaveField.from_complex(src, u, ds, device=dev),
            torch.tensor(tgt, device=dev))


def loss_fn_for(mesh):
    """akbx's train-step test loss: the squared demeaned OPL, summed."""
    def loss_fn(sys_, res):
        w = res.total_dist - trace.masked_mean(res.total_dist, res.valid,
                                               mesh=mesh)
        return sh.all_sum(torch.sum(torch.where(res.valid, w, 0.0) ** 2),
                          mesh) * 1e18
    return loss_fn


def task_trace(mesh, inp):
    system = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.zeros("cpu"))
    out = {}
    for name, kw in TRACE_CASES.items():
        for label, m in (("sharded", mesh), ("unsharded", None)):
            res = trace.run(system, N_H, N_V, 0.0, ray_sharding=m, **kw)
            got = {f: to_numpy(getattr(res, f) if m is None
                               else sh.gather_rays(getattr(res, f), m))
                   for f in TRACE_FIELDS}
            for f in ("theta_y", "theta_z", "focus_apprx", "rand_p0h",
                      "rand_p0v"):
                got[f] = to_numpy(getattr(res, f))
            got["spot"] = [float(s) for s in
                           trace.spot_size(res.detcenter, res.valid, m)]
            got["width"] = res.detcenter.shape[1]
            out[(name, label)] = got
    return out


def task_shard(mesh, inp):
    """shard_rays' columns of a (3, 99) and a (99,) array, plain and in
    blocks of a multiple of 8, gathered back."""
    a = torch.arange(3 * 99, dtype=torch.float64).reshape(3, 99)
    out = {}
    for multiple in (1, 8):
        x, y = sh.shard_rays(mesh, a, a[0], multiple=multiple)
        out[multiple] = (x.shape[1], to_numpy(sh.gather_rays(x, mesh)),
                         to_numpy(sh.gather_rays(y, mesh)),
                         to_numpy(sh.gather_rays(x[0] > 150, mesh)))
    return out


def task_huygens(mesh, inp):
    out = {}
    h = {k: _t(v) for k, v in inp["huygens"].items()}
    field = WaveField(h["src"], h["u_re"], h["u_im"], h["ds"], 0, 0)
    re, im = sh.huygens_sharded(field, h["tgt"], WAVELENGTH, mesh, chunk=64)
    out["sharded"] = (to_numpy(sh.gather_rays(re, mesh)),
                      to_numpy(sh.gather_rays(im, mesh)), re.shape[0])
    for key in ("ring", "ring_ragged"):
        d = {k: _t(v) for k, v in inp[key].items()}
        re, im = sh.huygens_ring(d["src"], d["w_re"], d["w_im"], d["tgt"],
                                 WAVELENGTH, mesh)
        out[key] = (to_numpy(sh.gather_rays(re, mesh)),
                    to_numpy(sh.gather_rays(im, mesh)), re.shape[0])
        # the same call with the spans on: its spans, and its fields
        spans.enable("cpu")
        try:
            re2, im2 = sh.huygens_ring(d["src"], d["w_re"], d["w_im"],
                                       d["tgt"], WAVELENGTH, mesh)
        finally:
            spans.disable()
        recs = spans.take()
        out[key + "_spans"] = {
            "paths": sorted(r.path for r in recs),
            "same": bool(torch.equal(re, re2) and torch.equal(im, im2))}
    return out


def task_streamed(mesh, inp):
    system = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.zeros("cpu"))
    calls = []
    stats = batching.trace_streamed(system, 16, 24, 0.0, block_rows=7,
                                    mesh=mesh,
                                    progress=lambda b, n: calls.append((b, n)))
    res = trace.run(system, 16, 24, 0.0, exit_pupil_uniform=False,
                    tilt_correction=False)
    return {"n": float(stats.n), "centroid": to_numpy(stats.centroid),
            "spot_std": to_numpy(stats.spot_std),
            "opl_std": float(stats.opl_std),
            "min_yz": to_numpy(stats.min_yz),
            "max_yz": to_numpy(stats.max_yz), "calls": calls,
            "det": to_numpy(res.detcenter), "valid": to_numpy(res.valid),
            "total": to_numpy(res.total_dist)}


def task_fft(mesh, inp):
    f = inp["fft"]
    out = {}
    fft2, ifft2 = pfft.make_fft2(mesh), pfft.make_fft2(mesh, inverse=True)
    u = torch.as_tensor(f["u"])
    got = fft2(pfft.shard_rows(mesh, u))
    out["fft2"] = to_numpy(pfft.gather_rows(got, mesh))
    out["fft2_local_shape"] = tuple(got.shape)
    out["ifft2"] = to_numpy(pfft.gather_rows(
        ifft2(pfft.shard_rows(mesh, torch.as_tensor(f["v"]))), mesh))
    r = torch.as_tensor(f["r"])
    out["roundtrip"] = to_numpy(pfft.gather_rows(
        ifft2(fft2(pfft.shard_rows(mesh, r))), mesh))
    raised = []
    for bad in (lambda: pfft.shard_rows(mesh, torch.zeros(30, 32)),
                lambda: fft2(torch.zeros(8, 30, dtype=torch.complex128))):
        try:
            bad()
        except ValueError as e:
            raised.append(str(e))
    out["raised"] = raised

    # the VJP: grad of |sum(w * fft2(x))|^2 over the global array
    w = torch.as_tensor(f["w"])
    x = torch.tensor(f["x"], requires_grad=True)
    y = fft2(pfft.shard_rows(mesh, x))
    s = sh.all_sum(torch.sum(pfft.shard_rows(mesh, w) * y), mesh)
    (torch.abs(s) ** 2).backward()
    sh.reduce_grads([x], mesh)
    out["vjp"] = to_numpy(x.grad)
    x_ref = torch.tensor(f["x"], requires_grad=True)
    (torch.abs(torch.sum(w * torch.fft.fft2(x_ref.to(torch.complex128))))
     ** 2).backward()
    out["vjp_torch"] = to_numpy(x_ref.grad)

    opd, amp = torch.as_tensor(f["opd"]), torch.as_tensor(f["amp"])
    args = (13.5e-9, 1e-4, 0.1)
    out["psf"] = [to_numpy(a) for a in pfft.psf_fft_sharded(
        opd, amp, *args, mesh=mesh, pad_factor=2)]
    opd16 = torch.tensor(f["opd16"], requires_grad=True)
    img, _, _ = pfft.psf_fft_sharded(opd16, torch.as_tensor(f["amp16"]),
                                     *args, mesh=mesh, pad_factor=2)
    img[10, 10].backward()
    sh.reduce_grads([opd16], mesh)
    out["psf_grad"] = to_numpy(opd16.grad)
    return out


def _train_params(inp):
    return convert.train_params_from_numpy(inp["train"]["params"], "cpu")


def task_train(mesh, inp):
    step, loss, _ = sh.make_train_step(
        WOLTER_3_1_DEFAULT, loss_fn_for(mesh),
        functools.partial(torch.optim.Adam, lr=LR), TRAIN_FAN, TRAIN_FAN,
        mesh)
    params = _train_params(inp)
    with torch.no_grad():
        l0 = float(loss(params))
    opt, params, l1 = step(None, params)
    grads = [to_numpy(t.grad) for t in sh.param_list(params)]
    _, params, l2 = step(opt, params)
    out = {"losses": (l0, float(l1), float(l2)), "grads": grads}

    # the same gradient unsharded
    _, loss1, _ = sh.make_train_step(
        WOLTER_3_1_DEFAULT, loss_fn_for(None), None, TRAIN_FAN, TRAIN_FAN,
        None)
    p1 = _train_params(inp)
    loss1(p1).backward()
    out["grads_unsharded"] = [to_numpy(t.grad) for t in sh.param_list(p1)]

    # one step from akbx's Adam state
    p2 = _train_params(inp)
    a = inp["train"]["adam"]
    opt = convert.adam_state_from_optax(
        torch.optim.Adam(sh.param_list(p2), lr=LR), a["mu"], a["nu"],
        a["count"])
    step(opt, p2)
    out["after_akbx_state"] = [to_numpy(t) for t in sh.param_list(p2)]
    out["grads_akbx_state"] = [to_numpy(t.grad) for t in sh.param_list(p2)]
    out["dryrun"] = dryrun.dryrun(mesh)
    return out


TASKS = (("shard", task_shard), ("trace", task_trace),
         ("huygens", task_huygens),
         ("streamed", task_streamed), ("fft", task_fft),
         ("train", task_train))


def run(rank: int, world: int, store: str, inputs: dict, queue) -> None:
    """One rank: every task on a gloo world of ``world`` ranks."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        mesh = sh.ray_mesh(device_type="cpu")
        out = {name: task(mesh, inputs) for name, task in TASKS}
        queue.put((rank, out if rank == 0 else
                   {"trace_widths": {k: v["width"]
                                     for k, v in out["trace"].items()},
                    "huygens_widths": {k: v[2] for k, v in
                                       out["huygens"].items()
                                       if not k.endswith("_spans")},
                    "train_grads": out["train"]["grads"],
                    "shard_widths": {k: v[0]
                                     for k, v in out["shard"].items()},
                    "fft_local_shape": out["fft"]["fft2_local_shape"]}))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()
