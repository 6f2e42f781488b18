#!/usr/bin/env python3
"""akbx_torch.parallel on several cards: every sharded path at full width,
each held against the unsharded function on the same inputs.

Run from the repository root, one process per card:

    torchrun --standalone --nproc-per-node 4 chip_parallel.py

or on the CPU over gloo at small sizes (a rehearsal):

    torchrun --standalone --nproc-per-node 4 chip_parallel.py --device cpu --small

Every rank runs the same calls; rank 0 prints the cards' nvidia-smi
lines (name, power limit, SM clock), one line a path, with the largest
error over the ranks and the host-clock time between barriers
(synchronised; each path warmed up first, at a small size where a full
one costs seconds; the trace and the PSF the median of 3), then one JSON
line of the numbers.  ``tests/test_torch_cuda_paths.py`` runs the same
paths on one rank; here the collectives, the ring's transfers and the
distributed transposes move data between cards.

  a. sharded_trace at 2048x2048 with the re-fan and tilt: f64 against
     the unsharded f64 run on every rank (detcenter and demeaned OPL
     1e-12 m), and the K1 route against it (5e-9 m, 1e-9 m);
  b. huygens_sharded and huygens_ring, 66,049 -> 66,049 points at 13.5
     nm, against the f64 path on each rank's own targets (rtol 1e-10;
     the ring, K4 once a step, 1e-6 of the field);
  c. psf_fft_sharded at 4096x4096 against compute_psf_fft: values rtol
     1e-8, the gradient of a real loss 1e-7 of its scale;
  d. trace_streamed at 2048x2048 in 512-row blocks against the
     unstreamed run (centroid, min/max 1e-8, std 1e-6), then 8192x8192;
  e. make_train_step at 2048x2048 with 3x3 figures on four mirrors: the
     reduced gradient against the unsharded one (1e-8 of each group's
     largest: the two sum orders, ROADMAP F11), two Adam steps;
  f. the dry run's step (akbx_torch.parallel.dryrun.dryrun).
Any failure raises on the rank that sees it.
"""

import argparse
import datetime
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from torch_parallel_worker import cloud, loss_fn_for  # noqa: E402

EUV = 13.5e-9
TRAIN_LR = 1e-10        # akbx's train-step test (tests/test_sharding.py)
# the PSF's pupil side is a multiple of the ranks (psf_fft_sharded pads
# others up to one, which refines the image's sampling): 256 x pad 16
SIZES = {"full": dict(n=2048, w=257, big=8192, block=512, pupil=256),
         "small": dict(n=64, w=33, big=256, block=16, pupil=32)}


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_parallel: {what}")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="chip_parallel.py")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--small", action="store_true")
    args = parser.parse_args(argv)
    size = SIZES["small" if args.small else "full"]
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("chip_parallel: torch.cuda.is_available() is false")
    device_id = None
    if on_card:
        device_id = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device_id)
    dist.init_process_group("nccl" if on_card else "gloo",
                            timeout=datetime.timedelta(seconds=300),
                            device_id=device_id)
    try:
        run(size, on_card)
    finally:
        dist.destroy_process_group()


def run(size, on_card):
    from akbx_torch import trace, wave
    from akbx_torch.analysis import psf
    from akbx_torch.kernels import huygens_f64 as k4
    from akbx_torch.kernels import trace_kernel as tk
    from akbx_torch.parallel import batching, dryrun, fft as pfft
    from akbx_torch.parallel import sharding as sh
    from akbx_torch.systems import (AlignParams, WOLTER_3_1_DEFAULT,
                                    build_wolter_3_1)

    mesh = sh.ray_mesh(device_type="cuda" if on_card else "cpu")
    dev = sh.mesh_device(mesh)
    p, rank = mesh.size(), mesh.get_local_rank()
    n, big, block = size["n"], size["big"], size["block"]
    card = "CPU"
    if on_card:
        card = "; ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm", "--format=csv,noheader"], capture_output=True,
            text=True, check=True, timeout=60).stdout.strip().splitlines())
    results = {"ranks": p, "device": card}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn, reps=1):
        """(median ms of ``reps`` calls, the last call's result)."""
        times = []
        for _ in range(reps):
            sync()
            dist.barrier()
            t0 = time.perf_counter()
            out = fn()
            sync()
            dist.barrier()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times)), out

    def worst(x):
        t = torch.tensor(float(x), dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t)

    def say(line):
        if rank == 0:
            print(line, flush=True)

    say(f"[cards] {card}")

    k1_before = tk.trace_deviation.launches
    vec = torch.tensor(np.random.default_rng(1).normal(
        0.0, 1e-5, 26), dtype=torch.float64, device=dev)
    system = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.from_vector(vec))

    # a. the sharded trace
    gold = trace.run(system, n, n, vec[0], precision="f64")
    gold_ms, _ = timed(lambda: trace.run(system, n, n, vec[0],
                                         precision="f64"), reps=3)
    ms = {}
    for prec in ("f64", "pallas"):
        sharded = sh.sharded_trace(system, n, n, vec[0], mesh, precision=prec)
        ms[prec], sharded = timed(lambda: sh.sharded_trace(
            system, n, n, vec[0], mesh, precision=prec), reps=3)
        det = sh.gather_rays(sharded.detcenter, mesh)
        opl = sh.gather_rays(sharded.total_dist - trace.masked_mean(
            sharded.total_dist, sharded.valid, mesh=mesh), mesh)
        valid = sh.gather_rays(sharded.valid, mesh)
        check(torch.equal(valid, gold.valid), f"{prec} valid")
        results[f"trace_{prec}"] = {
            "detcenter": worst((det - gold.detcenter).abs().max()),
            "opl": worst((opl - (gold.total_dist - trace.masked_mean(
                gold.total_dist, gold.valid))).abs().max()),
            "ms": ms[prec], "width": sharded.detcenter.shape[1]}
    k1 = tk.trace_deviation.launches - k1_before if on_card else None
    say(f"[a] sharded_trace {n}x{n}, re-fan + tilt, {p} ranks: f64 vs "
        f"unsharded detcenter {results['trace_f64']['detcenter']:.3e} m, "
        f"OPL {results['trace_f64']['opl']:.3e} m (bars 1e-12), "
        f"{ms['f64']:.3f} ms against {gold_ms:.3f} unsharded; the K1 route "
        f"{results['trace_pallas']['detcenter']:.3e} m, "
        f"{results['trace_pallas']['opl']:.3e} m (bars 5e-9, 1e-9), "
        f"{ms['pallas']:.3f} ms; K1 launches on rank 0: {k1} ({card})")
    check(results["trace_f64"]["detcenter"] <= 1e-12
             and results["trace_f64"]["opl"] <= 1e-12, "sharded f64 trace")
    check(results["trace_pallas"]["detcenter"] <= 5e-9
             and results["trace_pallas"]["opl"] <= 1e-9, "sharded K1 route")
    del gold, sharded, det, opl

    # b. Huygens, each rank against the f64 path on its own targets
    src, tgt = cloud(dev, 1024, 1024, 15)
    sh.huygens_sharded(src, tgt, EUV, mesh)
    sh.huygens_ring(src.points, src.re * src.ds, src.im * src.ds, tgt, EUV,
                    mesh)
    w = size["w"] ** 2
    src, tgt = cloud(dev, w, w, 15)
    sh_ms, got = timed(lambda: sh.huygens_sharded(src, tgt, EUV, mesh))
    lo, hi = sh.shard_bounds(w, mesh, multiple=128)
    ref = wave.propagate(src, tgt[:, lo:hi], EUV, use_pallas=False)
    e_sh = worst(max(float(((g - r).abs() - 1e-10 * r.abs()).max())
                     if r.numel() else -1.0 for g, r in zip(got, ref)))
    k4_before = k4.huygens_f64.launches
    ring_ms, ring = timed(lambda: sh.huygens_ring(
        src.points, src.re * src.ds, src.im * src.ds, tgt, EUV, mesh))
    k4_launches = k4.huygens_f64.launches - k4_before
    lo, hi = sh.shard_bounds(w, mesh, multiple=8)
    ref = wave.propagate(src, tgt[:, lo:hi], EUV, use_pallas=False)
    scale = worst(torch.complex(*ref).abs().max() if hi > lo else 0.0)
    e_ring = worst(torch.complex(*ring).sub(torch.complex(*ref)).abs().max()
                   if hi > lo else 0.0) / scale
    results["huygens"] = {"sharded_ms": sh_ms, "ring_ms": ring_ms,
                          "sharded_err": e_sh, "ring_rel": e_ring,
                          "k4_launches": k4_launches}
    say(f"[b] {w} -> {w} points, {p} ranks: huygens_sharded max(|err| - "
        f"1e-10 |f|) {e_sh:.3e} (bar 1e-12), {sh_ms:.3f} ms; huygens_ring "
        f"{e_ring:.3e} of the field (bar 1e-6), {ring_ms:.3f} ms, K4 "
        f"launches on rank 0: {k4_launches} ({card})")
    check(e_sh <= 1e-12 and e_ring <= 1e-6, "sharded Huygens")
    # one K4 launch a ring step on the card, none on the CPU
    check(k4_launches == (p if on_card else 0), "the ring's K4 launches")
    del src, tgt, got, ring, ref

    # c. the sharded PSF
    rng = np.random.default_rng(16)
    y = np.linspace(-1.0, 1.0, size["pupil"])
    r2 = np.add.outer(y**2, y**2)
    opd_np = 5e-9 * r2 + 1e-9 * rng.normal(size=r2.shape)
    amp = torch.tensor(np.where(r2 <= 1.0, 1.0, np.nan), device=dev)
    weight = torch.tensor(rng.uniform(size=(16 * size["pupil"],) * 2),
                          device=dev)
    args = (EUV, 1e-6, 0.3)
    small = torch.ones((8 * p, 8 * p), dtype=torch.float64, device=dev)
    pfft.psf_fft_sharded(small.requires_grad_(), small, *args, mesh=mesh)[
        0].sum().backward()
    out = {}
    for label, fn in (("sharded", lambda o: pfft.psf_fft_sharded(
            o, amp, *args, mesh=mesh, pad_factor=16)),
                      ("unsharded", lambda o: psf.compute_psf_fft(
            o, amp, *args, pad_factor=16))):
        opd = torch.tensor(opd_np, device=dev, requires_grad=True)
        first_ms, _ = timed(lambda: fn(opd))
        fwd_ms, (img, _, _) = timed(lambda: fn(opd), reps=3)
        torch.sum(weight * img).backward()
        if label == "sharded":
            sh.reduce_grads([opd], mesh)
        out[label] = (img.detach(), opd.grad, fwd_ms, first_ms)
    (i_s, g_s, ms_s, first_s), (i_u, g_u, ms_u, _) = (out["sharded"],
                                                      out["unsharded"])
    e_i = worst(((i_s - i_u).abs() - 1e-8 * i_u.abs()).max())
    e_g = worst((g_s - g_u).abs().max() / g_u.abs().max())
    results["psf"] = {"err": e_i, "grad_rel": e_g, "ms": ms_s,
                      "first_ms": first_s, "unsharded_ms": ms_u}
    say(f"[c] psf_fft_sharded {tuple(i_s.shape)} (pupil {size['pupil']}^2 "
        f"x pad 16), {p} ranks: max(|err| - "
        f"1e-8 |I|) {e_i:.3e} (bar 1e-10), gradient {e_g:.3e} of its scale "
        f"(bar 1e-7); forward {ms_s:.3f} ms sharded (median of 3; the first "
        f"full-size call {first_s:.3f}), {ms_u:.3f} unsharded "
        f"({card})")
    check(e_i <= 1e-10 and e_g <= 1e-7, "sharded PSF")
    del out, i_s, i_u, g_s, g_u

    # d. streamed fans
    st = batching.trace_streamed(system, n, n, vec[0], block_rows=block,
                                 mesh=mesh)
    res = trace.run(system, n, n, vec[0], precision="f64",
                    exit_pupil_uniform=False, tilt_correction=False)
    yz = res.detcenter[1:3, res.valid]

    def rel(a, b):
        return float(((a - b).abs() / b.abs()).max())

    e_st = {"centroid": rel(st.centroid, yz.mean(dim=1)),
            "std": rel(st.spot_std, yz.std(dim=1, correction=0)),
            "min": rel(st.min_yz, yz.amin(dim=1)),
            "max": rel(st.max_yz, yz.amax(dim=1))}
    check(int(st.n) == int(res.valid.sum()), "streamed count")
    del res, yz
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    big_ms, stats = timed(lambda: batching.trace_streamed(
        system, big, big, vec[0], block_rows=block, mesh=mesh))
    peak = (worst(torch.cuda.max_memory_allocated(dev) / 1e9)
            if on_card else None)
    results["streamed"] = {**e_st, "ms": big_ms, "rays": big * big,
                           "peak_gb": peak}
    say(f"[d] trace_streamed {n}x{n}, {p} ranks: rel err {e_st} (bars "
        f"1e-8, std 1e-6); {big}x{big} in {big_ms:.3f} ms "
        f"({big * big / (big_ms / 1e3):.4e} rays/s), peak {peak} GB a rank; "
        f"valid {float(stats.n):.0f} ({card})")
    check(max(e_st["centroid"], e_st["min"], e_st["max"]) <= 1e-8
             and e_st["std"] <= 1e-6, "streamed stats")

    # e. the train step
    from akbx_torch import convert

    fig = np.random.default_rng(17).normal(0.0, 1e-9, (4, 3, 3))
    start = {"align": np.zeros(26), "figures": list(fig)}
    adam = functools.partial(torch.optim.Adam, lr=TRAIN_LR)
    step, _, _ = sh.make_train_step(WOLTER_3_1_DEFAULT,
                                    loss_fn_for(mesh), adam, n, n, mesh)
    params = convert.train_params_from_numpy(start, dev)
    step1_ms, (opt, params, l1) = timed(lambda: step(None, params))
    grads = [t.grad.clone() for t in sh.param_list(params)]
    step2_ms, (_, params, l2) = timed(lambda: step(opt, params))
    _, loss_u, _ = sh.make_train_step(WOLTER_3_1_DEFAULT,
                                      loss_fn_for(None), adam, n, n,
                                      None)
    p_u = convert.train_params_from_numpy(start, dev)
    loss_u(p_u).backward()
    g_rel = worst(max(float((g - u.grad).abs().max() / u.grad.abs().max())
                      for g, u in zip(grads, sh.param_list(p_u))))
    results["train"] = {"loss": [float(l1), float(l2)], "grad_rel": g_rel,
                        "step_ms": [step1_ms, step2_ms]}
    say(f"[e] make_train_step {n}x{n}, {p} ranks: loss {float(l1):.9e} -> "
        f"{float(l2):.9e}; reduced gradient vs unsharded {g_rel:.3e} of its "
        f"scale (bar 1e-8, F11); steps {step1_ms:.3f} / {step2_ms:.3f} ms "
        f"({card})")
    check(g_rel <= 1e-8, "sharded gradient")
    check(float(l2) <= float(l1) * 1.001, "train loss rose")

    # f. the dry run's step
    loss = dryrun.dryrun(mesh)
    results["dryrun_loss"] = loss
    say(f"[f] dryrun over {p} ranks: loss {loss:.9e}")
    say(json.dumps(results))


if __name__ == "__main__":
    main()
