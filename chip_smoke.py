#!/usr/bin/env python3
"""Smoke test of akbx_torch on one CUDA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one printed line or more each:
  1. the card (nvidia-smi name and power limit); TF32 matmul must be off;
  2. build the CUDA kernels from akbx_torch/csrc (first use);
  3. each kernel against its plain PyTorch twin on the card, at the main
     path's shapes: the deviations of a 2048x2048 fan (4,194,304 rays),
     and a seeded random set of the same scale at a ragged 1,000,003;
  4. the forward main path: build_wolter_3_1 -> trace.run(precision=
     "pallas") at a 2048x2048 fan from a seeded misalignment, with the
     bench loss; it must launch K1 once and K2 once;
  5. the same fan through the port's f64 golden, against akbx's bars;
     and a 9x9 fan on the card against the same on the CPU (the twins);
  6. times from CUDA events (median of 10 after warm-up): the forward
     step; its split by stage, from events at the stage boundaries of the
     same step; and each kernel alone beside its twin, on the inputs the
     main path gave it.
Then a JSON line of the kernels, and as the last line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is not
0 and the last line is not printed.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_SIDE = 2048           # the bench's fan: 4,194,304 rays
N_RAGGED = 1_000_003
SEED = 0
KERNEL_REL = 1e-11      # kernel vs twin, per output, of the output's scale
REPS = 10


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def time_ms(fn, reps=REPS, warmup=2, setup=None):
    """Median milliseconds of ``fn`` between CUDA events; with ``setup``,
    ``fn(setup())`` where the setup runs outside the timed window."""
    def once():
        arg = setup() if setup else None
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg) if setup else fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    for _ in range(warmup):
        once()
    return statistics.median(once() for _ in range(reps))


def f64_of(hi, lo):
    return hi.double() + lo.double()


class StageMarks:
    """Stands in for ``akbx_torch.trace``'s handle on the kernel module
    and records a CUDA event before and after each kernel wrapper, so one
    run of the real main path is cut at its stage boundaries.  Keeps the
    arguments each wrapper was last called with."""

    STAGES = {"before trace_deviation": "fan + chief + constants",
              "trace_deviation": "K1", "before detector": "tilt stats",
              "detector": "K2"}

    def __init__(self, module):
        self._module = module
        self.events = []
        self.args = {}

    def mark(self, stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((stage, ev))

    def spans(self):
        """Milliseconds of each stage, keyed by the stage that ends at
        each event (after a synchronize)."""
        return {stage: a.elapsed_time(b) for (_, a), (stage, b)
                in zip(self.events, self.events[1:])}

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if name not in ("trace_deviation", "detector"):
            return fn

        def timed(*args):
            self.mark(self.STAGES[f"before {name}"])
            self.args[name] = args
            out = fn(*args)
            self.mark(self.STAGES[name])
            return out

        return timed


def compare_outputs(kernel_out, twin_out, valid_index=None):
    """Largest |kernel - twin| (hi + lo pairs in f64) and its ratio to the
    output's largest magnitude, over every (hi, lo) output; the valid
    plane, if any, must be identical."""
    worst_ratio, worst_abs = 0.0, 0.0
    pairs = [k for k in range(0, len(kernel_out) - 1, 2)
             if k != valid_index]
    for k in pairs:
        a = f64_of(kernel_out[k], kernel_out[k + 1])
        b = f64_of(twin_out[k], twin_out[k + 1])
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        check(np.isfinite(err), f"non-finite kernel output {k}")
        worst_abs = max(worst_abs, err)
        worst_ratio = max(worst_ratio, err / scale if scale else err)
    if valid_index is not None:
        check(torch.equal(kernel_out[valid_index], twin_out[valid_index]),
              "kernel and twin valid masks differ")
    return worst_ratio, worst_abs


def main():
    # --- 1. the card -----------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from akbx_torch import trace
    from akbx_torch.kernels import _build
    from akbx_torch.kernels import trace_kernel as tk
    from akbx_torch.systems import (AlignParams, WOLTER_3_1_DEFAULT,
                                    build_wolter_3_1)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"[1] card {name!r}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "torch.backends.cuda.matmul.allow_tf32 is on")

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log = (_build.BUILD_ROOT / _build.source_hash() / "build.log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    print(f"[2] kernels built and loaded in {build_s:.2f} s; "
          + " | ".join(ptxas), flush=True)

    # --- 3. kernels vs twins on the card ---------------------------------
    system0 = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.zeros(dev))
    rays = trace.ray_fan(trace.fan_angles(system0.fan_h, N_SIDE),
                         trace.fan_angles(system0.fan_v, N_SIDE))
    n_rays = rays.shape[1]
    src = system0.source[:, None].expand(3, n_rays)
    chief_d0, chief_p0, consts64 = trace._fast_scalars(system0, rays, src,
                                                       n_rays // 2)
    (Ms, bvecs, Ds, Dns, Ts, A_noms, Bp_noms, rhos, gCs, gAs, branches,
     Ps) = consts64
    consts = tk.pack_consts(Ms, gCs, gAs, Ds, Dns, Ts, A_noms, Bp_noms,
                            rhos, branches, bvecs)
    fan_dp = (src - chief_p0).contiguous()
    fan_dd = (rays - chief_d0).contiguous()
    rng = np.random.default_rng(SEED)
    scale = fan_dd.abs().amax(dim=1, keepdim=True)
    rnd_dd = torch.tensor(rng.uniform(-1.0, 1.0, (3, N_RAGGED)),
                          dtype=torch.float64, device=dev) * scale
    rnd_dp = torch.tensor(rng.normal(0.0, 1e-6, (3, N_RAGGED)),
                          dtype=torch.float64, device=dev)
    det_x = system0.s2f_middle
    k_err = {"K1": [0.0, 0.0], "K2": [0.0, 0.0]}
    for label, dp, dd in (("fan", fan_dp, fan_dd),
                          ("random", rnd_dp, rnd_dd)):
        n = dp.shape[1]
        k1 = tk.trace_deviation(consts, dp, dd, 4)
        torch.cuda.synchronize()
        t1 = tk.trace_deviation_reference(consts, dp, dd, 4)
        r1, a1 = compare_outputs(k1, t1, valid_index=8)
        # K2 with the path's own detector constants for these rays
        valid = t1[8][0] > 0.5
        q4 = (t1[0][9:12], t1[1][9:12])
        d4 = (t1[2][9:12], t1[3][9:12])
        th_y, th_z = trace._tilt_stats(Dns[-1], d4[0], valid, True, "mean")
        focus = trace._pre_tilt_focus(Ps[-1], Dns[-1], det_x, q4[0], d4[0],
                                      valid)
        (R, P4r, D4r, t_c, _, L, t_c2, _, L2, _, _) = \
            trace._fast_post_scalars(consts64, det_x, det_x + 1e-3, th_y,
                                     th_z, focus, True)
        dcon = torch.cat([tk.pack_det_consts(R, D4r, t_c, L),
                          tk.pack_det_consts(R, D4r, t_c2, L2)])
        ins = (*q4, *d4, t1[6], t1[7])
        k2 = tk.detector(dcon, *ins)
        torch.cuda.synchronize()
        t2 = tk.detector_reference(dcon, *ins)
        r2, a2 = compare_outputs(k2, t2)
        for key, r, a in (("K1", r1, a1), ("K2", r2, a2)):
            k_err[key] = [max(k_err[key][0], r), max(k_err[key][1], a)]
        print(f"[3] {label} N={n}: K1 vs twin max |err|/scale {r1:.3e} "
              f"(max |err| {a1:.3e}), valid identical; K2 vs twin "
              f"{r2:.3e} (max |err| {a2:.3e})", flush=True)
        check(r1 <= KERNEL_REL and r2 <= KERNEL_REL,
              f"kernel disagrees with its twin beyond {KERNEL_REL}")
        del k1, t1, k2, t2

    # --- 4. the forward main path ----------------------------------------
    vec = torch.tensor(np.random.default_rng(SEED + 1).normal(0.0, 1e-5, 26),
                       dtype=torch.float64, device=dev)

    def run_and_loss(system):
        res = trace.run(system, N_SIDE, N_SIDE, defocus=vec[0],
                        exit_pupil_uniform=False, tilt_correction=True,
                        precision="pallas")
        # bench_common.make_step's pallas loss
        sy, sz = trace.spot_size(res.ddet32, res.valid)
        loss = (torch.sum(torch.where(res.valid, res.w32, 0.0) ** 2) * 1e18
                + sy + sz)
        return res, loss, (sy, sz)

    def forward():
        system = build_wolter_3_1(WOLTER_3_1_DEFAULT,
                                  AlignParams.from_vector(vec))
        return (system, *run_and_loss(system))

    tk.trace_deviation.launches = 0
    tk.detector.launches = 0
    system, res, loss, (sy, sz) = forward()
    torch.cuda.synchronize()
    launches = {"K1": tk.trace_deviation.launches,
                "K2": tk.detector.launches}
    check(launches == {"K1": 1, "K2": 1},
          f"main path launched {launches}, want K1 once and K2 once")
    n_valid = int(res.valid.sum())
    check(n_valid == n_rays, f"{n_rays - n_valid} invalid rays")
    for f in ("detcenter", "detcenter2", "total_dist", "total_dist2",
              "wave2", "w32", "w32_2", "ddet32"):
        x = getattr(res, f)
        check(bool(torch.isfinite(x).all()), f"non-finite {f}")
        check(x.shape[-1] == n_rays, f"{f} has shape {tuple(x.shape)}")
    sy64, sz64 = trace.spot_size(res.detcenter, res.valid)
    print(f"[4] main path {N_SIDE}x{N_SIDE} ({n_rays} rays): launches "
          f"{launches}; loss {float(loss):.9e}; spot (ddet32) sy "
          f"{float(sy):.6e} m sz {float(sz):.6e} m; spot (detcenter f64) "
          f"sy {float(sy64):.6e} sz {float(sz64):.6e}; valid fraction "
          f"{n_valid / n_rays}", flush=True)

    # --- 5. against the port's f64 golden ---------------------------------
    gold = trace.run(system, N_SIDE, N_SIDE, defocus=vec[0],
                     exit_pupil_uniform=False, tilt_correction=True,
                     precision="f64")
    check(torch.equal(gold.valid, res.valid), "valid differs from golden")
    e_det = float((res.detcenter - gold.detcenter).abs().max())
    w_gold = gold.total_dist - trace.masked_mean(gold.total_dist, gold.valid)
    w_fast = res.total_dist - trace.masked_mean(res.total_dist, res.valid)
    e_opl = float((w_fast - w_gold).abs().max())
    e_w32 = float((res.w32.double() - w_gold).abs().max())
    e_pts = [float((res.trace.points[i] - gold.trace.points[i]).abs().max())
             for i in range(4)]
    print(f"[5] vs f64 golden: detcenter {e_det:.3e} m (bar 5e-9), demeaned "
          f"OPL {e_opl:.3e} m (bar 1e-9), w32 {e_w32:.3e} m (bar 2e-9), "
          f"points m1-m4 {[f'{e:.3e}' for e in e_pts]} m (bar 5e-9 on "
          f"m1-m3)", flush=True)
    check(e_det <= 5e-9 and e_opl <= 1e-9 and e_w32 <= 2e-9
          and max(e_pts[:3]) <= 5e-9, "fast path vs f64 golden beyond bars")
    del gold, w_gold, w_fast

    small = []
    for d in (dev, torch.device("cpu")):
        s = build_wolter_3_1(WOLTER_3_1_DEFAULT,
                             AlignParams.from_vector(vec.to(d)))
        small.append(trace.run(s, 9, 9, defocus=vec[0].to(d),
                               exit_pupil_uniform=False, precision="pallas"))
    e_small = float((small[0].detcenter.cpu() - small[1].detcenter).abs().max())
    e_small_w = float((small[0].w32.cpu() - small[1].w32).abs().max())
    e_small_t = abs(float(small[0].theta_y) - float(small[1].theta_y))
    # same kernels/twins bit for bit; the float32 tilt-angle mean sums in
    # another order on the card (~1e-9 rad over a ~0.2 m lever arm)
    print(f"[5] 9x9 on the card vs on the CPU: detcenter {e_small:.3e} m, "
          f"w32 {e_small_w:.3e} m (bar 1e-9), theta_y {e_small_t:.3e} rad",
          flush=True)
    check(e_small <= 1e-9 and e_small_w <= 1e-9, "card vs CPU at 9x9")

    # --- 6. times ---------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: forward()[2])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[6] forward step (build + run + loss) {step_ms:.3f} ms, "
          f"{n_rays / (step_ms / 1e3):.6e} rays/s, peak memory "
          f"{peak_gb:.3f} GB", flush=True)

    # the split: the same step, cut by CUDA events at its stage boundaries
    marks = StageMarks(tk)
    trace.tk = marks
    try:
        runs = []
        for rep in range(REPS + 2):
            marks.events.clear()
            torch.cuda.synchronize()
            marks.mark(None)
            system_t = build_wolter_3_1(WOLTER_3_1_DEFAULT,
                                        AlignParams.from_vector(vec))
            marks.mark("system build")
            _, loss_t, _ = run_and_loss(system_t)
            marks.mark("f64 fields + loss")
            torch.cuda.synchronize()
            if rep >= 2:
                runs.append(marks.spans())
    finally:
        trace.tk = tk
    check(float(loss_t) == float(loss), "the staged step's loss differs")
    split = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    split_total = statistics.median(sum(r.values()) for r in runs)
    rays_m = trace.ray_fan(trace.fan_angles(system.fan_h, N_SIDE),
                           trace.fan_angles(system.fan_v, N_SIDE))
    src_m = system.source[:, None].expand(3, n_rays)
    det_x = system.s2f_middle + vec[0]
    materialize_ms = time_ms(
        lambda lazy: lazy.materialize(), reps=5,
        setup=lambda: trace.run_fast(system, rays_m, src_m, det_x,
                                     det_x + 1e-3)["trace"])
    print(f"[6] split (ms, median of {REPS}; staged step {split_total:.3f}): "
          + "; ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; materialize f64 TraceResult (on access only, not in the "
          f"step) {materialize_ms:.3f}", flush=True)

    # each kernel alone and its twin, on the inputs the main path gave it
    k1_in, k2_in = marks.args["trace_deviation"], marks.args["detector"]
    k1_ms = time_ms(lambda: tk.trace_deviation(*k1_in))
    k1_plain = time_ms(lambda: tk.trace_deviation_reference(*k1_in),
                       warmup=1)
    k2_ms = time_ms(lambda: tk.detector(*k2_in))
    k2_plain = time_ms(lambda: tk.detector_reference(*k2_in), warmup=1)
    print(f"[6] K1 kernel {k1_ms:.3f} ms vs twin {k1_plain:.3f} ms; K2 "
          f"kernel {k2_ms:.3f} ms vs twin {k2_plain:.3f} ms "
          f"(N={n_rays})", flush=True)

    kernels = [
        {"name": "K1 trace_deviation (bounce chain)", "route": "cuda",
         "source": "akbx_torch/csrc/trace_kernel.cu",
         "replaces": "akbx/kernels/trace_kernel.py:227",
         "launches": launches["K1"], "max_abs_err": k_err["K1"][1],
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "K2 detector (tilt + detector planes + OPL)",
         "route": "cuda", "source": "akbx_torch/csrc/trace_kernel.cu",
         "replaces": "akbx/kernels/trace_kernel.py:469",
         "launches": launches["K2"], "max_abs_err": k_err["K2"][1],
         "ms": k2_ms, "plain_ms": k2_plain},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
