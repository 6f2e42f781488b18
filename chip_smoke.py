#!/usr/bin/env python3
"""The port's four CUDA kernels on one card, each on the arguments its main
path passes it: held against its plain PyTorch twin, timed, and set beside
its bound.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Each main path runs once at its benchmark cell's shapes, and the launches
of each kernel are read from that run:

* align: KB7, Wolter III+I and the III+III tandem, each from a seeded
  misalignment: the build, ``trace.run(precision="pallas")`` on a
  2048x2048 fan (4,194,304 rays), the align cells' loss and its backward;
* wave: the wave-257 cell's chain on a handoff made as the cell makes
  them (``portbench.kinds.wave.handoff``): a point source through M1-M4
  to the focal grid, then the defocused grid from M4, 66,049 points a
  surface;
* ring: the same chain with every stage on ``huygens_ring`` over a
  one-rank NCCL group.

Then each kernel on the arguments its path gave it, against its twin: K1
and K2 every output word, on each align system; K3 on the chain's M4 ->
Image stage, to 1e-6 of the field; K4 on the ring's tile at four ranks
(16,520 of that stage's targets and sources), to 1e-9 of the field.  Its
time there (CUDA events; the kernel's median of 10 after a warm-up, the
twin's median of 3, K3's twin one run) and its bound: the larger of its
bytes over the card's bandwidth and its operations over its peak
(``portbench/roofline.py``; for K4, 57 f64 operations a pair, which
tests/test_torch_op_counts.py counts, over 1.675e13 a second).  The last
line is ``{"kernels": [...]}``, the numbers of PERF.md's kernel table.  Any
disagreement raises.

This script prints numbers.  The suite that holds the port on the card is
``pytest -m cuda`` (README).
"""

import json
import os
import sys
import tempfile

import numpy as np
import torch

from chip_kernel_tune import card, kept, time_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1
SIGMA = 1e-5            # the cells' misalignment
SIDE = 2048             # the align cells' fan
HUYGENS_REL = 1e-6      # K3 vs its twin, of the field (the sum's order)
K4_REL = 1e-9           # K4 vs its twin, of the field (the sum's order)
RING_TILE = 16_520      # one rank's targets and source block at 257^2 on 4
K4_OPS_PER_PAIR = 57    # f64 operations, counted on K4's twin
F64_OPS = 1.675e13      # H100 SXM f64 instructions a second
NAMES = ("M1", "M2", "M3", "M4", "Image", "Defocus")
FROM = (-1, 0, 1, 2, 3, 3)   # the stage each stage propagates from


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def field_rel(got, want):
    """max |got - want| over max |want| of two (re, im) pairs."""
    g, w = torch.complex(*got), torch.complex(*want)
    return float((g - w).abs().max() / w.abs().max())


def timing(kernel, twin, twin_reps=3):
    """ms of ``kernel`` and its twin, each a call without arguments."""
    return {"ms": time_ms(kernel, 10, 2),
            "plain_ms": time_ms(twin, twin_reps, 1 if twin_reps > 1 else 0)}


def align_path(dev):
    """Each align system's step: its K1 and K2 launches and arguments, the
    kernels against their twins bit for bit, their times and bounds."""
    from akbx_torch import trace
    from akbx_torch.kernels import trace_kernel as tk
    from akbx_torch.systems import (
        AlignParams, KBSpec, WOLTER_3_1_DEFAULT, WOLTER_3_3_TANDEM_DEFAULT,
        build_kb, build_wolter_3_1, build_wolter_3_3_tandem)
    from portbench import roofline as rf
    from portbench.kinds.align import bench_loss

    kb7 = KBSpec.from_kb_define(146.0, 0.21, 0.16742, 0.180, 0.030, 0.15525,
                                0.05, device=dev)
    builds = {"kb7": lambda p: build_kb(kb7, p),
              "wolter31": lambda p: build_wolter_3_1(WOLTER_3_1_DEFAULT, p),
              "tandem": lambda p: build_wolter_3_3_tandem(
                  WOLTER_3_3_TANDEM_DEFAULT, p)}
    out = {}
    for name, build in builds.items():
        v = torch.tensor(np.random.default_rng(SEED).normal(0.0, SIGMA, 26),
                         device=dev, requires_grad=True)
        calls = {"K1": [], "K2": []}
        before = (tk.trace_deviation.launches, tk.detector.launches)
        with kept(tk, "trace_deviation", calls["K1"]), \
                kept(tk, "detector", calls["K2"]):
            res = trace.run(build(AlignParams.from_vector(v)), SIDE, SIDE,
                            defocus=v[0], exit_pupil_uniform=False,
                            tilt_correction=True, precision="pallas")
            bench_loss(res).backward()
        torch.cuda.synchronize()
        launches = (tk.trace_deviation.launches - before[0],
                    tk.detector.launches - before[1])
        check(launches == (1, 1), f"{name}: K1, K2 launched {launches}")
        k1, k2 = calls["K1"][0], calls["K2"][0]
        n, mirrors = k1[1].shape[1], k1[3]
        with torch.no_grad():
            same = [all(torch.equal(a, b) for a, b in
                        zip(kernel(*args), twin(*args)))
                    for kernel, twin, args in (
                        (tk.trace_deviation, tk.trace_deviation_reference, k1),
                        (tk.detector, tk.detector_reference, k2))]
            check(all(same), f"{name}: K1, K2 bit for bit {same}")
            out[name] = {
                "K1": {**timing(lambda: tk.trace_deviation(*k1),
                                lambda: tk.trace_deviation_reference(*k1)),
                       "bound_ms": rf.k1_seconds(n, mirrors) * 1e3,
                       "mirrors": mirrors},
                "K2": {**timing(lambda: tk.detector(*k2),
                                lambda: tk.detector_reference(*k2)),
                       "bound_ms": rf.k2_seconds(n) * 1e3},
                "launches": launches, "rays": n}
        print(f"align {name}: {json.dumps(out[name])}", flush=True)
    return out


def wave_handoff(dev):
    """One handoff of the wave-257 cell, and its wavelength."""
    def load(*parts):
        with open(os.path.join(ROOT, "portbench", *parts)) as f:
            return json.load(f)

    from portbench.kinds import wave as wave_kind

    cfg, t = load("configs", "wolter31-euv.json"), load("traffic",
                                                       "wave-257.json")
    vec = np.random.default_rng(SEED).normal(0.0, float(t["sigma"]), 26)
    return (wave_kind.handoff(cfg["system"], vec, t, dev),
            float(t["wavelength"]))


def wave_path(dev, geom, lam):
    """The chain through K3: its launches, K3 on the M4 -> Image stage
    against its twin, their times and K3's bound."""
    from akbx_torch import wave
    from akbx_torch.kernels import huygens as hk
    from portbench import roofline as rf

    source, pts, ds = geom
    stages = [{"points": pts[j], "ds": ds[j], "name": NAMES[j]}
              for j in range(4)] + [{"points": pts[4], "name": NAMES[4]}]
    before = hk.huygens.launches
    fields = wave.propagate_stages(wave.point_source(source, device=dev),
                                   stages, lam)
    fields.append(wave.propagate_field(fields[3], pts[5], lam))
    torch.cuda.synchronize()
    launches = hk.huygens.launches - before
    check(launches == 6, f"the wave chain launched K3 {launches} times")
    args = hk.kernel_args(fields[3], pts[4], lam)
    with torch.no_grad():
        rel = field_rel(hk.huygens(*args), hk.huygens_reference(*args))
    check(rel <= HUYGENS_REL, f"K3 vs its twin: {rel:.3e} of the field")
    n, m = args[0].shape[1], args[1].shape[1]
    entry = {**timing(lambda: hk.huygens(*args),
                      lambda: hk.huygens_reference(*args), twin_reps=1),
             "bound_ms": rf.k3_seconds(n, m) * 1e3, "launches": launches,
             "of_the_field": rel, "pairs": n * m}
    print(f"wave M4 -> Image: {json.dumps(entry)}", flush=True)
    return entry


def ring_path(dev, geom, lam):
    """The chain with every stage on a one-rank huygens_ring: K4's
    launches, K4 on the ring's tile of the M4 -> Image stage against its
    twin, their times and K4's bound."""
    import torch.distributed as dist

    from akbx_torch.kernels import huygens_f64 as k4
    from akbx_torch.parallel import sharding as sh

    source, pts, ds = geom
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = sh.ray_mesh(device_type="cuda")
            before = k4.huygens_f64.launches
            fields = []
            for j, f in enumerate(FROM):
                if f < 0:
                    src = source[:, None]
                    w_re = torch.ones(1, dtype=torch.float64, device=dev)
                    w_im = torch.zeros_like(w_re)
                else:
                    src = pts[f]
                    w_re, w_im = fields[f][0] * ds[f], fields[f][1] * ds[f]
                fields.append(sh.huygens_ring(src, w_re, w_im, pts[j], lam,
                                              mesh))
            torch.cuda.synchronize()
            launches = k4.huygens_f64.launches - before
        finally:
            dist.destroy_process_group()
    t = RING_TILE
    w_re, w_im = fields[3][0] * ds[3], fields[3][1] * ds[3]
    args = (pts[4][:, :t].contiguous(), pts[3][:, :t].contiguous(),
            w_re[:t].contiguous(), w_im[:t].contiguous(),
            2.0 * np.pi / lam)
    acc = torch.zeros((2, t), dtype=torch.float64, device=dev)
    ref = torch.zeros_like(acc)
    k4.huygens_f64(*args, acc[0], acc[1])
    k4.huygens_f64_reference(*args, ref[0], ref[1])
    rel = field_rel(acc, ref)
    check(rel <= K4_REL, f"K4 vs its twin: {rel:.3e} of the field")
    # every input read once, the sums read and written once
    n_bytes = t * 3 * 8 + t * 5 * 8 + 2 * 2 * t * 8
    bound_s = max(n_bytes / 3.35e12, t * t * K4_OPS_PER_PAIR / F64_OPS)
    entry = {**timing(lambda: k4.huygens_f64(*args, acc[0], acc[1]),
                      lambda: k4.huygens_f64_reference(*args, ref[0],
                                                       ref[1])),
             "bound_ms": bound_s * 1e3, "launches": launches,
             "of_the_field": rel, "pairs": t * t}
    print(f"ring tile {t} x {t}: {json.dumps(entry)}", flush=True)
    return entry


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    print(card(), flush=True)
    align = align_path(dev)
    geom, lam = wave_handoff(dev)
    k3 = wave_path(dev, geom, lam)
    k4 = ring_path(dev, geom, lam)
    main_path = align["wolter31"]
    kernels = [
        {"name": "K1 trace_deviation", "source":
         "akbx_torch/csrc/trace_kernel.cu", **main_path["K1"],
         "launches": main_path["launches"][0], "library_ms": None,
         "systems": {k: v["K1"] for k, v in align.items()}},
        {"name": "K2 detector", "source": "akbx_torch/csrc/trace_kernel.cu",
         **main_path["K2"], "launches": main_path["launches"][1],
         "library_ms": None,
         "systems": {k: v["K2"] for k, v in align.items()}},
        {"name": "K3 huygens", "source": "akbx_torch/csrc/huygens_kernel.cu",
         **k3, "library_ms": None},
        {"name": "K4 huygens_f64",
         "source": "akbx_torch/csrc/huygens_f64_kernel.cu", **k4,
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
