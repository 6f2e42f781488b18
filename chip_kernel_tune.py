#!/usr/bin/env python3
"""Times of akbx_torch's CUDA kernels on one card: the launch shapes that
were tried for K3 and K1, and two trees side by side.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_kernel_tune.py               # the variants of K3 and K1
    python3 chip_kernel_tune.py --times       # K1, K2, K3 as shipped
    python3 chip_kernel_tune.py --compare DIR # this tree against the one
                                              # unpacked in DIR

The variants run come from a second build of the kernel library
(``-DAKBX_TUNE``): K3 at 64, 128 and 256 threads a block with 1, 2, 4 and
8 sources in flight per thread and 1, 2, 4 or 8 lanes sharing a target, K1 for four mirrors at 1 to 6 blocks of
256 an SM as its register target, with and without streaming stores.
Each variant is held bit for bit against the shipped kernel, and its
registers, stack and spills are read from the build log.  Shapes are the
main paths': a 2048x2048 fan (4,194,304 rays) and a 66,049 x 66,049
stage.  Times are medians of CUDA-event runs after a warm-up.  It also
prints the machine instructions of the shipped K3 and K1 by opcode
(``cuobjdump -sass``) and the SM clock while K3 runs, which together say
how close a kernel is to the card's instruction rate.

``--compare DIR`` runs ``--times`` in turns on DIR (an older tree, e.g.
``git archive`` of the parent commit), this tree, this tree, DIR, each in
a process of its own on the same card, and prints the four readings.
``--times`` touches only what both trees have: the wrappers
``trace_deviation``, ``detector``, ``huygens`` and ``kernel_args``.
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np

N_SIDE = 2048    # the forward path's fan
W_SIDE = 257     # the wave path's fan: 66,049 points a surface
EUV = 13.5e-9
FEW = 2048       # targets of the few-target timing of K3
# K3: (targets' block, sources in flight per thread, lanes per target)
K3_VARIANTS = ([(b, u, 1) for b in (64, 128, 256) for u in (1, 2, 4)]
               + [(256, 8, 1)]
               + [(b, u, s) for s in (2, 4) for b in (128, 256)
                  for u in (1, 2, 4)]
               + [(256, u, 8) for u in (1, 2, 4)])
K1_VARIANTS = [(1, 0), (2, 0), (3, 0), (4, 0), (5, 0), (6, 0), (2, 1), (3, 1),
               (4, 1)]


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps, warmup=1):
    """Median milliseconds of ``fn`` between CUDA events."""
    import torch

    def once():
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    for _ in range(warmup):
        once()
    return statistics.median(once() for _ in range(reps))


def inputs(dev):
    """K1's, K2's and K3's arguments at the main paths' shapes."""
    import torch

    from akbx_torch import trace, wave
    from akbx_torch.kernels import huygens as hk
    from akbx_torch.kernels import trace_kernel as tk
    from akbx_torch.systems import (AlignParams, WOLTER_3_1_DEFAULT,
                                    build_wolter_3_1)

    s = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.zeros(dev))
    rays = trace.ray_fan(trace.fan_angles(s.fan_h, N_SIDE),
                         trace.fan_angles(s.fan_v, N_SIDE))
    n = rays.shape[1]
    src = s.source[:, None].expand(3, n)
    chief_d0, chief_p0, c64 = trace._fast_scalars(s, rays, src, n // 2)
    (Ms, bvecs, Ds, Dns, Ts, A, Bp, rho, gC, gA, br, _) = c64
    table = tk.pack_consts(Ms, gC, gA, Ds, Dns, Ts, A, Bp, rho, br, bvecs)
    k1 = (table, (src - chief_p0).contiguous(),
          (rays - chief_d0).contiguous(), 4)
    out = tk.trace_deviation(*k1)
    f64 = dict(dtype=torch.float64, device=dev)
    R = torch.eye(3, **f64)
    planes = torch.cat([
        tk.pack_det_consts(R, Dns[-1], torch.tensor(t, **f64),
                           torch.tensor(t, **f64)) for t in (0.2, 0.201)])
    k2 = (planes, out[0][9:12].contiguous(), out[1][9:12].contiguous(),
          out[2][9:12].contiguous(), out[3][9:12].contiguous(), out[6],
          out[7])
    del out

    m = W_SIDE ** 2
    rng = np.random.default_rng(1)
    pts = np.array([145.0, 0.02, 0.0])[:, None] + rng.normal(size=(3, m)) * 0.05
    tgt = np.array([146.0, 0.05, 0.01])[:, None] + rng.normal(size=(3, m)) * 0.02
    u = rng.normal(size=m) + 1j * rng.normal(size=m)
    ds = np.abs(rng.normal(size=m)) * 1e-8
    field = wave.WaveField.from_complex(pts, u, ds, device=dev)
    k3 = hk.kernel_args(field, torch.tensor(tgt, device=dev), EUV)
    return k1, k2, k3


def shipped_times(dev):
    """K1, K2, K3 through their wrappers (ms, median of 10 / 10 / 5)."""
    from akbx_torch.kernels import huygens as hk
    from akbx_torch.kernels import trace_kernel as tk

    k1, k2, k3 = inputs(dev)
    return {"K1": time_ms(lambda: tk.trace_deviation(*k1), 10, 2),
            "K2": time_ms(lambda: tk.detector(*k2), 10, 2),
            "K3": time_ms(lambda: hk.huygens(*k3), 5, 1)}


def ptxas_report(log_text):
    """{mangled kernel name: (registers, stack bytes, spill stores, spill
    loads)} from nvcc's -Xptxas=-v output."""
    out, name, stack = {}, None, (0, 0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *stack)
            name = None
    return out


def resident_blocks(regs, block, smem):
    """Blocks of ``block`` threads an SM of this card holds: 65,536
    registers handed out in eights per thread, 2,048 threads, 32 blocks,
    227 KB of shared memory plus 1 KB a block."""
    per_thread = -(-regs // 8) * 8
    limits = [65536 // (per_thread * block), 2048 // block, 32]
    if smem:
        limits.append((227 * 1024) // (smem + 1024))
    return min(limits)


def sass_opcodes(lib_path, kernel):
    """{opcode: count} of one kernel's machine code, from cuobjdump; None
    where the toolkit has no cuobjdump."""
    from akbx_torch.kernels import _build

    exe = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(exe):
        return None
    proc = subprocess.run([exe, "-sass", "-fun", kernel, str(lib_path)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        return None
    counts = {}
    for line in proc.stdout.splitlines():
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_]+)",
                     line)
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def clock_under_load(launch, n_launches):
    """The SM clock (MHz) nvidia-smi reads while ``n_launches`` of
    ``launch`` are queued and running."""
    import torch

    for _ in range(n_launches):
        launch()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    return out, busy


def find(report, pattern):
    hits = [v for k, v in report.items() if re.search(pattern, k)]
    if len(hits) != 1:
        raise RuntimeError(f"{len(hits)} kernels match {pattern}")
    return hits[0]


def variants(dev):
    import time

    import torch

    from akbx_torch.kernels import _build, ptr, raise_on, stream
    from akbx_torch.kernels import huygens as hk
    from akbx_torch.kernels import trace_kernel as tk

    t0 = time.perf_counter()
    lib = _build.load(_build.TUNE)
    print(f"variants library built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    log = _build.BUILD_ROOT / _build.source_hash(_build.TUNE) / "build.log"
    report = ptxas_report(log.read_text())
    k1, k2, k3 = inputs(dev)

    # --- K3 ---------------------------------------------------------------
    tgt, src, w, k_pair = k3
    n, m = tgt.shape[1], src.shape[1]
    k_hi, k_lo = k_pair.tolist()
    want = hk.huygens(*k3)
    rows = []
    tgt_few = tgt[:, :FEW].contiguous()   # the same sources, few targets
    for block, unroll, split in K3_VARIANTS:
        out = torch.empty((2, n), dtype=torch.float32, device=dev)

        def run(targets=tgt):
            raise_on(lib.akbx_huygens_variant(
                block, unroll, split, ptr(targets), targets.shape[1],
                ptr(src), ptr(w), m, k_hi, k_lo, ptr(out), stream(tgt)),
                "huygens variant")

        ms = time_ms(run, 5)
        same = bool(torch.equal(out[0].double(), want[0])
                    and torch.equal(out[1].double(), want[1]))
        few_ms = time_ms(lambda: run(tgt_few), 5)
        regs, stack, st, ld = find(
            report, rf"huygens_kernelILi{block}ELi{unroll}ELi{split}E")
        blocks = resident_blocks(regs, block, 16384)
        rows.append({"block": block, "unroll": unroll, "split": split,
                     "ms": ms, f"ms_{FEW}_targets": few_ms,
                     "registers": regs, "stack": stack, "spill_stores": st,
                     "spill_loads": ld, "blocks_per_sm": blocks,
                     "warps_per_sm": blocks * block // 32,
                     "grid": -(-n // (block // split)),
                     "same_bits_as_shipped": same})
        print("K3", json.dumps(rows[-1]), flush=True)
    k3_rows = rows

    # --- K1 ---------------------------------------------------------------
    table, dp, dd, n_mirr = k1
    n = dp.shape[1]
    want = tk.trace_deviation(*k1)
    rows = []
    for min_blocks, stcs in K1_VARIANTS:
        outs = [torch.empty_like(o) for o in want]

        def run():
            raise_on(lib.akbx_trace_deviation_variant(
                min_blocks, stcs, ptr(table), n_mirr, ptr(dp), ptr(dd), n,
                *[ptr(o) for o in outs], stream(dp)), "trace variant")

        ms = time_ms(run, 10, 2)
        same = all(bool(torch.equal(a, b)) for a, b in zip(outs, want))
        regs, stack, st, ld = find(
            report, rf"trace_deviation_kernelILi4ELi{min_blocks}ELb{stcs}E")
        blocks = resident_blocks(regs, 256, 0)
        rows.append({"min_blocks": min_blocks, "streaming_stores": bool(stcs),
                     "ms": ms, "registers": regs, "stack": stack,
                     "spill_stores": st, "spill_loads": ld,
                     "blocks_per_sm": blocks, "warps_per_sm": blocks * 8,
                     "same_bits_as_shipped": same})
        print("K1", json.dumps(rows[-1]), flush=True)
    shipped = {"K1": time_ms(lambda: tk.trace_deviation(*k1), 10, 2),
               "K2": time_ms(lambda: tk.detector(*k2), 10, 2),
               "K3": time_ms(lambda: hk.huygens(*k3), 5, 1)}
    regs = {k: v for k, v in report.items() if "detector" in k}
    print("shipped", json.dumps(shipped), "K2 ptxas", json.dumps(regs),
          flush=True)
    # the shipped instances are the ones the default build holds
    plain = ptxas_report((_build.BUILD_ROOT / _build.source_hash()
                          / "build.log").read_text())
    for label, pattern in (("K3", "huygens_kernel"),
                           ("K1", "trace_deviation_kernelILi4E")):
        name = next(k for k in plain if pattern in k)
        ops = sass_opcodes(_build.build(), name)
        if ops:
            by_count = sorted(ops.items(), key=lambda kv: -kv[1])
            print(f"{label} machine code: {sum(ops.values())} instructions "
                  f"in {name} ({plain[name][0]} registers); by opcode: "
                  f"{by_count}", flush=True)
        else:
            print(f"{label} machine code: cuobjdump not available",
                  flush=True)
    clock, busy = clock_under_load(lambda: hk.huygens(*k3), 20)
    print(f"SM clock, power while K3 runs (still running: {busy}): {clock}",
          flush=True)
    bad = [r for r in k3_rows + rows if not r["same_bits_as_shipped"]]
    if bad:
        raise SystemExit(f"variants that differ from the shipped kernel: {bad}")


def compare(parent):
    here = os.path.dirname(os.path.abspath(__file__))
    readings = []
    for label, root in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--times", "--root",
             os.path.abspath(root)], capture_output=True, text=True,
            timeout=1500)
        if proc.returncode != 0:
            raise SystemExit(f"--times on {root} failed:\n{proc.stdout}"
                             f"{proc.stderr}")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        readings.append({"tree": label, **times})
        print(json.dumps(readings[-1]), flush=True)
    return readings


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--times", action="store_true",
                    help="time K1, K2, K3 as shipped and print one JSON line")
    ap.add_argument("--root", default=None,
                    help="with --times: the tree whose akbx_torch to import")
    ap.add_argument("--compare", metavar="DIR", default=None,
                    help="an older tree to time in turns with this one")
    args = ap.parse_args()
    if args.compare:
        print(card(), flush=True)
        compare(args.compare)
        return 0
    if args.root:
        sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_kernel_tune: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    if args.times:
        print(json.dumps(shipped_times(dev)), flush=True)
        return 0
    print(card(), flush=True)
    variants(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
