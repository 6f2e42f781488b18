"""The readings that the limits of ``correct`` are set from.

    python3 portbench/control.py --workload <cell> --seeds 1-12 \
        --control-seeds 1-3 --seconds 3 [--faults a,b] [--device cuda]

For each seed, in one process: the cell's set-up, a short window at the
cell's own size and load, and the check's numbers, the program's against
the plain reference (the lower readings); for each control seed also the
numbers of the control (the upper readings): the program's own path below
the configuration's precision where it names one, else the plain
reference computed in float32, put in the program's place; and, for a
kind that can compute its steps again (``rerun``), the numbers of each
fault of ``portbench/faults.py`` named in ``--faults``, planted in the
program.  One JSON line a seed; the largest of the program's numbers and
the smallest of the control's and of each fault's last.  The benchmark's
own runs never run the control or a fault."""

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def readings(bench, cell, seed: int, seconds: float, device,
             control: bool, mesh=None, fault_names=()) -> dict | None:
    from portbench import faults, harness

    ctx = types.SimpleNamespace(device=device, seed=seed, config=cell.config,
                                traffic=cell.traffic, chips=cell.chips,
                                trace=False, mesh=mesh)
    kind = cell.kind
    ranks = harness.Ranks(mesh, device)
    st = kind.setup(ctx, harness.Spans(device, False))
    n, t0 = 0, time.perf_counter()
    while ranks.agree(time.perf_counter() - t0 < seconds):
        kind.step(st, n, None)
        harness.sync(device)
        n += 1
    stats = kind.window(st, n)
    kind.free(st)
    if ranks.rank != 0:
        return None
    out = {"seed": seed, "steps": n, "failed": stats["failed"],
           "program": kind.check(st, seed)}
    if control:
        out["control"] = kind.control(st, seed)
        for name in fault_names:
            with faults.planted(name, cell.config):
                out.setdefault("faults", {})[name] = kind.rerun(st, seed)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", default="",
                    help="faults of portbench/faults.py, comma-separated")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    ctl = set(seeds(args.control_seeds))
    rank, device, mesh, children = harness.start_world(
        os.path.abspath(__file__), argv or sys.argv[1:], cell.chips,
        args.device)
    rows = []
    try:
        for seed in sorted(set(seeds(args.seeds)) | ctl):
            row = readings(bench, cell, seed, args.seconds, device,
                           seed in ctl, mesh,
                           [f for f in args.faults.split(",") if f])
            if row is not None:
                rows.append(row)
                print(json.dumps(harness.finite(row)), flush=True)
    finally:
        failed = harness.stop_world(mesh, children)
    if rank != 0:
        return 0
    if failed:
        print(f"ranks failed: {failed}", file=sys.stderr)
        return 4
    lower = {k: max(r["program"][k] for r in rows)
             for k in rows[0]["program"]}
    upper = {k: min(r["control"][k] for r in rows if "control" in r)
             for k in rows[0]["program"]} if ctl else {}
    by_fault = {f: {k: min(r["faults"][f][k] for r in rows if "faults" in r)
                    for k in rows[0]["program"]}
                for f in next((r["faults"] for r in rows if "faults" in r),
                              {})}
    print(json.dumps(harness.finite({"lower": lower, "upper": upper,
                                     "faults": by_fault})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
