"""One run of one cell of ``BENCHMARK.json``:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``akbx_torch``.  Exits non-zero,
printing no result, without a CUDA card (or with fewer than the cell
asks for), without the program, or when JAX was loaded."""

import time

T0 = time.perf_counter()  # the process's start, as near as Python gets

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness

    return harness.main(ROOT, args.workload, args.seed, args.seconds,
                        bool(args.trace), T0)


if __name__ == "__main__":
    sys.exit(main())
