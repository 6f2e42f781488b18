"""One rank of a tiny run of the four-card ring cell on the CPU, over
gloo; rank 0 prints the result line, as a run of the cell does.

    python portbench/tests/ring_ranks.py <rank> <world> <port>

``RING_FAULT`` plants a fault: ``exchange`` leaves the ring's exchange
out, ``akbx`` puts a module named ``akbx`` in rank 1's ``sys.modules``.
"""

import os
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)


def leave_out_exchange():
    """The fault of a ring whose exchange between ranks is left out:
    each rank's next block is its own block again."""
    import torch.distributed as dist

    def exchange(ops):
        send, recv = ops
        recv.tensor.copy_(send.tensor)
        return []

    dist.batch_isend_irecv = exchange


def main(rank: int, world: int, port: int) -> int:
    import torch
    from conftest import ROOT, SEED, small_cell

    from portbench import harness

    fault = os.environ.get("RING_FAULT")
    if fault == "exchange":
        leave_out_exchange()
    if fault == "akbx" and rank == 1:
        sys.modules["akbx"] = types.ModuleType("akbx")
    t0 = time.perf_counter()
    mesh = harness.init_mesh("gloo", rank, world, port, "cpu")
    bench = harness.Bench(ROOT)
    cell = small_cell(bench, "wolter31.wave-ring-257")
    return harness.run_world(bench, cell, SEED, 0.5,
                             os.environ.get("RING_TRACE") == "1",
                             torch.device("cpu"), t0, mesh)


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])))
