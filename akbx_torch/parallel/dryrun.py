"""Multi-device dry run of the port: one full training step over a
ray-sharded mesh (the port's counterpart of akbx's ``dryrun_multichip``).

The step is :func:`akbx_torch.parallel.sharding.make_train_step` on the
Wolter III+I system with 3x3 figure coefficients on the four mirrors and
the 26 alignment parameters, replicated, on an 8x8 fan sharded over the
ranks; Adam (lr 1e-9) takes one step.  It fails unless the loss is
finite.  Run on N cards with

    torchrun --nproc-per-node N -m akbx_torch.parallel.dryrun

(``DRYRUN_DEVICES``, where set, must equal N), or on the CPU over gloo
with ``--device cpu``.  :func:`dryrun` runs the step on a mesh the caller
has set up, in process.
"""

from __future__ import annotations

import argparse
import functools
import math
import os

import torch
import torch.distributed as dist

from akbx_torch.parallel import sharding as sh


def dryrun(mesh, n_h: int = 8, n_v: int = 8) -> float:
    """One train step on ``mesh``; returns the (replicated) loss, and
    raises unless it is finite."""
    from akbx_torch import trace
    from akbx_torch.systems import WOLTER_3_1_DEFAULT

    dev = sh.mesh_device(mesh)

    def loss_fn(sys_, res):
        w = res.total_dist - trace.masked_mean(res.total_dist, res.valid,
                                               mesh=mesh)
        return sh.all_sum(torch.sum(torch.where(res.valid, w, 0.0) ** 2),
                          mesh) * 1e18

    step, _, _ = sh.make_train_step(
        WOLTER_3_1_DEFAULT, loss_fn,
        functools.partial(torch.optim.Adam, lr=1e-9), n_h, n_v, mesh)
    params = {
        "align": torch.zeros(26, dtype=torch.float64, device=dev,
                             requires_grad=True),
        "figures": [torch.zeros((3, 3), dtype=torch.float64, device=dev,
                                requires_grad=True) for _ in range(4)],
    }
    _, _, val = step(None, params)
    val = float(val)
    if not math.isfinite(val):
        raise RuntimeError(f"training-step loss is not finite: {val}")
    return val


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="akbx_torch.parallel.dryrun")
    parser.add_argument("--device", default="cuda",
                        help="cuda (NCCL, one card per rank) or cpu (gloo)")
    args = parser.parse_args(argv)
    backend = "nccl" if args.device == "cuda" else "gloo"
    dist.init_process_group(backend)
    try:
        want = os.environ.get("DRYRUN_DEVICES")
        if want is not None and int(want) != dist.get_world_size():
            raise SystemExit(f"DRYRUN_DEVICES={want} but the world has "
                             f"{dist.get_world_size()} ranks")
        mesh = sh.ray_mesh(device_type=args.device)
        val = dryrun(mesh)
        if dist.get_rank() == 0:
            print(f"dryrun over {mesh.size()} ranks ({backend}) OK: loss "
                  f"{val:.9e}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
