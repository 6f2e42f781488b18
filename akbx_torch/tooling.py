"""Sweep artifact writers (the part of :mod:`akbx.tooling` that ``cli
trace`` runs): the files akbx's sweep readers consume."""

from __future__ import annotations

import os

import numpy as np

from akbx_torch.utils import to_numpy


def write_sweep_artifacts(directory: str, inner_products, orders, pvs,
                          fit_sum=None):
    """Write ``inner_products.csv``, ``orders.csv``, ``pvs.txt`` and
    (given ``fit_sum``) ``fit_sum.txt`` into ``directory``, in akbx's
    formats.  Tensors on any device or array-likes."""
    os.makedirs(directory, exist_ok=True)
    np.savetxt(os.path.join(directory, "inner_products.csv"),
               to_numpy(inner_products), delimiter=",")
    np.savetxt(os.path.join(directory, "orders.csv"),
               np.asarray(orders, dtype=float), delimiter=",")
    np.savetxt(os.path.join(directory, "pvs.txt"), to_numpy(pvs))
    if fit_sum is not None:
        np.savetxt(os.path.join(directory, "fit_sum.txt"), to_numpy(fit_sum))
    return directory
