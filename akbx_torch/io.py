"""Run I/O (port of :mod:`akbx.io`): the wave-handoff directory, stage
checkpointing, run manifests and the optical-params file.

The file formats are akbx's, which are the reference's: either package
reads the other's directories and caches.

* ``save_wave_data`` writes ``points_source.npy``, ``points_M{1..4}.npy``
  (with the dS quadrature as row 3), ``points_gridImage.npy``,
  ``points_gridDefocus.npy`` and ``calculation_conditions.txt`` in the
  reference's key:value format;
* ``load_wave_data`` reads such a directory;
* :class:`StageCache` keeps each propagation stage's complex field in
  ``complex_data_<stage>.npz``, guarded by a geometry key, and reloads it
  on a rerun;
* ``write_manifest``/``read_manifest`` persist a typed run configuration.
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import datetime

import numpy as np
import torch

from akbx_torch.utils import to_numpy
from akbx_torch.wave import WaveField, calc_ds


def run_directory(base: str = ".", tag: str = "") -> str:
    """Timestamped output directory."""
    ts = datetime.now().strftime("%Y%m%d_%H%M%S")
    name = f"output_{ts}{('_' + tag) if tag else ''}"
    path = os.path.join(base, name)
    os.makedirs(path, exist_ok=True)
    return path


def save_wave_data(directory: str, source_point, surfaces: dict,
                   grid_image, grid_defocus=None, conditions: dict | None = None):
    """Export traced surface grids in the reference's wave-handoff format.

    ``surfaces``: ordered dict name -> (points (3,N), n_v, n_h); points get
    the dS row appended (computed on the points' device if they are a
    tensor, else on the host).
    """
    os.makedirs(directory, exist_ok=True)
    np.save(os.path.join(directory, "points_source.npy"),
            to_numpy(source_point).astype(np.float64).reshape(3))

    for i, (name, (pts, n_v, n_h)) in enumerate(surfaces.items()):
        pts = torch.as_tensor(pts, dtype=torch.float64)
        arr = torch.cat([pts, calc_ds(pts, n_v, n_h)[None, :]])
        np.save(os.path.join(directory, f"points_M{i+1}.npy"), to_numpy(arr))

    np.save(os.path.join(directory, "points_gridImage.npy"),
            to_numpy(grid_image).astype(np.float64))
    if grid_defocus is not None:
        np.save(os.path.join(directory, "points_gridDefocus.npy"),
                to_numpy(grid_defocus).astype(np.float64))

    cond = dict(conditions or {})
    path = os.path.join(directory, "calculation_conditions.txt")
    with open(path, "w") as f:
        f.write("Conditions\n")
        f.write("====================\n")
        for key, value in cond.items():
            f.write(f"{key}: {value}\n")
        f.write("====================\n")
    return directory


def parse_conditions(path: str) -> dict:
    """Parse the key:value conditions file (ints, floats, bools, else
    strings)."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, _, value = line.partition(":")
            key = key.strip()
            value = value.strip()
            if value in ("True", "False"):
                out[key] = value == "True"
            else:
                try:
                    out[key] = int(value)
                except ValueError:
                    try:
                        out[key] = float(value)
                    except ValueError:
                        out[key] = value
    return out


def load_wave_data(directory: str) -> dict:
    """Load a wave-handoff directory (the port's, akbx's or the
    reference's) as numpy arrays."""
    out = {"source": np.load(os.path.join(directory, "points_source.npy"))}
    i = 1
    while os.path.exists(os.path.join(directory, f"points_M{i}.npy")):
        out[f"M{i}"] = np.load(os.path.join(directory, f"points_M{i}.npy"))
        i += 1
    for name in ("points_gridImage", "points_gridDefocus"):
        p = os.path.join(directory, name + ".npy")
        if os.path.exists(p):
            out[name.replace("points_", "")] = np.load(p)
    cond = os.path.join(directory, "calculation_conditions.txt")
    if os.path.exists(cond):
        out["conditions"] = parse_conditions(cond)
    return out


class StageCache:
    """Per-stage complex-field checkpointing (resume mechanism), with a
    geometry key so a stale cache is not silently reused."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"complex_data_{name}.npz")

    @staticmethod
    def _geom_key(points) -> str:
        a = to_numpy(points)
        return f"{a.shape}|{float(a.sum()):.17e}|{float(np.abs(a).sum()):.17e}"

    def load(self, name: str, points) -> WaveField | None:
        """The cached field on ``points`` (on their device if a tensor),
        or None if there is none or its geometry key differs."""
        path = self._path(name)
        if not os.path.exists(path):
            return None
        with np.load(path, allow_pickle=False) as data:
            if "geom_key" in data and str(data["geom_key"]) != self._geom_key(points):
                return None
            u = data["data"]
            ds = data["ds"] if "ds" in data else np.ones(u.shape[0])
            n_h = int(data["n_h"]) if "n_h" in data else 0
            n_v = int(data["n_v"]) if "n_v" in data else 0
        return WaveField.from_complex(points, u, ds, n_h, n_v)

    def save(self, name: str, field: WaveField):
        np.savez_compressed(
            self._path(name),
            data=to_numpy(field.re) + 1j * to_numpy(field.im),
            ds=to_numpy(field.ds),
            n_h=field.n_h, n_v=field.n_v,
            geom_key=self._geom_key(field.points))


def write_manifest(directory: str, config: dict | object):
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        config = dataclasses.asdict(config)
    with open(os.path.join(directory, "run_manifest.json"), "w") as f:
        json.dump(config, f, indent=2, default=str)


def read_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "run_manifest.json")) as f:
        return json.load(f)


def write_optical_params(directory: str, params_vector):
    """Reference-format alignment-params dump (``optical_params.txt``)."""
    v = to_numpy(params_vector).ravel()
    path = os.path.join(directory, "optical_params.txt")
    with open(path, "w") as f:
        f.write("input\n")
        f.write("====================\n")
        for i, value in enumerate(v):
            f.write(f"params[{i}]: {value}\n")
    return path


def read_optical_params(path: str) -> np.ndarray:
    """Parse ``optical_params.txt`` back into a vector."""
    values = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("params[") and ":" in line:
                idx = int(line[len("params["):line.index("]")])
                values[idx] = float(line.split(":", 1)[1])
    out = np.zeros(max(values) + 1)
    for i, v in values.items():
        out[i] = v
    return out
