"""The native (C++/OpenMP) Huygens engine of the port, loaded with ctypes.

``huygens.cpp`` beside this file is the port's own copy of akbx's host
engine, with the same C interface (``huygens_propagate``, ``calc_ds``,
``num_threads``).  It is compiled at first use with akbx's flags into
``akbx_torch/_build/native-<source hash>/``: to a temporary name first,
then renamed into place, so a process that finds the library finds it
whole.  A failed build raises; nothing falls back.

The engine runs on the host: tensors on any device are copied there, and
the results come back on the device of the targets.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from akbx_torch.utils import to_numpy

SRC = Path(__file__).resolve().parent / "huygens.cpp"
BUILD_ROOT = SRC.parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             "-std=c++17")
LIB_NAME = "libakbx_huygens.so"


def lib_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    lib = lib_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"native build failed: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("native build failed:\n" + " ".join(cmd) + "\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build at first use and load the library (a failure raises and is
    retried on the next call)."""
    lib = ctypes.CDLL(str(build()))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.huygens_propagate.argtypes = [dp, ctypes.c_int64, dp, ctypes.c_int64,
                                      dp, dp, ctypes.c_double, dp, dp]
    lib.huygens_propagate.restype = None
    lib.calc_ds.argtypes = [dp, ctypes.c_int64, ctypes.c_int64, dp]
    lib.calc_ds.restype = None
    lib.num_threads.argtypes = []
    lib.num_threads.restype = ctypes.c_int
    return lib


def _host(x) -> np.ndarray:
    return np.ascontiguousarray(to_numpy(x), dtype=np.float64)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _device(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def huygens_propagate(tgt_pts, src_pts, w_re, w_im, k: float):
    """The f64 OpenMP Huygens sum ``u[i] = sum_j w[j] exp(-i k r_ij) /
    r_ij``: targets (3, N), sources (3, M), weights (M,) already
    multiplied by ``ds``.  Returns (re, im) f64 tensors on the targets'
    device (the CPU for arrays)."""
    lib = load()
    tgt, src, wr, wi = (_host(x) for x in (tgt_pts, src_pts, w_re, w_im))
    n, m = tgt.shape[1], src.shape[1]
    if tgt.shape[0] != 3 or src.shape[0] != 3 or wr.shape != (m,) \
            or wi.shape != (m,):
        raise ValueError(f"shapes {tgt.shape}, {src.shape}, {wr.shape}, "
                         f"{wi.shape}: want (3, N), (3, M), (M,), (M,)")
    out_re = np.empty(n, dtype=np.float64)
    out_im = np.empty(n, dtype=np.float64)
    lib.huygens_propagate(_ptr(tgt), n, _ptr(src), m, _ptr(wr), _ptr(wi),
                          float(k), _ptr(out_re), _ptr(out_im))
    dev = _device(tgt_pts)
    return torch.from_numpy(out_re).to(dev), torch.from_numpy(out_im).to(dev)


def calc_ds(points, n_v: int, n_h: int) -> torch.Tensor:
    """Per-point surface area of an (n_v, n_h) grid (3, n_v * n_h), as
    :func:`akbx_torch.wave.calc_ds` computes it, on the points' device."""
    lib = load()
    pts = _host(points)
    if pts.shape != (3, n_v * n_h):
        raise ValueError(f"points {pts.shape}, want (3, {n_v * n_h})")
    out = np.empty(n_v * n_h, dtype=np.float64)
    lib.calc_ds(_ptr(pts), n_v, n_h, _ptr(out))
    return torch.from_numpy(out).to(_device(points))


def num_threads() -> int:
    """The OpenMP threads the engine runs on."""
    return int(load().num_threads())
