"""Build and load the port's CUDA kernels.

The sources in ``akbx_torch/csrc`` are compiled with ``nvcc`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``akbx_torch/_build/<hash>/``, keyed by a hash of the
sources and flags, and is built at first use.  Never ``--use_fast_math``:
the double-f32 error-free transforms need every add and multiply rounded
as written (``-fmad=false``, IEEE division and square root).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libakbx_torch.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_SIGNATURES = {
    # consts, n_mirr, dp64, dd64, n, 9 outputs, stream
    "akbx_trace_deviation": [_P, ctypes.c_int, _P, _P, ctypes.c_longlong]
    + [_P] * 9 + [_P],
    # consts, n_planes, 6 inputs, n, 8 outputs, stream
    "akbx_detector": [_P, ctypes.c_int] + [_P] * 6 + [ctypes.c_longlong]
    + [_P] * 8 + [_P],
}


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def build() -> Path:
    """Compile the kernels unless this source hash is built; returns the
    library path.  The compiler's report (registers, spills) is kept in
    ``build.log`` beside it."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build at first use and load the kernels' library."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
