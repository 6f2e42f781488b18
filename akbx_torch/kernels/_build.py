"""Build and load the port's CUDA kernels.

Each ``.cu`` source in ``akbx_torch/csrc`` is compiled by its own
``nvcc``, all started together, and the objects are linked into one
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
              "-Xptxas=-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_SIGNATURES = {
    # consts, n_mirr, dp64, dd64, n, 9 outputs, stream
    "akbx_trace_deviation": [_P, ctypes.c_int, _P, _P, ctypes.c_longlong]
    + [_P] * 9 + [_P],
    # consts, n_planes, 6 inputs, n, 8 outputs, stream
    "akbx_detector": [_P, ctypes.c_int] + [_P] * 6 + [ctypes.c_longlong]
    + [_P] * 8 + [_P],
    # tgt, n, src, w, m, k_pair, out, stream
    "akbx_huygens": [_P, ctypes.c_longlong, _P, _P, ctypes.c_longlong, _P,
                     _P, _P],
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
    library path.  The compilers' reports (registers, spills) are kept in
    ``build.log`` beside it."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], False
    for cmd, _, proc in jobs:
        log.append(" ".join(cmd) + "\n" + proc.communicate()[0])
        failed |= proc.returncode != 0
    tmp = out_dir / f"{LIB_NAME}.{tag}.tmp"
    if not failed:
        cmd = [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        failed = proc.returncode != 0
    (out_dir / "build.log").write_text("".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "".join(log))
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
