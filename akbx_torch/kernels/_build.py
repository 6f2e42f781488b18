"""Build and load the port's CUDA kernels.

Each ``.cu`` source in ``akbx_torch/csrc`` is compiled by its own
``nvcc``, all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``akbx_torch/_build/<hash>/``, keyed by a hash of the
sources and flags, and is built at first use.  Never ``--use_fast_math``:
the double-f32 error-free transforms need every add and multiply rounded
as written (``-fmad=false``, IEEE division and square root); their one
FMA is an explicit ``__fmaf_rn`` (K4's f64 ones ``__fma_rn``), which
``-fmad`` does not touch.

``load(TUNE)`` builds a second library that also holds the kernels'
timing variants (``chip_kernel_tune.py``).
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

TUNE = ("-DAKBX_TUNE",)   # extra flags of the timing-variants library

_P = ctypes.c_void_p
_F = ctypes.c_float
_K1 = [_P, ctypes.c_int, _P, _P, ctypes.c_longlong] + [_P] * 9 + [_P]
_K3 = [_P, ctypes.c_longlong, _P, _P, ctypes.c_longlong, _F, _F, _P, _P]
_SIGNATURES = {
    # consts, n_mirr, dp64, dd64, n, 9 outputs, stream
    "akbx_trace_deviation": _K1,
    # consts, n_planes, 6 inputs, n, 8 outputs, stream
    "akbx_detector": [_P, ctypes.c_int] + [_P] * 6 + [ctypes.c_longlong]
    + [_P] * 8 + [_P],
    # tgt, n, src, w, m, k_hi, k_lo, out, stream
    "akbx_huygens": _K3,
    # a, b, n, hi, lo, stream
    "akbx_two_prod": [_P, _P, ctypes.c_longlong, _P, _P, _P],
    # tgt, ld, n, src, w_re, w_im, m, k, part, acc_re, acc_im, stream
    "akbx_huygens_f64": [_P, ctypes.c_longlong, ctypes.c_longlong, _P, _P,
                         _P, ctypes.c_longlong, ctypes.c_double, _P, _P, _P,
                         _P],
}
_TUNE_SIGNATURES = {
    # min_blocks, stream_stores, then K1's
    "akbx_trace_deviation_variant": [ctypes.c_int, ctypes.c_int] + _K1,
    # block, unroll, split, then K3's
    "akbx_huygens_variant": [ctypes.c_int] * 3 + _K3,
}


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash(extra_flags=()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
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


def build(extra_flags=()) -> Path:
    """Compile the kernels unless this source hash is built; returns the
    library path.  The compilers' reports (registers, spills) are kept in
    ``build.log`` beside it."""
    out_dir = BUILD_ROOT / source_hash(extra_flags)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", "-o", str(obj),
               str(src)]
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
def load(extra_flags=()) -> ctypes.CDLL:
    """Build at first use and load the kernels' library."""
    lib = ctypes.CDLL(str(build(extra_flags)))
    signatures = dict(_SIGNATURES)
    if "-DAKBX_TUNE" in extra_flags:
        signatures.update(_TUNE_SIGNATURES)
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
