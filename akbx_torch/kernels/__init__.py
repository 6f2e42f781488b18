"""Hand-written CUDA kernels of the port, each beside its PyTorch twin,
and what their wrappers share."""

import ctypes

import torch

F32 = torch.float32
F64 = torch.float64


def split64(x64: torch.Tensor):
    """Exact split of f64 values into f32 (hi, lo) pairs."""
    hi = x64.to(F32)
    lo = (x64 - hi.to(F64)).to(F32)
    return hi, lo


def check(t: torch.Tensor, dtype, shape, name: str):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor):
    """PyTorch's current stream on ``t``'s card, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
