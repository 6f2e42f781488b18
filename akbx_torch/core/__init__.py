"""Core numerics of the port, and the one device-dispatch rule."""

import torch


def use_kernel(*tensors: torch.Tensor) -> bool:
    """The dispatch rule of every kernel wrapper in the port.

    False for CPU tensors (the wrapper runs the plain PyTorch twin), True
    for CUDA tensors (the wrapper launches the kernel, or raises).  Any
    other device, or tensors on different devices, raise.
    """
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel or twin for device {dev}")
