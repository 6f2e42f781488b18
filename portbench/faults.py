"""Faults planted in the program, beneath the timed path, that the check
of ``correct`` has to catch.  The CPU tests plant them in a tiny run;
``control.py --faults`` reads them on the card at the cell's own size.

Each fault wraps one function of ``akbx_torch``: ``planted(name,
config)`` swaps the wrapper in for the time of a ``with`` block."""

from __future__ import annotations

import contextlib
import importlib

import torch

# the image's half-size on the focal plane (``traffic/wave-257.json``)
MOVE_M = 1e-6
# one wavelength of the EUV configuration (``configs/wolter31-euv.json``)
OPL_M = 13.5e-9


def half_rays(run):
    """Half of the fan left out: the loss and its mean over the rest."""
    def broken(*args, **kw):
        res = run(*args, **kw)
        keep = torch.arange(res.valid.shape[0]) < res.valid.shape[0] // 2
        return res._replace(valid=res.valid & keep.to(res.valid.device))
    return broken


def moved_point(run):
    """An answer altered where it is produced: one focal-plane point moved
    by the image's half-size."""
    def broken(*args, **kw):
        res = run(*args, **kw)
        det = res.detcenter.clone()
        det[1, 0] += MOVE_M
        return res._replace(detcenter=det)
    return broken


def moved_deviation(run):
    """An answer altered where it is produced: one ray's deviation from
    the chief on the detector moved by the image's half-size."""
    def broken(*args, **kw):
        res = run(*args, **kw)
        ddet = res.ddet32.clone()
        ddet[1, 0] += MOVE_M
        return res._replace(ddet32=ddet)
    return broken


def moved_opl(run):
    """An answer altered where it is produced: one ray's optical path
    moved by a wavelength."""
    def broken(*args, **kw):
        res = run(*args, **kw)
        w = res.w32.clone()
        w[0] += OPL_M
        return res._replace(w32=w)
    return broken


class _TwiceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return 2 * g


def build_bwd_x2(build):
    """The build's backward scaled by 2: every gradient that reaches the
    placed mirrors' tensors goes back through the placement doubled."""
    def broken(*args, **kw):
        system = build(*args, **kw)
        mirrors = tuple(type(m)(*(_TwiceGrad.apply(x) if x.requires_grad
                                  else x for x in m))
                        for m in system.mirrors)
        return system._replace(mirrors=mirrors)
    return broken


def half_targets(propagate):
    """Half of a stage's targets left out."""
    def broken(source, targets, *args, **kw):
        re, im = propagate(source, targets, *args, **kw)
        half = re.shape[0] // 2
        return (torch.cat([re[:half], torch.zeros_like(re[half:])]),
                torch.cat([im[:half], torch.zeros_like(im[half:])]))
    return broken


def moved_value(propagate):
    """An answer altered where it is produced: every fourth target's
    field, so that the check's sample of targets meets it."""
    def broken(source, targets, *args, **kw):
        re, im = propagate(source, targets, *args, **kw)
        re = re.clone()
        re[::4] += 0.1 * torch.sqrt(re**2 + im**2).max()
        return re, im
    return broken


# name: (module of akbx_torch, function (None: the configuration's system
# builder), wrapper)
FAULTS = {"half_rays": ("trace", "run", half_rays),
          "moved_point": ("trace", "run", moved_point),
          "moved_deviation": ("trace", "run", moved_deviation),
          "moved_opl": ("trace", "run", moved_opl),
          "build_bwd_x2": ("systems", None, build_bwd_x2),
          "half_targets": ("wave", "propagate", half_targets),
          "moved_value": ("wave", "propagate", moved_value)}


@contextlib.contextmanager
def planted(name: str, config: dict):
    module, attr, wrap = FAULTS[name]
    mod = importlib.import_module("akbx_torch." + module)
    attr = attr or config["system"]["builder"]
    sound = getattr(mod, attr)
    setattr(mod, attr, wrap(sound))
    try:
        yield
    finally:
        setattr(mod, attr, sound)
