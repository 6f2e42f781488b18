"""Carry state across from :mod:`akbx`: its parameters, given as numpy
arrays or plain values, become the port's tensors, on ``device`` or, by
default, on the card (:func:`akbx_torch.default_device`).

The caller flattens the JAX objects on its side (``np.asarray`` on each
array, ``dataclasses.asdict`` on a spec); this module never sees jax.
"""

from __future__ import annotations

import numpy as np
import torch

from akbx_torch import device_of
from akbx_torch.surfaces import Mirror
from akbx_torch.systems import AKBSpec, AlignParams, KBSpec, OpticalSystem
from akbx_torch.wave import WaveField


def _f64(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float64),
                        device=device_of(None, device))


def align_params_from_numpy(vec26, device=None) -> AlignParams:
    """The 26-vector of misalignments as :class:`AlignParams`."""
    vec = np.asarray(vec26, dtype=np.float64)
    if vec.shape != (26,):
        raise ValueError(f"want a (26,) vector, got {vec.shape}")
    return AlignParams.from_vector(_f64(vec, device))


def spec_from_akbx(spec_fields: dict) -> AKBSpec:
    """An :class:`AKBSpec` from ``dataclasses.asdict`` of akbx's spec."""
    return AKBSpec(**{k: float(v) for k, v in spec_fields.items()})


def kb_spec_from_akbx(spec_fields: dict) -> KBSpec:
    """A :class:`KBSpec` from ``dataclasses.asdict`` of akbx's KB spec."""
    return KBSpec(**{k: float(v) for k, v in spec_fields.items()})


def system_from_numpy(fields: dict, device=None) -> OpticalSystem:
    """A placed :class:`OpticalSystem` from numpy fields: ``mirrors`` (a
    list of dicts with the :class:`Mirror` field names, the figure state
    ``fig_coeffs``, ``uv_center``, ``uv_half`` and calibrated ``axes``
    among them), ``s2f_middle``, ``fan_h``, ``fan_v``, ``source`` and
    ``valid``."""
    mirrors = tuple(Mirror(**{k: _f64(m[k], device) for k in Mirror._fields})
                    for m in fields["mirrors"])
    return OpticalSystem(
        mirrors, _f64(fields["s2f_middle"], device),
        _f64(fields["fan_h"], device), _f64(fields["fan_v"], device),
        _f64(fields["source"], device),
        torch.tensor(np.asarray(fields["valid"], dtype=bool),
                     device=device_of(None, device)))


def wave_field_from_numpy(fields: dict, device=None) -> WaveField:
    """A :class:`WaveField` from akbx's, as numpy arrays: ``points``,
    ``re``, ``im``, ``ds`` and the ints ``n_h``, ``n_v``."""
    return WaveField(*[_f64(fields[k], device)
                       for k in ("points", "re", "im", "ds")],
                     int(fields.get("n_h", 0)), int(fields.get("n_v", 0)))
