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


def train_params_from_numpy(params: dict, device=None) -> dict:
    """The train step's parameter dict (:func:`akbx_torch.parallel.
    sharding.make_train_step`) from akbx's, as numpy arrays: ``align``
    (26,) and ``figures`` (a coefficient array per mirror), each a leaf
    tensor with ``requires_grad`` set."""
    return {"align": _f64(params["align"], device).requires_grad_(),
            "figures": [_f64(f, device).requires_grad_()
                        for f in params["figures"]]}


def adam_state_from_optax(optimizer: torch.optim.Adam, mu: dict, nu: dict,
                          count) -> torch.optim.Adam:
    """Load optax's Adam state (``ScaleByAdamState``'s ``mu``, ``nu`` and
    ``count``, as numpy arrays in the parameter dict's structure) into
    ``optimizer``, built on :func:`akbx_torch.parallel.sharding.
    param_list` of the parameters: ``exp_avg``, ``exp_avg_sq`` and
    ``step``.  The two updates are the same formula."""
    from akbx_torch.parallel.sharding import param_list

    params = optimizer.param_groups[0]["params"]
    for p, m, v in zip(params, param_list(mu), param_list(nu), strict=True):
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": _f64(m, p.device).reshape(p.shape),
            "exp_avg_sq": _f64(v, p.device).reshape(p.shape)}
    return optimizer
