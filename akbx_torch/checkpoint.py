"""Checkpoint and resume of optimization and propagation state (port of
:mod:`akbx.checkpoint`).

A training state (alignment parameters, mirror figure coefficients, the
optimizer's state, the step counter) is one ``torch.save`` file per step
in akbx's layout, ``<directory>/step_<8 digits>/state.pt``, with an
optional ``extra.json``.  The optimizer's state is ``torch.optim``'s
``state_dict()``.  Restoring reads with ``weights_only=True`` onto the
caller's device (by default the card, each rank onto its own).
akbx's orbax directories are not read: orbax imports jax.

Wave fields are npz files in akbx's own format, which either package
reads.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from akbx_torch import device_of
from akbx_torch.utils import to_numpy

STATE_FILE = "state.pt"


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}")


def _detached(tree):
    """``tree`` with every tensor detached: a checkpoint holds data, not
    autograd state."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree


def save_train_state(directory: str, step: int, params, opt_state=None,
                     extra=None) -> str:
    """Save a training state at ``directory/step_<N>``.

    ``params``: a dict of tensors (e.g. {"align": (26,), "figures":
    [...]}).  ``opt_state``: a ``torch.optim`` optimizer or its
    ``state_dict()`` (optional).  ``extra``: a small JSON-able dict (loss
    history tail, config digest).  Tensors are saved detached.  Returns
    the step's directory.
    """
    path = _step_dir(directory, step)
    os.makedirs(path, exist_ok=True)
    state = {"params": _detached(params)}
    if opt_state is not None:
        state["opt_state"] = (opt_state.state_dict()
                              if hasattr(opt_state, "state_dict")
                              else opt_state)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    if extra is not None:
        with open(os.path.join(path, "extra.json"), "w") as f:
            json.dump(extra, f)
    return path


def latest_step(directory: str):
    """Highest step with a checkpoint under ``directory`` (None if
    empty)."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", name))]
    return max(steps) if steps else None


def restore_train_state(directory: str, step: int | None = None,
                        device=None):
    """Restore ``(state, step, extra)``: ``state["params"]`` and, where
    saved, ``state["opt_state"]`` (a ``state_dict()`` for the optimizer's
    ``load_state_dict``), every tensor on ``device`` (default the card;
    ``torch.device("cuda")`` is each rank's current card) but the
    optimizer's step counters, which torch keeps on the host.  The latest
    step if ``step`` is None; ``(None, None, None)`` if there is none."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None, None, None
    path = _step_dir(directory, step)
    state = torch.load(os.path.join(path, STATE_FILE), weights_only=True,
                       map_location=device_of(None, device))
    # torch.optim keeps a step counter on the host unless the optimizer is
    # capturable or fused (whose load_state_dict moves it back)
    for per_param in state.get("opt_state", {}).get("state", {}).values():
        if isinstance(per_param.get("step"), torch.Tensor):
            per_param["step"] = per_param["step"].cpu()
    extra = None
    extra_path = os.path.join(path, "extra.json")
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    return state, step, extra


def save_wavefield(directory: str, name: str, field) -> str:
    """Save a :class:`akbx_torch.wave.WaveField` as akbx's npz (complex
    field parts + geometry)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"wavefield_{name}.npz")
    np.savez(path, points=to_numpy(field.points), re=to_numpy(field.re),
             im=to_numpy(field.im), ds=to_numpy(field.ds),
             n_h=field.n_h, n_v=field.n_v)
    return path


def load_wavefield(directory: str, name: str, device=None):
    """The :class:`akbx_torch.wave.WaveField` saved as ``name`` (by
    either package) on ``device`` (default the card), or None."""
    from akbx_torch.wave import WaveField

    path = os.path.join(directory, f"wavefield_{name}.npz")
    if not os.path.exists(path):
        return None
    dev = device_of(None, device)
    with np.load(path) as z:
        return WaveField(*[torch.tensor(z[k], dtype=torch.float64,
                                        device=dev)
                           for k in ("points", "re", "im", "ds")],
                         int(z["n_h"]), int(z["n_v"]))
