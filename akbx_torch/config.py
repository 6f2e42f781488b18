"""Typed run configuration (the port's own copy of :mod:`akbx.config`).

The reference selects behaviour through module-level ``option_*``
globals; here the same switches are immutable dataclasses passed
explicitly.  The JSON files of :func:`save_config` are akbx's: a file
saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import enum
import json


class Energy(str, enum.Enum):
    """Beam energy regime -> wavelength."""

    EUV = "EUV"
    SOFT_XRAY = "softXray"
    HARD_XRAY = "hardXray"

    @property
    def wavelength_m(self) -> float:
        return {
            Energy.EUV: 13.5e-9,
            Energy.SOFT_XRAY: 1.35e-9,
            Energy.HARD_XRAY: 1.35e-10,
        }[self]

    @property
    def wavelength_nm(self) -> float:
        return self.wavelength_m * 1e9


class WolterOrdering(str, enum.Enum):
    """Mirror ordering of the 4-mirror AKB system
    (:func:`akbx_torch.systems.build_system` dispatches on it)."""

    WOLTER_3_1 = "wolter_3_1"  # hyp_V -> ell_V -> ell_H -> hyp_H
    WOLTER_3_3_TANDEM = "wolter_3_3_tandem"  # hyp_V -> ell_V -> hyp_H -> ell_H
    WOLTER_3_3_ALTERNATING = "wolter_3_3_alternating"  # hyp_V -> hyp_H -> ell_V -> ell_H


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Options of a trace run: the argument surface of
    :func:`akbx_torch.trace.run` (``trace.run_config`` consumes it, and
    ``cli trace --config file.json`` drives a whole run from it)."""

    n_rays_h: int = 53
    n_rays_v: int = 53
    energy: Energy = Energy.EUV
    # Distance of the secondary ("wave"/defocused) detector plane from focus.
    defocus_for_wave: float = 1e-3
    high_na: bool = True
    # Re-trace with an exit-pupil-uniform ray fan.
    exit_pupil_uniform: bool = True
    # Remove the mean exit-beam tilt before the detector.
    tilt_correction: bool = True
    # Beam-axis estimator for the tilt removal: "mean" or "extremes".
    tilt_mode: str = "mean"
    # Source-fan sampling: "uniform" or "edge_dense" (sigmoid ramp).
    fan_mode: str = "uniform"
    # Trace arithmetic: "f64", "df32" (the double-f32 deviation trace in
    # plain torch) or "pallas" (the deviation kernels).
    precision: str = "f64"

    @property
    def n_rays(self) -> int:
        return self.n_rays_h * self.n_rays_v


@dataclasses.dataclass(frozen=True)
class WaveConfig:
    """Options of a Huygens-Fresnel propagation run."""

    wavelength_m: float = 13.5e-9
    # Tile sizes of akbx's TPU kernel; the port's K3 has its own fixed
    # tiling and reads neither, but the fields keep the files shared.
    target_tile: int = 256
    source_tile: int = 512
    use_pallas: bool = True


def _asdict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    return {k: (v.value if isinstance(v, enum.Enum) else v)
            for k, v in d.items()}


def save_config(cfg, path: str) -> None:
    """Serialize a TraceConfig/WaveConfig to JSON."""
    with open(path, "w") as fh:
        json.dump({"kind": type(cfg).__name__, **_asdict(cfg)}, fh, indent=1)


def load_config(path: str):
    """Load a config written by :func:`save_config` (kind-dispatched)."""
    with open(path) as fh:
        d = json.load(fh)
    kind = d.pop("kind", "TraceConfig")
    cls = {"TraceConfig": TraceConfig, "WaveConfig": WaveConfig}[kind]
    if cls is TraceConfig and "energy" in d:
        d["energy"] = Energy(d["energy"])
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown {kind} keys: {sorted(unknown)}")
    return cls(**d)
