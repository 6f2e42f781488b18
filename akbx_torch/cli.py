"""Command-line interface of the port: the wave workflow of
:mod:`akbx.cli`.

* ``export-wave`` — ray->wave handoff directory: build, autofocus, trace
  with the exit-pupil re-fan, export;
* ``propagate``   — Huygens stage pipeline from a handoff directory, with
  stage caching.

Both print akbx's JSON summary line and run on ``--device`` (default
``cuda``).  Run ``python -m akbx_torch.cli <cmd> --help``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _add_system_args(p):
    p.add_argument("--system", choices=["akb", "kb", "tandem", "alternating"],
                   default="akb")
    p.add_argument("--params", type=str, default=None,
                   help="path to optical_params.txt (26-vector); default zeros")
    p.add_argument("--rays", type=int, default=65, help="fan size per axis")
    p.add_argument("--autofocus", action="store_true", default=True)
    p.add_argument("--no-autofocus", dest="autofocus", action="store_false")
    p.add_argument("--out", type=str, default=".")
    _add_device_arg(p)


def _add_device_arg(p):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default cuda)")


def _build_fn(args):
    from akbx_torch import io
    from akbx_torch.systems import (AlignParams, WOLTER_3_1_DEFAULT,
                                    build_wolter_3_1)

    if args.system != "akb":
        raise NotImplementedError(
            f"--system {args.system}: only the Wolter III+I AKB system is "
            "ported (ROADMAP Queue 1, item 12)")
    if args.params:
        params = AlignParams.from_vector(io.read_optical_params(args.params),
                                         device=args.device)
    else:
        params = AlignParams.zeros(args.device)

    def build(p, **kw):
        return build_wolter_3_1(WOLTER_3_1_DEFAULT, p, **kw)

    return build, params


def cmd_export_wave(args):
    from akbx_torch import align, export, io, trace

    build, params = _build_fn(args)
    if args.autofocus:
        params = align.auto_focus(build, params, n=min(args.rays, 21), iters=5)
    sys_ = build(params)
    n = args.rays
    res = trace.run(sys_, n, n, defocus=params.defocus,
                    defocus_wave=args.defocus_wave)
    out_dir = io.run_directory(args.out, f"{args.system}_wave")
    export.wave_handoff(out_dir, sys_, res, n, n,
                        defocus_for_wave=args.defocus_wave)
    print(json.dumps({"out_dir": out_dir}))
    return 0


def cmd_propagate(args):
    from akbx_torch import io, wave
    from akbx_torch.utils import to_numpy

    if getattr(args, "config", None):
        raise NotImplementedError(
            "--config: akbx.config is not ported yet (ROADMAP Queue 1, "
            "item 12)")
    data = io.load_wave_data(args.data_dir)
    wavelength = args.wavelength
    cache = io.StageCache(args.out) if args.cache else None
    src = wave.point_source(tuple(np.asarray(data["source"]).ravel()),
                            device=args.device)
    stages = []
    i = 1
    while f"M{i}" in data:
        arr = data[f"M{i}"]
        stages.append({"points": arr[:3], "ds": arr[3] if arr.shape[0] > 3
                       else None, "name": f"M{i}"})
        i += 1
    if "gridImage" in data:
        stages.append({"points": data["gridImage"], "name": "Image"})
    fields = wave.propagate_stages(src, stages, wavelength, cache=cache,
                                   use_pallas=args.pallas)
    if "gridDefocus" in data:
        # the defocus grid is propagated from the last mirror, not from
        # the image grid; it is recomputed on every run and only saved
        last_mirror = fields[-2] if len(fields) >= 2 else fields[-1]
        f2 = wave.propagate_field(last_mirror, data["gridDefocus"],
                                  wavelength, use_pallas=args.pallas)
        if cache is not None:
            cache.save("Image2", f2)
    inten = to_numpy(fields[-1].intensity)
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "intensity_Image.npy"), inten)
    print(json.dumps({"stages": len(fields), "peak_intensity": float(inten.max()),
                      "out": args.out}))
    return 0


def main(argv=None):
    parser = argparse.ArgumentParser(prog="akbx_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("export-wave", help="ray->wave handoff directory")
    _add_system_args(p)
    p.add_argument("--wavelength", type=float, default=13.5e-9)
    p.add_argument("--defocus-wave", type=float, default=1e-3)
    p.set_defaults(fn=cmd_export_wave)

    p = sub.add_parser("propagate", help="Huygens stage pipeline")
    p.add_argument("data_dir")
    p.add_argument("--out", default=".")
    p.add_argument("--wavelength", type=float, default=13.5e-9)
    p.add_argument("--cache", action="store_true", default=True)
    p.add_argument("--no-cache", dest="cache", action="store_false")
    p.add_argument("--pallas", action="store_true", default=None,
                   help="force the K3 kernel (the default backend 'auto' "
                        "runs it too)")
    p.add_argument("--config", type=str, default=None,
                   help="WaveConfig JSON (not ported; raises)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_propagate)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
