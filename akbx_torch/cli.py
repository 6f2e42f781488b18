"""Command-line interface of the port (the workflows of :mod:`akbx.cli`
ported so far).

* ``trace``       — build, autofocus, trace, wavefront map, Legendre
  decomposition and PSF artifacts (``--config`` takes a TraceConfig);
* ``export-wave`` — ray->wave handoff directory: build, autofocus, trace
  with the exit-pupil re-fan, export;
* ``propagate``   — Huygens stage pipeline from a handoff directory, with
  stage caching (``--config`` takes a WaveConfig);
* ``align``       — sensitivity-matrix alignment solve;
* ``design-kb``    — KB design from the 7 parameters -> kb_design.txt;
* ``sweep-kb``     — KB design sweep over l1h: design, autofocus, trace,
  wavefront, Legendre and the artifact set of each run, then the PV-vs-NA
  fit;
* ``fab-profiles`` — machining profile CSVs of the Wolter III+I design;
* ``design-na``    — NA-constrained ellipse design.

``--system`` picks the mirror system: ``akb`` (Wolter III+I), ``kb``
(akbx's KB7 design), ``tandem`` or ``alternating`` (Wolter III+III).
akbx's ``plot`` and ``gui`` raise ``NotImplementedError``.  Each command
prints akbx's JSON summary line and runs on ``--device`` (default
``cuda``).
Run ``python -m akbx_torch.cli <cmd> --help``.
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


# akbx's KB7 design: l1h, l2h, inc_h, mlen_h, wd_v, inc_v, mlen_v
KB7_DESIGN = (146.0, 0.21, 0.16742, 0.180, 0.030, 0.15525, 0.05)


def _build_fn(args):
    from akbx_torch import io
    from akbx_torch.systems import (AlignParams, KBSpec, WOLTER_3_1_DEFAULT,
                                    WOLTER_3_3_ALT_DEFAULT,
                                    WOLTER_3_3_TANDEM_DEFAULT, build_kb,
                                    build_wolter_3_1,
                                    build_wolter_3_3_alternating,
                                    build_wolter_3_3_tandem)

    if args.params:
        params = AlignParams.from_vector(io.read_optical_params(args.params),
                                         device=args.device)
    else:
        params = AlignParams.zeros(args.device)

    if args.system == "akb":
        spec, builder = WOLTER_3_1_DEFAULT, build_wolter_3_1
    elif args.system == "tandem":
        spec, builder = WOLTER_3_3_TANDEM_DEFAULT, build_wolter_3_3_tandem
    elif args.system == "alternating":
        spec, builder = WOLTER_3_3_ALT_DEFAULT, build_wolter_3_3_alternating
    else:
        spec = KBSpec.from_kb_define(*KB7_DESIGN, device=args.device)
        builder = build_kb

    def build(p, **kw):
        return builder(spec, p, **kw)

    return build, params


def cmd_trace(args):
    from akbx_torch import align, config, io, trace, wavefront
    from akbx_torch.analysis import legendre, psf, rectify
    from akbx_torch.tooling import write_sweep_artifacts
    from akbx_torch.utils import to_numpy

    if args.config:
        cfg = config.load_config(args.config)
        if cfg.n_rays_h != cfg.n_rays_v:
            raise SystemExit("cli trace expects a square fan "
                             f"(config has {cfg.n_rays_h}x{cfg.n_rays_v})")
        args.rays = cfg.n_rays_h
        args.wavelength = cfg.energy.wavelength_m
        args.defocus_wave = cfg.defocus_for_wave
    else:
        cfg = config.TraceConfig(n_rays_h=args.rays, n_rays_v=args.rays,
                                 defocus_for_wave=args.defocus_wave)

    build, params = _build_fn(args)
    if args.autofocus:
        params = align.auto_focus(build, params, n=min(args.rays, 21), iters=5)
    sys_ = build(params)
    n = args.rays
    res = trace.run_config(sys_, cfg, defocus=params.defocus)
    mat, gy, gz = wavefront.wavefront_grid(res, n, n)
    lam_nm = args.wavelength * 1e9

    out_dir = io.run_directory(args.out, f"{args.system}_trace")
    io.write_optical_params(out_dir, params.to_vector())
    np.savetxt(os.path.join(out_dir, "matrixWave2(nm).txt"), to_numpy(mat))

    rect = rectify.extract_square_region(mat / lam_nm, n)
    np.savetxt(os.path.join(out_dir, "rectified_img.txt"), to_numpy(rect))
    fits, ips, orders = legendre.match_multi(rect[1:-2, 1:-2], 5)
    pvs = np.append(to_numpy(legendre.mode_pvs(fits, ips)),
                    float(wavefront.pv_6sigma(mat / lam_nm)))
    write_sweep_artifacts(out_dir, ips, orders, pvs, legendre.fit_sum(fits))

    out = psf.psf_from_wavefront(mat, gy, gz, args.defocus_wave,
                                 args.wavelength)
    for key, name in (("psf", "psf"), ("x_im", "psf_x"), ("y_im", "psf_y")):
        np.save(os.path.join(out_dir, f"{name}.npy"), to_numpy(out[key]))

    print(json.dumps({
        "pv_6sigma_lambda": float(pvs[-1]),
        "defocus": float(params.defocus),
        "astig_h": float(params.astig_h),
        "valid_rays": int(res.valid.sum()),
        "out_dir": out_dir,
    }))
    return 0


def cmd_align(args):
    """Sensitivity-matrix alignment solve: measure the compare_sep
    aberration vector, take its Jacobian over the chosen misalignment
    parameters (reverse mode, the f64 engine), apply the least-squares
    correction."""
    from akbx_torch import align, io, trace
    from akbx_torch.systems import AlignParams
    from akbx_torch.utils import to_numpy

    build, params = _build_fn(args)
    n = min(args.rays, 21)
    idx = [int(i) for i in args.indices.split(",")]

    def metric_fn(vec):
        sys_ = build(AlignParams.from_vector(vec))
        res = trace.run(sys_, n, n, defocus=vec[0],
                        exit_pupil_uniform=False, tilt_correction=True)
        m = align.compare_sep(res.trace, sys_.s2f_middle + vec[0], n, n)
        return align.aberration_vector(m, mode=args.mode)

    p0 = params.to_vector()
    before = metric_fn(p0)
    p1 = align.solve_alignment(metric_fn, p0, idx, iters=args.iters,
                               damping=args.damping)
    after = metric_fn(p1)
    os.makedirs(args.out, exist_ok=True)
    io.write_optical_params(args.out, p1)
    print(json.dumps({
        "indices": idx,
        "abrr_before": to_numpy(before).tolist(),
        "abrr_after": to_numpy(after).tolist(),
        "params": to_numpy(p1).tolist(),
    }))
    return 0


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
    from akbx_torch import config, io, wave
    from akbx_torch.utils import to_numpy

    if args.config:
        wcfg = config.load_config(args.config)
        args.wavelength = wcfg.wavelength_m
        args.pallas = wcfg.use_pallas
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


def cmd_design_kb(args):
    from akbx_torch import design
    from akbx_torch.tooling import write_kb_design

    kb = design.kb_define(args.l1h, args.l2h, args.inc_h, args.mlen_h,
                          args.wd_v, args.inc_v, args.mlen_v,
                          device=args.device)
    os.makedirs(args.out, exist_ok=True)
    path = write_kb_design(args.out, kb)
    print(json.dumps({"kb_design": path, "na_h": float(kb.na_h),
                      "na_v": float(kb.na_v), "gap": float(kb.gap)}))
    return 0


def cmd_sweep_kb(args):
    from akbx_torch import tooling

    values = np.linspace(args.start, args.stop, args.num)
    out = tooling.kb_design_sweep(values,
                                  (args.l2h, args.inc_h, args.mlen_h,
                                   args.wd_v, args.inc_v, args.mlen_v),
                                  args.out, n_rays=args.rays,
                                  device=args.device)
    # a 4th-order fit needs five points
    r2 = tooling.fit_pv_vs_na(out["na"], out["pv"])[1] \
        if len(values) > 4 else None
    print(json.dumps({"na": out["na"].tolist(), "pv": out["pv"].tolist(),
                      "r2": r2}))
    return 0


def mirror_centers(spec, device):
    """Axial centres of the Wolter III+I V mirrors on their canonical
    conics: the chief ray's intersection with the hyperbola, and the
    ellipse's with the ray from the hyperbola's far focus at the Wolter III
    angle theta3."""
    import torch

    from akbx_torch import design
    from akbx_torch.core import geometry as geo
    from akbx_torch.surfaces import ellipse_coeffs, hyperbola_coeffs

    def f64(x):
        return torch.as_tensor(x, dtype=torch.float64, device=device)

    def ray(theta):
        return torch.stack([torch.cos(theta), torch.zeros_like(theta),
                            torch.sin(theta)])[:, None]

    theta1 = f64(spec.theta1_v)
    c_hyp = geo.shift_x(hyperbola_coeffs(spec.a_hyp_v, spec.b_hyp_v, "xz",
                                         device=device), f64(spec.org_hyp_v))
    xc_hyp = float(geo.intersect(c_hyp, ray(theta1),
                                 f64([[0.0], [0.0], [0.0]]))[0][0, 0])
    c_ell = geo.shift_x(ellipse_coeffs(spec.a_ell_v, spec.b_ell_v, "xz",
                                       device=device),
                        f64(2 * spec.org_hyp_v + spec.org_ell_v))
    th3 = design.wolter_iii_angles(
        spec.a_hyp_v, spec.b_hyp_v, spec.org_hyp_v, spec.a_ell_v,
        spec.b_ell_v, spec.org_ell_v, theta1)[1]
    src3 = f64([[2 * spec.org_hyp_v], [0.0], [0.0]])
    xc_ell = float(geo.intersect(c_ell, ray(th3), src3)[0][0, 0])
    return {"hyp_v": xc_hyp, "ell_v": xc_ell}


def cmd_fab_profiles(args):
    from akbx_torch import fab
    from akbx_torch.systems import WOLTER_3_1_DEFAULT as spec

    os.makedirs(args.out, exist_ok=True)
    jobs = {
        "hyp_v": (lambda x: fab.hyperbola_profile(
            spec.a_hyp_v, spec.b_hyp_v, spec.org_hyp_v, x),
            spec.length_hyp_v),
        "ell_v": (lambda x: fab.ellipse_profile(
            spec.a_ell_v, spec.b_ell_v, 2 * spec.org_hyp_v + spec.org_ell_v,
            x), spec.length_ell_v),
    }
    centers = mirror_centers(spec, args.device)

    outputs = {}
    for name, (fn, length) in jobs.items():
        prof = fab.machining_profile(fn, centers[name], length, num=args.num)
        raw = fab.export_profile_csv(
            os.path.join(args.out, f"{name}_rotated_before_offset.csv"),
            prof["x_raw"], prof["y_raw"])
        merged = fab.export_profile_csv(
            os.path.join(args.out, f"{name}_rotated_0.1mmpitch.csv"),
            prof["x_merged"], prof["y_merged"], pitch_mm=0.1)
        outputs[name] = {"raw": raw, "merged": merged,
                         "rotation_deg": float(np.degrees(prof["rotation"]))}

    # the H pair: the Wolter-I combined ell+hyp max-merged profile
    w1 = fab.wolter1_combined_profile(spec.a_ell_h, spec.b_ell_h,
                                      spec.a_hyp_h, spec.b_hyp_h,
                                      spec.theta1_h, spec.length_ell_h,
                                      num=args.num)
    raw = fab.export_profile_csv(
        os.path.join(args.out, "wolter1_rotated_before_offset.csv"),
        np.concatenate([w1["x_ell"], w1["x_hyp"]]),
        np.concatenate([w1["y_ell"], w1["y_hyp"]]))
    fab.export_profile_csv(os.path.join(args.out, "wolter1_rotated.csv"),
                           w1["x_merged"], w1["y_merged"])
    merged = fab.export_profile_csv(
        os.path.join(args.out, "wolter1_rotated_0.1mmpitch.csv"),
        w1["x_merged"], w1["y_merged"], pitch_mm=0.1)
    outputs["wolter1"] = {"raw": raw, "merged": merged,
                          "rotation_deg": float(np.degrees(w1["rotation"]))}
    print(json.dumps(outputs))
    return 0


# the fields of cli design-na's JSON line, as akbx prints them
DESIGN_NA_FIELDS = ("theta_i1", "theta_i2", "theta_o1", "theta_o2", "x_1",
                    "x_2", "x_3", "l_i1", "l_i2", "l_o1", "l_o2", "a", "b2",
                    "f", "na_i_result", "check_a_error", "check_na_i_error",
                    "check_x_3_error")


def cmd_design_na(args):
    from akbx_torch import design_na

    d = design_na.solve_na_constrained(args.x1, args.x3, args.na_i,
                                       args.na_o, device=args.device)
    out = {k: float(getattr(d, k)) for k in DESIGN_NA_FIELDS}
    out["iterations"] = int(d.iterations)
    print(json.dumps(out))
    return 0


def cmd_unported(args):
    raise NotImplementedError(
        f"cli {args.cmd} is not ported yet (ROADMAP Queue 1, item 15)")


# akbx's commands that the port does not have yet
UNPORTED = ("plot", "gui")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="akbx_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in UNPORTED:
        sub.add_parser(name, help="not ported yet").set_defaults(
            fn=cmd_unported)

    p = sub.add_parser("trace", help="trace + wavefront + Legendre + PSF")
    _add_system_args(p)
    p.add_argument("--wavelength", type=float, default=13.5e-9)
    p.add_argument("--defocus-wave", type=float, default=1e-2)
    p.add_argument("--config", type=str, default=None,
                   help="TraceConfig JSON (akbx_torch.config.save_config, "
                        "or akbx's); overrides --rays/--wavelength/"
                        "--defocus-wave")
    p.set_defaults(fn=cmd_trace)

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
                   help="WaveConfig JSON (akbx_torch.config.save_config, "
                        "or akbx's)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_propagate)

    p = sub.add_parser("align", help="sensitivity-matrix alignment solve")
    _add_system_args(p)
    p.add_argument("--indices", type=str, default="2,3",
                   help="comma-separated misalignment param indices to solve")
    p.add_argument("--mode", choices=["abrr", "KB"], default="abrr")
    p.add_argument("--iters", type=int, default=1)
    p.add_argument("--damping", type=float, default=1.0)
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("design-kb", help="KB design from 7 params")
    for name, default in zip(("l1h", "l2h", "inc_h", "mlen_h", "wd_v",
                              "inc_v", "mlen_v"), KB7_DESIGN):
        p.add_argument(f"--{name.replace('_', '-')}", dest=name, type=float,
                       default=default)
    p.add_argument("--out", default=".")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_design_kb)

    p = sub.add_parser("sweep-kb", help="KB design sweep over l1h")
    p.add_argument("--start", type=float, default=145.0)
    p.add_argument("--stop", type=float, default=147.0)
    p.add_argument("--num", type=int, default=3)
    p.add_argument("--rays", type=int, default=33)
    for name, default in zip(("l2h", "inc_h", "mlen_h", "wd_v", "inc_v",
                              "mlen_v"), KB7_DESIGN[1:]):
        p.add_argument(f"--{name.replace('_', '-')}", dest=name, type=float,
                       default=default)
    p.add_argument("--out", default="sweep_out")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_sweep_kb)

    p = sub.add_parser("fab-profiles", help="machining profile CSVs")
    p.add_argument("--num", type=int, default=100000)
    p.add_argument("--out", default="fab_out")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_fab_profiles)

    p = sub.add_parser("design-na", help="NA-constrained ellipse design")
    p.add_argument("--x1", type=float, default=146.0)
    p.add_argument("--x3", type=float, default=0.55)
    p.add_argument("--na-i", dest="na_i", type=float, default=1e-4)
    p.add_argument("--na-o", dest="na_o", type=float, default=0.02)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_design_na)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
