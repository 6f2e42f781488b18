"""Batch analysis and sweep tooling (port of :mod:`akbx.tooling`).

* readers of sweep output: ``kb_design.txt`` / ``optical_params.txt``
  key-value files, PV-vs-NA points with a 4th-order polynomial and power
  laws with R^2, and the linear fit of each Legendre mode's inner product
  against a swept parameter (the reference's ``checkData.py`` and
  ``DataAnalysis.py``), in numpy as in akbx;
* the per-run artifact writers;
* ``kb_design_sweep``: the KB design-space sweep (design,
  autofocus, trace, wavefront, Legendre, artifacts) on the caller's
  device.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from akbx_torch.utils import to_numpy


def parse_keyvalue_file(path: str) -> dict:
    """Parse a ``key: value`` text file (kb_design.txt / optical_params.txt
    style; reference readers checkData.py:59-93, DataAnalysis.py:27-29)."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if ":" not in line:
                continue
            key, _, value = line.partition(":")
            key = key.strip()
            value = value.strip()
            try:
                out[key] = float(value)
            except ValueError:
                out[key] = value
    return out


def collect_sweep(base_dir: str, design_file: str = "kb_design.txt",
                  pv_file: str = "pvs.txt", pv_index: int = 12,
                  subdir: str = "") -> dict:
    """Collect per-run design params + PV from numerically-sorted sweep
    folders.  Parity: checkData.py main loop (:40-130).
    Returns dict of arrays keyed by design-file keys + 'pv' + 'folder'.
    """
    def numeric_key(name):
        digits = "".join(c for c in os.path.basename(name.rstrip("/"))
                         if c.isdigit() or c == ".")
        try:
            return float(digits)
        except ValueError:
            return float("inf")

    folders = sorted(
        [f for f in glob.glob(os.path.join(base_dir, "*")) if os.path.isdir(f)],
        key=numeric_key)
    rows = []
    for folder in folders:
        droot = os.path.join(folder, subdir) if subdir else folder
        dpath = os.path.join(droot, design_file)
        if not os.path.isfile(dpath):
            continue
        row = parse_keyvalue_file(dpath)
        ppath = os.path.join(droot, pv_file)
        if os.path.isfile(ppath):
            pvs = np.loadtxt(ppath)
            row["pv"] = float(pvs[pv_index]) if pvs.ndim else float(pvs)
        row["folder"] = folder
        rows.append(row)
    if not rows:
        return {}
    keys = set().union(*(r.keys() for r in rows))
    return {k: np.array([r.get(k, np.nan) for r in rows], dtype=object
                        if k == "folder" else float) for k in keys}


def fit_pv_vs_na(na, pv, order: int = 4):
    """4th-order polynomial PV-vs-NA scaling fit + R^2.

    Parity: checkData.py:142-147.
    Returns (coeffs, r2).
    """
    na = np.asarray(to_numpy(na), float)
    pv = np.asarray(to_numpy(pv), float)
    coeffs = np.polyfit(na, pv, order)
    fit = np.polyval(coeffs, na)
    ss_res = np.sum((pv - fit) ** 2)
    ss_tot = np.sum((pv - np.mean(pv)) ** 2)
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return coeffs, r2


def fit_power_law(x, y):
    """Power-law fit y = A x^p via log-log least squares + R^2 in log space
    (the reference's ``plt_func`` fit battery, checkData.py:153-241)."""
    x = np.asarray(to_numpy(x), float)
    y = np.asarray(to_numpy(y), float)
    ok = (x > 0) & (y > 0)
    lx, ly = np.log(x[ok]), np.log(y[ok])
    p, logA = np.polyfit(lx, ly, 1)
    fit = p * lx + logA
    ss_res = np.sum((ly - fit) ** 2)
    ss_tot = np.sum((ly - np.mean(ly)) ** 2)
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return float(np.exp(logA)), float(p), r2


def collect_mode_sensitivities(base_dir: str, param_number: int,
                               nx_filter: int | None = 0):
    """Linear-fit Legendre inner products against a swept parameter.

    Parity: DataAnalysis.py:10-56 — recursive glob, parse
    ``optical_params.txt`` + ``inner_products.csv`` + ``orders.csv``,
    ``polyfit(param, inner_product, 1)`` per mode (default only nx == 0
    modes, as the reference filters).
    Returns dict: orders (n,2), params (runs, n_params),
    inner_products (runs, n_modes), coeffs (modes kept, 2), kept (indices).
    """
    subfolders = glob.glob(os.path.join(base_dir, "**/"), recursive=True)
    params, ips = [], []
    orders_path = None
    for folder in subfolders:
        pf = os.path.join(folder, "optical_params.txt")
        ipf = os.path.join(folder, "inner_products.csv")
        if not (os.path.isfile(pf) and os.path.isfile(ipf)):
            continue
        with open(pf) as f:
            values = [float(line.split(":")[1].strip())
                      for line in f if ":" in line]
        params.append(values)
        ips.append(np.loadtxt(ipf, delimiter=","))
        op = os.path.join(folder, "orders.csv")
        if os.path.isfile(op):
            orders_path = op
    if not params:
        return {}
    params = np.array(params)
    ips = np.array(ips)
    orders = np.loadtxt(orders_path, delimiter=",").astype(int) \
        if orders_path else None

    coeffs, kept = [], []
    n_modes = ips.shape[1]
    for n in range(n_modes):
        if orders is not None and nx_filter is not None \
                and orders[n][1] != nx_filter:
            continue
        coeff = np.polyfit(params[:, param_number], ips[:, n], 1)
        coeffs.append(coeff)
        kept.append(n)
    return {"orders": orders, "params": params, "inner_products": ips,
            "coeffs": np.array(coeffs), "kept": np.array(kept)}


def write_sweep_artifacts(directory: str, inner_products, orders, pvs,
                          fit_sum=None):
    """Write ``inner_products.csv``, ``orders.csv``, ``pvs.txt`` and
    (given ``fit_sum``) ``fit_sum.txt`` into ``directory``, in akbx's
    formats.  Tensors on any device or array-likes."""
    os.makedirs(directory, exist_ok=True)
    np.savetxt(os.path.join(directory, "inner_products.csv"),
               to_numpy(inner_products), delimiter=",")
    np.savetxt(os.path.join(directory, "orders.csv"),
               np.asarray(orders, dtype=float), delimiter=",")
    np.savetxt(os.path.join(directory, "pvs.txt"), to_numpy(pvs))
    if fit_sum is not None:
        np.savetxt(os.path.join(directory, "fit_sum.txt"), to_numpy(fit_sum))
    return directory


def write_kb_design(directory: str, kb_design, extra: dict | None = None):
    """Write ``kb_design.txt`` (akbx's format) from a
    :class:`akbx_torch.design.KBDesign`."""
    os.makedirs(directory, exist_ok=True)
    d = kb_design
    fields = {
        "a_h": d.a_h, "b_h": d.b_h, "a_v": d.a_v, "b_v": d.b_v,
        "l1v": d.l1v, "l2v": d.l2v,
        "xh_s": d.xh_s, "xh_e": d.xh_e, "yh_s": d.yh_s, "yh_e": d.yh_e,
        "sita1h": d.theta1_h, "sita3h": d.theta3_h,
        "accept_h": d.accept_h, "NA_h": d.na_h,
        "xv_s": d.xv_s, "xv_e": d.xv_e, "yv_s": d.yv_s, "yv_e": d.yv_e,
        "sita1v": d.theta1_v, "sita3v": d.theta3_v,
        "accept_v": d.accept_v, "NA_v": d.na_v,
        "s2f_h": d.s2f_h, "gap": d.gap,
    }
    if extra:
        fields.update(extra)
    path = os.path.join(directory, "kb_design.txt")
    with open(path, "w") as f:
        for key, value in fields.items():
            f.write(f"{key}: {float(value)}\n")
    return path


def kb_design_sweep(l_i1_values, base_params, out_dir: str,
                    n_rays: int = 33, assess_order: int = 5, device=None):
    """KB design-space sweep: for each l1h value, design the KB
    (:func:`akbx_torch.design.kb_define`), autofocus at 17, trace an
    ``n_rays`` square fan on the f64 engine, take the wavefront and its
    Legendre modes at 13.5 nm, and write the artifact set into
    ``out_dir/run_<i>``.  ``base_params``: the other 6 of the KB
    7-parameters.  On ``device`` (default: the card).
    Returns a dict with 'na', 'pv' and 'folders'.
    """
    from akbx_torch import align, design, trace, wavefront
    from akbx_torch.analysis import legendre, rectify
    from akbx_torch.systems import AlignParams, KBSpec, build_kb

    na_arr, pv_arr, folders = [], [], []
    for i, l_i1 in enumerate(l_i1_values):
        params7 = (float(l_i1),) + tuple(base_params)
        kb = design.kb_define(*params7, device=device)
        spec = KBSpec.from_kb_define(*params7, device=device)

        def build(p):
            return build_kb(spec, p)

        p = align.auto_focus(build, AlignParams.zeros(device), n=17, iters=4)
        sys_ = build(p)
        res = trace.run(sys_, n_rays, n_rays, defocus=p.defocus)
        mat, _, _ = wavefront.wavefront_grid(res, n_rays, n_rays)
        lam_nm = 13.5
        rect = rectify.extract_square_region(mat / lam_nm, n_rays)
        fits, ips, orders = legendre.match_multi(rect[1:-2, 1:-2],
                                                 assess_order)
        pvs = np.append(to_numpy(legendre.mode_pvs(fits, ips)),
                        float(wavefront.pv_6sigma(mat / lam_nm)))
        run_dir = os.path.join(out_dir, f"run_{i:03d}")
        write_sweep_artifacts(run_dir, ips, orders, pvs,
                              legendre.fit_sum(fits))
        write_kb_design(run_dir, kb)
        na_arr.append(float(kb.na_h))
        pv_arr.append(float(pvs[-1]))
        folders.append(run_dir)
    return {"na": np.array(na_arr), "pv": np.array(pv_arr),
            "folders": folders}
