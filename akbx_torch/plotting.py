"""Diagnostic plotting (port of :mod:`akbx.plotting`; the reference's
visual-inspection layer): spot diagrams, ray side views / virtual-source
caustics, around-focus montages (static and interactive), wavefront maps,
PSF images and cuts, Legendre-mode bars and the KB design layouts.

Every function is *data -> Figure*: it takes tensors on any device or
numpy arrays (pulled to the host once, through
:func:`akbx_torch.utils.to_numpy`), returns the matplotlib Figure (saved
to ``path`` when given), never calls ``plt.show()``, and imports
matplotlib lazily.
"""

from __future__ import annotations

import numpy as np
import torch

from akbx_torch.utils import to_numpy


def _plt():
    import matplotlib

    if matplotlib.get_backend().lower() not in (
            "agg", "module://matplotlib_inline.backend_inline"):
        matplotlib.use("Agg", force=False)  # False: keep a running GUI's
    import matplotlib.pyplot as plt

    return plt


def _save(fig, path):
    if path is not None:
        fig.savefig(path, dpi=300, bbox_inches="tight")
    return fig


def spot_diagram(detpoints, valid=None, path=None, title="Focal spot",
                 unit_scale=1e9, unit="nm"):
    """Scatter of focal-plane intersections (the reference's spot
    plots)."""
    plt = _plt()
    d = to_numpy(detpoints)
    m = np.ones(d.shape[1], bool) if valid is None else to_numpy(valid)
    y = (d[1, m] - d[1, m].mean()) * unit_scale
    z = (d[2, m] - d[2, m].mean()) * unit_scale
    fig, ax = plt.subplots()
    ax.scatter(y, z, s=1)
    ax.set_xlabel(f"Horizontal ({unit})")
    ax.set_ylabel(f"Vertical ({unit})")
    ax.set_title(title)
    ax.set_aspect("equal")
    return _save(fig, path)


def ray_sideview(exit_rays, exit_points, place, defocus_size, n_h, n_v,
                 thin: int = 4, path=None):
    """Caustic / virtual-source side views: edge + center ray bundles
    projected onto two planes around ``place``.

    The reference's ``plot_ray_sideview``: red/green/yellow = first/last/center row (H pane) and column (V pane).
    """
    from akbx_torch.core import geometry as geo

    plt = _plt()
    rays = torch.as_tensor(exit_rays, dtype=torch.float64)
    pts = torch.as_tensor(exit_points, dtype=torch.float64,
                          device=rays.device)

    def plane(x):
        return geo.detector_plane(torch.as_tensor(
            x, dtype=torch.float64, device=rays.device))

    d1 = to_numpy(geo.plane_intersect(plane(place - defocus_size), rays,
                                      pts))
    d2 = to_numpy(geo.plane_intersect(plane(place + defocus_size), rays,
                                      pts))

    rows = {"r": np.arange(0, n_h, thin),
            "y": ((n_v - 1) // 2) * n_h + np.arange(0, n_h, thin),
            "g": (n_v - 1) * n_h + np.arange(0, n_h, thin)}
    cols = {"r": np.arange(0, n_v, thin) * n_h,
            "y": np.arange(0, n_v, thin) * n_h + (n_h - 1) // 2,
            "g": np.arange(0, n_v, thin) * n_h + n_h - 1}

    fig, axs = plt.subplots(2, 1, sharex=True)
    for color, idx in rows.items():
        axs[0].plot([d1[0, idx], d2[0, idx]], [d1[1, idx], d2[1, idx]],
                    color, lw=0.3)
    for color, idx in cols.items():
        axs[1].plot([d1[0, idx], d2[0, idx]], [d1[2, idx], d2[2, idx]],
                    color, lw=0.3)
    axs[0].set_ylabel("Horizontal (m)")
    axs[1].set_ylabel("Vertical (m)")
    axs[1].set_xlabel("Axial (m)")
    axs[0].set_title("Ray side view")
    return _save(fig, path)


def around_focus_montage(spots, offsets, valid=None, path=None,
                         unit_scale=1e6, unit="um"):
    """Row of spot diagrams on planes around focus.

    The III_I engine's around-focus montage in static form.  ``spots``: (n_planes, 3, N) detector points
    (e.g. ``trace.detector_points`` on each plane); ``offsets``: (n_planes,)
    axial offsets [m].
    """
    plt = _plt()
    spots = to_numpy(spots)
    n = spots.shape[0]
    m = (np.ones(spots.shape[2], bool) if valid is None
         else to_numpy(valid))
    fig, axs = plt.subplots(1, n, sharey=True, figsize=(2 * n, 2.4))
    if n == 1:
        axs = [axs]
    yc = spots[:, 1, :][:, m].mean()
    zc = spots[:, 2, :][:, m].mean()
    for i, ax in enumerate(axs):
        ax.scatter((spots[i, 1, m] - yc) * unit_scale,
                   (spots[i, 2, m] - zc) * unit_scale, s=0.5)
        ax.set_title(f"{offsets[i]:+.2e} m", fontsize=7)
        ax.set_aspect("equal")
    axs[0].set_ylabel(f"V ({unit})")
    fig.supxlabel(f"H ({unit})")
    return _save(fig, path)


def interactive_around_focus(spots_at, half_range, n_planes: int = 5,
                             valid=None, unit_scale=1e6, unit="um"):
    """Around-focus montage that re-traces when a pane is clicked.

    The III_I engine's interactive matplotlib montage: clicking a plane
    re-centers the sweep around it and re-traces.

    ``spots_at(x_offset) -> (3, N)`` detector points at axial offset
    ``x_offset`` from nominal focus (host callback; typically a jitted
    trace + plane intersection).  Each click on pane *i* re-centers the
    montage at that pane's offset and halves the span — drill-down focus
    search by eye.  Returns (fig, state) where ``state['offsets']`` is
    mutated on every click (tests drive ``state['on_click']`` directly).
    """
    plt = _plt()

    state = {"center": 0.0, "half": float(half_range)}
    fig, axs = plt.subplots(1, n_planes, sharey=True,
                            figsize=(2 * n_planes, 2.4))
    axs = list(np.atleast_1d(axs))

    def draw():
        offsets = state["center"] + np.linspace(-state["half"], state["half"],
                                                n_planes)
        state["offsets"] = offsets
        for ax, off in zip(axs, offsets):
            ax.clear()
            d = to_numpy(spots_at(float(off)))
            m = np.ones(d.shape[1], bool) if valid is None else to_numpy(valid)
            ax.scatter((d[1, m] - d[1, m].mean()) * unit_scale,
                       (d[2, m] - d[2, m].mean()) * unit_scale, s=0.5)
            ax.set_title(f"{off:+.3e} m", fontsize=7)
            ax.set_aspect("equal")
        axs[0].set_ylabel(f"V ({unit})")
        fig.canvas.draw_idle()

    def on_click(event):
        if event.inaxes in axs:
            i = axs.index(event.inaxes)
            state["center"] = float(state["offsets"][i])
            state["half"] = state["half"] / 2.0
            draw()

    draw()
    state["on_click"] = on_click
    fig.canvas.mpl_connect("button_press_event", on_click)
    return fig, state


def wavefront_map(mat_nm, grid_y=None, grid_z=None, path=None,
                  title="Wavefront error (nm)"):
    """Pseudocolor wavefront map (the reference's matrixWave2 plots)."""
    plt = _plt()
    mat = to_numpy(mat_nm)
    fig, ax = plt.subplots()
    if grid_y is not None and grid_z is not None:
        im = ax.pcolormesh(to_numpy(grid_y), to_numpy(grid_z), mat,
                           shading="auto")
    else:
        im = ax.imshow(mat, origin="lower")
    fig.colorbar(im, ax=ax, label="nm")
    ax.set_title(title)
    return _save(fig, path)


def psf_image(psf, x_im=None, y_im=None, log: bool = False, floor_db=-60.0,
              path=None, half_width=None):
    """PSF image, linear or dB (the reference's ``psf_calc`` PSF.png /
    PSF_log.png)."""
    from akbx_torch.analysis import psf as _psf

    plt = _plt()
    img = to_numpy(psf)
    x = to_numpy(x_im) if x_im is not None else np.arange(img.shape[1])
    y = to_numpy(y_im) if y_im is not None else np.arange(img.shape[0])
    if half_width is not None:
        img, x, y = _psf.trim_window(img, x, y, half_width)
    if log:
        img = to_numpy(_psf.psf_to_db(torch.as_tensor(img), floor_db))
    fig, ax = plt.subplots()
    # the image grid is uniform (lambda f fftfreq): imshow over the pixel
    # edges draws what pcolormesh(shading="auto") draws, without one quad
    # per pixel (a 4128^2 PSF renders in ~10 s as quads)
    dx = (x[-1] - x[0]) / max(len(x) - 1, 1) / 2
    dy = (y[-1] - y[0]) / max(len(y) - 1, 1) / 2
    im = ax.imshow(img, origin="lower", aspect="auto",
                   interpolation="nearest",
                   extent=(x[0] - dx, x[-1] + dx, y[0] - dy, y[-1] + dy))
    fig.colorbar(im, ax=ax, label="dB" if log else "normalized intensity")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_title("PSF" + (" (log)" if log else ""))
    return _save(fig, path)


def psf_cuts(psf, x_im, y_im, path=None):
    """Center-line PSF cuts with FWHM annotations (the reference's ``psf_calc``)."""
    from akbx_torch.analysis import psf as _psf

    plt = _plt()
    img = to_numpy(psf)
    x = to_numpy(x_im)
    y = to_numpy(y_im)
    cy, cx = np.unravel_index(np.argmax(img), img.shape)
    fig, axs = plt.subplots(1, 2, figsize=(8, 3))
    axs[0].plot(x, img[cy, :])
    axs[1].plot(y, img[:, cx])
    fw_x = float(_psf.fwhm(torch.as_tensor(x), torch.as_tensor(img[cy, :])))
    fw_y = float(_psf.fwhm(torch.as_tensor(y), torch.as_tensor(img[:, cx])))
    axs[0].set_title(f"H cut, FWHM {fw_x:.3e} m")
    axs[1].set_title(f"V cut, FWHM {fw_y:.3e} m")
    for ax in axs:
        ax.set_xlabel("position (m)")
    return _save(fig, path)


def legendre_modes(inner_products, orders, path=None):
    """Bar chart of Legendre-mode inner products (the reference's
    legendre_fit script)."""
    plt = _plt()
    ips = to_numpy(inner_products)
    labels = [f"({nx},{ny})" for nx, ny in to_numpy(orders)]
    fig, ax = plt.subplots(figsize=(max(4, 0.4 * len(ips)), 3))
    ax.bar(np.arange(len(ips)), ips)
    ax.set_xticks(np.arange(len(ips)), labels, rotation=90, fontsize=6)
    ax.set_ylabel("inner product")
    ax.set_title("Legendre aberration decomposition")
    return _save(fig, path)


def ellipse_layout(ell1, ell2, path=None):
    """Two-mirror KB layout chords + foci.

    The reference's ``plot_ellipses``.
    """
    plt = _plt()
    fig, ax = plt.subplots()
    for e, c in ((ell1, "r"), (ell2, "b")):
        ax.plot([float(e.x_1), float(e.x_1 + e.x_2)],
                [float(e.y_1), float(e.y_2)], c + "--")
        ax.plot(2 * float(e.f), 0, c + "o")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("y (m)")
    ax.set_title("Ellipses")
    return _save(fig, path)


def incident_angles(ell1, ell2, path=None):
    """Per-mirror incident-angle spans (the reference's design plots)."""
    plt = _plt()
    fig, axs = plt.subplots(1, 2, sharey=False)
    for ax, e, c, name in ((axs[0], ell1, "r", "Ell1"),
                           (axs[1], ell2, "b", "Ell2")):
        ax.plot([0, float(e.x_2)],
                [float((e.theta_i1 + e.theta_o1) / 2),
                 float((e.theta_i2 + e.theta_o2) / 2)], c + "--")
        ax.set_xlabel("distance (m)")
        ax.set_title(f"{name} incident angle")
    axs[0].set_ylabel("incident angle (rad)")
    fig.tight_layout()
    return _save(fig, path)


def design_summary_text(ell1, ell2) -> str:
    """The design metrics block printed by the reference GUI, as a
    string."""
    f = float
    lines = [
        f"Ell1 diverge angle: {f(ell1.theta_i1 - ell1.theta_i2):.6e}",
        f"Ell1 mirror length: {f(ell1.mirr_length):.6f}",
        f"Ell1 mirror angle: [{f((ell1.theta_i1 + ell1.theta_o1) / 2):.6f}, "
        f"{f((ell1.theta_i2 + ell1.theta_o2) / 2):.6f}]",
        f"Ell1 demagnification: [{f(ell1.m1):.1f}, {f(ell1.m2):.1f}]",
        f"Ell2 diverge angle: {f(ell2.theta_i1 - ell2.theta_i2):.6e}",
        f"Ell2 mirror length: {f(ell2.mirr_length):.6f}",
        f"Ell2 mirror angle: [{f((ell2.theta_i1 + ell2.theta_o1) / 2):.6f}, "
        f"{f((ell2.theta_i2 + ell2.theta_o2) / 2):.6f}]",
        f"Ell2 demagnification: [{f(ell2.m1):.1f}, {f(ell2.m2):.1f}]",
        "===========================",
        f"Ell1 aperture: {f(ell1.mirr_length * ell1.theta_centre):.6e}",
        f"Ell2 aperture: {f(ell2.mirr_length * ell2.theta_centre):.6e}",
        f"Area aperture: {f(ell1.mirr_length * ell1.theta_centre)
                          * f(ell2.mirr_length * ell2.theta_centre):.6e}",
        f"Focus distance: {f(ell1.f - ell2.f):.6e}",
    ]
    return "\n".join(lines)


def design_raytrace_plot(rt: dict, path=None):
    """Plot of :func:`akbx_torch.design_na.design_raytrace` output: the
    profile, the reflected rays and the around-focus spot columns."""
    plt = _plt()
    x = to_numpy(rt["x"])
    y = to_numpy(rt["y"])
    rvec = to_numpy(rt["rvec"])
    spots = to_numpy(rt["spots"])
    planes = to_numpy(rt["planes"])

    fig, axs = plt.subplots(1, 1 + spots.shape[0],
                            figsize=(3 + 1.2 * spots.shape[0], 3))
    axs[0].plot(x, y, "b")
    for i in range(0, x.size, max(1, x.size // 32)):
        axs[0].plot([x[i], x[i] + rvec[0, i]], [y[i], y[i] + rvec[1, i]],
                    "k", lw=0.1)
    axs[0].set_title("mirror + reflected rays")
    mid = (spots.min() + spots.max()) / 2
    for i in range(spots.shape[0]):
        ax = axs[1 + i]
        ax.scatter(np.full(spots.shape[1], planes[i] - planes[spots.shape[0] // 2]),
                   spots[i] - mid, c="r", s=1)
        ax.set_title(f"{planes[i] - planes[spots.shape[0] // 2]:+.1e}",
                     fontsize=7)
    fig.tight_layout()
    return _save(fig, path)
