"""Batched sequential ray tracing through a mirror chain (port of
:mod:`akbx.trace`: the f64 engine, the ``precision="df32"`` deviation
engine and the ``precision="pallas"`` fast engine, each with and without
the exit-pupil re-fan).

Rays are ``(3, N)`` f64 tensors; invalid rays carry a boolean mask.  The
fast engine traces one chief ray in f64 and every other ray as its exact
deviation from the chief in double-f32, on the kernels K1 (bounce chain)
and K2 (detector planes / OPL) of :mod:`akbx_torch.kernels.trace_kernel`;
between them, the tilt-removal angles are a masked mean over all rays.
Its backward is the autograd of a plain twin of the same deviation
algebra (:func:`_dev32_scan`, :func:`_fast_devs_f32`) in float64:
the double-word error terms have near-zero
derivatives, so the twin's Jacobian is the engine's.  akbx's twin runs
in float32, whose rounding leaves gradient components below ~1e-3 of the
largest off by up to tens of percent on the KB and Wolter III+III
systems (ROADMAP F6); the card has float64.  The backward launches no
kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from akbx_torch import spans
from akbx_torch.core import geometry as geo
from akbx_torch.core import geometry_df as gdf
from akbx_torch.core import precision as pr
from akbx_torch.core.precision import (DF, df_add, df_div, df_mul, df_mul_f,
                                       df_sqrt, df_sub)
from akbx_torch.kernels import trace_kernel as tk
from akbx_torch.parallel import sharding as sh
from akbx_torch.surfaces import Mirror, has_figure, intersect_and_reflect
from akbx_torch.systems import OpticalSystem
from akbx_torch.utils import linspace, non_uniform_distribution

F32 = torch.float32
F64 = torch.float64


def masked_mean(x, valid, dim=None, mesh=None):
    """Mean of ``x`` over the ``valid`` rays (along ``dim``, or all);
    with a ray-sharded ``mesh`` (:mod:`akbx_torch.parallel.sharding`) the
    numerator and the count are each summed over the ranks first."""
    w = valid.to(x.dtype)
    if dim is None:
        num, den = torch.sum(x * w), torch.sum(w)
    else:
        num, den = torch.sum(x * w, dim=dim), torch.sum(w, dim=dim)
    return sh.all_sum(num, mesh) / torch.clamp_min(sh.all_sum(den, mesh),
                                                   1.0)


def ray_fan(angles_h: torch.Tensor, angles_v: torch.Tensor, lo: int = 0,
            hi: int | None = None) -> torch.Tensor:
    """Direction fan (3, nV*nH), row-major with the vertical angle varying
    slowly: ``idx = iV * nH + iH``; or its columns ``lo:hi``, bit for bit
    those of the whole fan (the tangents are taken on the whole angle
    vectors: the grazing trace amplifies a 1-ulp difference ~1e8)."""
    n_h = angles_h.shape[0]
    hi = n_h * angles_v.shape[0] if hi is None else hi
    idx = torch.arange(lo, hi, device=angles_h.device)
    th = torch.tan(angles_h)[idx % n_h]
    tv = torch.tan(angles_v)[idx // n_h]
    return geo.normalize(torch.stack([torch.ones_like(th), th, tv]))


def fan_angles(fan: torch.Tensor, n: int, mode: str = "uniform"):
    """``n`` source angles across ``fan = (lo, hi)``: equally spaced
    (``mode="uniform"``, :func:`akbx_torch.utils.linspace`), or the
    reference's sigmoid-ramped sampling dense at the aperture edges
    (``mode="edge_dense"``)."""
    if mode == "edge_dense":
        return non_uniform_distribution(fan[0], fan[1], n)
    return linspace(fan[0], fan[1], n)


class TraceResult(NamedTuple):
    points: tuple  # per-mirror surface points (3, N)
    directions: tuple  # incoming dir + per-mirror reflected dirs (3, N)
    normals: tuple  # per-mirror unit normals (3, N)
    segments: tuple  # per-leg path lengths (N,)
    valid: torch.Tensor  # (N,) bool

    @property
    def exit_rays(self):
        return self.directions[-1]

    @property
    def exit_points(self):
        return self.points[-1]


class LazyTraceResult:
    """A :class:`TraceResult` materialized in f64 on first access.

    The fast engine's f64 points, directions, normals and segments are
    ~1.3 GB at a 2048x2048 fan; most callers read only the deviation
    fields, so they are built only when an attribute is read.
    """

    def __init__(self, build):
        self._build = build
        self._result = None

    def materialize(self) -> TraceResult:
        if self._result is None:
            self._result = self._build()
            self._build = None
        return self._result

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.materialize(), name)


def trace(system: OpticalSystem, rays: torch.Tensor,
          origins: torch.Tensor) -> TraceResult:
    """Sequential intersect->reflect through all mirrors, in f64."""
    points, dirs, normals, segs = [], [rays], [], []
    valid = torch.ones(rays.shape[1], dtype=torch.bool, device=rays.device)
    p, d = origins, rays
    for mirror in system.mirrors:
        pts, refl, n, seg, ok = intersect_and_reflect(mirror, d, p)
        valid = valid & ok
        points.append(pts)
        dirs.append(refl)
        normals.append(n)
        segs.append(seg)
        p, d = pts, refl
    return TraceResult(tuple(points), tuple(dirs), tuple(normals),
                       tuple(segs), valid)


def _deviation_constants(system: OpticalSystem, P, D, T, chief_p0):
    """Stacked per-mirror f64 chief constants of the deviation trace
    (:class:`akbx_torch.kernels.trace_kernel.ChiefConsts`)."""
    Ps = torch.stack(P)                             # (nm, 3)
    coeffs_l = geo.shift(torch.stack([m.coeffs for m in system.mirrors]),
                         -Ps)
    Ms = geo.quadric_matrix(coeffs_l)[:, :3, :3]    # (nm, 3, 3)
    bvecs = coeffs_l[:, 6:9]
    Ds = torch.stack(D[:-1])                        # (nm, 3) incoming
    Dns = torch.stack(D[1:])                        # (nm, 3) outgoing
    Ts = torch.stack(T)                             # (nm,)
    prev_pts = torch.cat([chief_p0[:, 0][None], Ps[:-1]], dim=0)
    p_noms = prev_pts - Ps                          # (nm, 3)

    def quad(a, b):
        return torch.einsum("mi,mij,mj->m", a, Ms, b)

    def dot(a, b):
        return torch.einsum("mi,mi->m", a, b)

    A_noms = quad(Ds, Ds)
    B_noms = 2.0 * quad(p_noms, Ds) + dot(bvecs, Ds)
    C_noms = quad(p_noms, p_noms) + dot(bvecs, p_noms) + coeffs_l[:, 9]
    gCs = 2.0 * torch.einsum("mij,mj->mi", Ms, p_noms) + bvecs
    gAs = 2.0 * torch.einsum("mij,mj->mi", Ms, Ds)
    rhos = (A_noms * Ts + B_noms) * Ts + C_noms     # chief residuals (~0)
    Bp_noms = 2.0 * A_noms * Ts + B_noms
    branches = torch.stack([m.branch for m in system.mirrors])
    return tk.ChiefConsts(Ms, bvecs, Ds, Dns, Ts, A_noms, Bp_noms, rhos, gCs,
                          gAs, branches, Ps)


@spans.spanned("trace.chief")
def _fast_scalars(system, rays, origins, chief_idx):
    """Chief trace + deviation constants."""
    chief_d0 = rays[:, chief_idx:chief_idx + 1]
    chief_p0 = origins[:, chief_idx:chief_idx + 1]
    chief = trace(system, chief_d0, chief_p0)
    P = [p[:, 0] for p in chief.points]
    D = [d[:, 0] for d in chief.directions]
    T = [s[0] for s in chief.segments]
    consts64 = _deviation_constants(system, P, D, T, chief_p0)
    return chief_d0, chief_p0, consts64


def _where_df(cond, a: DF, b: DF) -> DF:
    return DF(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))


def _df_bounce(consts, m: int, dp: gdf.Vec3DF, dd: gdf.Vec3DF):
    """One bounce of :func:`trace_df`: the deviation of the intersection
    (dq), of the reflected direction (dd'), the unit normal and the leg
    length deviation (dt) in double-f32, and the rays' validity."""
    shape = dp.x.hi.shape
    M9 = gdf.mat3_const(consts.M[m])
    gC_c = gdf.vec3_const(consts.gC[m], shape)
    gA_c = gdf.vec3_const(consts.gA[m], shape)
    D_c = gdf.vec3_const(consts.D[m], shape)
    Dn_c = gdf.vec3_const(consts.Dn[m], shape)
    nn_c = gdf.vec3_const(consts.bvec[m], shape)    # gradQ(0) = bvec
    T_c = gdf.df_bcast(gdf.split_f64(consts.T[m]), shape)
    T2_c = gdf.df_bcast(gdf.split_f64(consts.T[m] * consts.T[m]), shape)
    A_c = gdf.df_bcast(gdf.split_f64(consts.A[m]), shape)
    Bp_c = gdf.df_bcast(gdf.split_f64(consts.Bp[m]), shape)
    rho_c = gdf.df_bcast(gdf.split_f64(consts.rho[m]), shape)

    # per-ray deviation forms (every operand small or O(1))
    Mdp = gdf.matvec(M9, dp)
    Mdd = gdf.matvec(M9, dd)
    dC = df_add(gC_c.dot(dp), Mdp.dot(dp))
    dA = df_add(gA_c.dot(dd), Mdd.dot(dd))
    dB = df_add(df_add(gC_c.dot(dd), gA_c.dot(dp)),
                df_mul_f(Mdp.dot(dd), 2.0))

    # R = A T^2 + B T + C - (chief part) = dA T^2 + dB T + dC + rho
    R = df_add(df_add(df_mul(dA, T2_c), df_mul(dB, T_c)), df_add(dC, rho_c))
    A_full = df_add(dA, A_c)
    Bp = df_add(df_add(df_mul_f(df_mul(dA, T_c), 2.0), dB), Bp_c)

    # roots of A dt^2 + B' dt + R = 0, stable q-form; the shift t = T +
    # dt leaves the discriminant invariant, so the chief's branch flag
    # selects the same sheet
    disc = df_sub(df_mul(Bp, Bp), df_mul_f(df_mul(A_full, R), 4.0))
    ok = disc.hi > 0
    zero = torch.zeros_like(disc.hi)
    sq = df_sqrt(DF(torch.where(ok, disc.hi, zero),
                    torch.where(ok, disc.lo, zero)))
    b_pos = Bp.hi >= 0
    sgn = torch.where(b_pos, 1.0, -1.0).to(F32)
    qq = df_mul_f(df_add(Bp, df_mul_f(sq, sgn)), -0.5)
    safe_q = DF(torch.where(qq.hi != 0, qq.hi, 1.0), qq.lo)
    safe_A = DF(torch.where(A_full.hi != 0, A_full.hi, 1.0), A_full.lo)
    t_q_over_A = df_div(qq, safe_A)
    t_R_over_q = df_div(R, safe_q)
    t_plus = _where_df(b_pos, t_R_over_q, t_q_over_A)
    t_minus = _where_df(b_pos, t_q_over_A, t_R_over_q)
    dt = _where_df(consts.branch[m] >= 0, t_plus, t_minus)

    # intersection deviation: dq = dp + T dd + dt (D + dd)
    d_full = gdf.Vec3DF(df_add(dd.x, D_c.x), df_add(dd.y, D_c.y),
                        df_add(dd.z, D_c.z))
    dq = dp.add(dd.scale(T_c)).add(d_full.scale(dt))

    # normal: gradQ(dq) = bvec + 2 M dq, normalized in df32
    Mdq = gdf.matvec(M9, dq)
    n_unit = gdf.Vec3DF(df_add(df_mul_f(Mdq.x, 2.0), nn_c.x),
                        df_add(df_mul_f(Mdq.y, 2.0), nn_c.y),
                        df_add(df_mul_f(Mdq.z, 2.0), nn_c.z)).normalize()

    # reflect the full direction; deviation from the chief's reflected
    refl = gdf.reflect_df(d_full, n_unit)
    dd_new = gdf.Vec3DF(df_sub(refl.x, Dn_c.x), df_sub(refl.y, Dn_c.y),
                        df_sub(refl.z, Dn_c.z))
    return dq, dd_new, n_unit, dt, ok


def trace_df(system: OpticalSystem, rays: torch.Tensor,
             origins: torch.Tensor, chief_idx: int | None = None
             ) -> TraceResult:
    """The sequential trace as an exact deviation from an f64 chief ray,
    in double-f32 tensor ops: akbx's third engine.

    One chief ray is traced in f64 and every other ray is its deviation
    (dp, dd) from the chief.  Quadrics are degree-2 polynomials, so the
    deviation update is exact algebra, not a linearization:

      C  = C_nom + gC.dp + dp^T M dp          gC = gradQ(p_nom)
      B  = B_nom + gC.dd + gA.dp + 2 dp^T M dd    gA = 2 M D
      A  = A_nom + gA.dd + dd^T M dd
      dt : A dt^2 + (2 A T + B) dt + (A T^2 + B T + C) = 0   (small root)

    with every ``*_nom``, T, D, M a per-mirror f64 chief constant and every
    per-ray quantity small, so the double-f32 words resolve ~1e-15 m leg
    deviations.  The branch is the chief's.  It is K1's algebra in plain
    PyTorch (no kernel), differentiable under autograd.  ``chief_idx``:
    fan index of the chief ray (default: the batch center).  Outputs are
    f64; the contract of :func:`trace`.
    """
    n_rays = rays.shape[1]
    if chief_idx is None:
        chief_idx = n_rays // 2
    chief_d0, chief_p0, consts = _fast_scalars(system, rays, origins,
                                               chief_idx)
    Ps, Dns, Ts = consts.P, consts.Dn, consts.T
    # per-ray deviations: exact f64 subtraction, then split to f32 pairs
    dd = gdf.Vec3DF.from_f64(rays - chief_d0)
    dp = gdf.Vec3DF.from_f64(origins - chief_p0)
    valid = torch.ones(n_rays, dtype=torch.bool, device=rays.device)
    points, dirs, normals, segs = [], [rays], [], []
    for m in range(len(system.mirrors)):
        dq, dd, n_unit, dt, ok = _df_bounce(consts, m, dp, dd)
        valid = valid & ok
        points.append(Ps[m][:, None] + dq.to_f64())
        dirs.append(Dns[m][:, None] + dd.to_f64())
        normals.append(n_unit.to_f64())
        segs.append(Ts[m] + gdf.df_to_f64(dt))
        dp = dq   # frames hop through the chief constants
    return TraceResult(tuple(points), tuple(dirs), tuple(normals),
                       tuple(segs), valid)


# --- the plain twin (the fast engine's backward) --------------------------
# The 3x3 products are broadcasts and sums, never matmuls, so that in
# float32 they stay true float32 whatever
# torch.backends.cuda.matmul.allow_tf32 says.

def _mv(M, v):
    """(3, 3) @ (3, N)."""
    return M[:, 0:1] * v[0] + M[:, 1:2] * v[1] + M[:, 2:3] * v[2]


def _dot(c, v):
    """(3,) . (3, N) -> (N,)."""
    return c[0] * v[0] + c[1] * v[1] + c[2] * v[2]


def _dev32_scan(c, dp0, dd0):
    """The deviation bounce chain in the plain arithmetic of the inputs'
    dtype, one op for each double-word op of K1.  Returns per-mirror lists (dqs, dds, normals, dts) and the
    validity mask.  ``c``: the chief constants in that dtype."""
    dp, dd = dp0, dd0
    valid = torch.ones(dp0.shape[1], dtype=torch.bool, device=dp0.device)
    dqs, dds, normals, dts = [], [], [], []
    for m in range(c.M.shape[0]):
        M, Ti = c.M[m], c.T[m]
        Mdp = _mv(M, dp)
        Mdd = _mv(M, dd)
        dC = _dot(c.gC[m], dp) + torch.sum(Mdp * dp, dim=0)
        dA = _dot(c.gA[m], dd) + torch.sum(Mdd * dd, dim=0)
        dB = (_dot(c.gC[m], dd) + _dot(c.gA[m], dp)
              + 2.0 * torch.sum(Mdp * dd, dim=0))
        R = (dA * Ti + dB) * Ti + dC + c.rho[m]
        A_full = dA + c.A[m]
        Bp = 2.0 * dA * Ti + dB + c.Bp[m]
        disc = Bp * Bp - 4.0 * A_full * R
        ok = disc > 0
        sq = torch.sqrt(torch.where(ok, disc, 0.0))
        b_pos = Bp >= 0
        sgn = torch.where(b_pos, 1.0, -1.0).to(Bp.dtype)
        qq = -0.5 * (Bp + sgn * sq)
        safe_q = torch.where(qq != 0, qq, 1.0)
        safe_A = torch.where(A_full != 0, A_full, 1.0)
        t_plus = torch.where(b_pos, R / safe_q, qq / safe_A)
        t_minus = torch.where(b_pos, qq / safe_A, R / safe_q)
        dt = torch.where(c.branch[m] >= 0, t_plus, t_minus)
        valid = valid & ok

        d_full = dd + c.D[m][:, None]
        dq = dp + Ti * dd + dt * d_full
        nvec = c.bvec[m][:, None] + 2.0 * _mv(M, dq)
        n_unit = nvec / torch.sqrt(torch.sum(nvec * nvec, dim=0,
                                             keepdim=True))
        refl = d_full - 2.0 * torch.sum(d_full * n_unit, dim=0) * n_unit
        dd = refl - c.Dn[m][:, None]
        dp = dq
        dqs.append(dq)
        dds.append(dd)
        normals.append(n_unit)
        dts.append(dt)
    return dqs, dds, normals, dts, valid


def _dev32_trace(system, rays, origins, chief_idx: int, dtype=F32):
    """f64 chief constants and the deviation chain of every ray in plain
    ``dtype``: ``(consts64, (dqs, dds, normals, dts, valid))``."""
    chief_d0, chief_p0, consts64 = _fast_scalars(system, rays, origins,
                                                 chief_idx)
    consts = tk.ChiefConsts(*(c.to(dtype) for c in consts64))
    return consts64, _dev32_scan(consts, (origins - chief_p0).to(dtype),
                                 (rays - chief_d0).to(dtype))


def trace_dev32(system: OpticalSystem, rays: torch.Tensor,
                origins: torch.Tensor, chief_idx: int | None = None,
                dtype=F32) -> TraceResult:
    """The deviation trace in plain single ``dtype`` arithmetic (f32 by
    default, akbx's): the algebra of K1 with every double-word op replaced
    by one plain op.  In f32 its values are only f32-grade, but its
    Jacobian equals the f64 engine's to f32 rounding; the fast engine's
    backward differentiates it in float64.  Same contract as
    :func:`trace`."""
    if chief_idx is None:
        chief_idx = rays.shape[1] // 2
    consts64, (dqs, dds, normals, dts, valid) = _dev32_trace(
        system, rays, origins, chief_idx, dtype)
    Ps, Dns, Ts = consts64.P, consts64.Dn, consts64.T
    n_mirr = Ps.shape[0]
    return TraceResult(
        tuple(Ps[i][:, None] + dqs[i].to(F64) for i in range(n_mirr)),
        (rays,) + tuple(Dns[i][:, None] + dds[i].to(F64)
                        for i in range(n_mirr)),
        tuple(n.to(F64) for n in normals),
        tuple(Ts[i] + dts[i].to(F64) for i in range(n_mirr)), valid)


def _tensors_of(system: OpticalSystem) -> list:
    """The mirrors' tensors, in order: the differentiable inputs of the
    fast engine's autograd nodes."""
    return [t for m in system.mirrors for t in m]


class _TwinVJP(torch.autograd.Function):
    """The kernels forward, the VJP of their plain twin backward.

    A subclass's ``forward(ctx, static, *tensors)`` runs the kernels and
    returns through :meth:`keep`; ``static`` holds the system and the
    other non-tensor arguments, ``tensors`` the differentiable ones with
    the system's own tensors (:func:`_tensors_of`) last.  The backward
    rebuilds the system on detached copies of those tensors, runs the
    twin under autograd at the same inputs and returns the VJP of the
    outputs that received a cotangent.  It launches no kernel."""

    @staticmethod
    def keep(ctx, twin, static, tensors, outs):
        ctx.twin, ctx.static = twin, static
        ctx.save_for_backward(*tensors)
        ctx.mark_non_differentiable(
            *[o for o in outs if not o.is_floating_point()])
        # the twin's lo words are constants and most outputs go unused:
        # their cotangents stay None instead of tensors of zeros
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    @spans.spanned("twin.backward")
    def backward(ctx, *grads):
        system = ctx.static[0]
        with spans.span("twin.rebuild"), torch.enable_grad():
            args = [t.detach().requires_grad_(need) for t, need in
                    zip(ctx.saved_tensors, ctx.needs_input_grad[1:])]
            k = len(Mirror._fields)
            sys_t = args[len(args) - k * len(system.mirrors):]
            mirrors = tuple(Mirror(*sys_t[i:i + k])
                            for i in range(0, len(sys_t), k))
            outs = ctx.twin(system._replace(mirrors=mirrors),
                            *args[:len(args) - len(sys_t)], *ctx.static[1:])
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o is not None and o.requires_grad]
        wrt = [a for a in args if a.requires_grad]
        got = [None] * len(wrt)
        if pairs and wrt:
            with spans.span("twin.vjp"):
                got = torch.autograd.grad([o for o, _ in pairs], wrt,
                                          [g for _, g in pairs],
                                          allow_unused=True)
        got = iter(got)
        return (None, *[next(got) if a.requires_grad else None
                        for a in args])


def _k1(system, rays, origins, chief_idx: int):
    """f64 chief constants and K1 on every ray: ``(consts64, K1's
    outputs)`` (:func:`akbx_torch.kernels.trace_kernel.trace_deviation`)."""
    chief_d0, chief_p0, consts64 = _fast_scalars(system, rays, origins,
                                                 chief_idx)
    with spans.span("trace.k1"):
        consts = tk.pack_consts(consts64)
        return consts64, tk.trace_deviation(consts, origins - chief_p0,
                                            rays - chief_d0,
                                            consts64.P.shape[0])


def _trace_pallas_forward(system, rays, origins, chief_idx: int):
    """K1 on the whole fan: (dq_hi, dq_lo, od_hi, od_lo, dt_hi, dt_lo,
    valid, P_chief, D_chief, T_chief)."""
    consts64, out = _k1(system, rays, origins, chief_idx)
    return (*out[:6], out[8][0] > 0.5, consts64.P, consts64.Dn, consts64.T)


def _trace_pallas_f32(system, rays, origins, chief_idx: int):
    """Plain float64 twin of :func:`_trace_pallas_forward` (lo words
    None)."""
    consts64, (dqs, dds, _, dts, valid) = _dev32_trace(
        system, rays, origins, chief_idx, F64)
    return (torch.cat(dqs), None, torch.cat(dds), None, torch.stack(dts),
            None, valid, consts64.P, consts64.Dn, consts64.T)


class _TracePallas(_TwinVJP):
    @staticmethod
    def forward(ctx, static, rays, origins, *system_tensors):
        system, chief_idx = static
        return _TwinVJP.keep(ctx, _trace_pallas_f32, static,
                             (rays, origins, *system_tensors),
                             _trace_pallas_forward(system, rays, origins,
                                                   chief_idx))


def _materialize(system, rays, Ps, Dns, Ts, dq_hi, dq_lo, od_hi, od_lo,
                 dt_hi, dt_lo, valid) -> TraceResult:
    """The f64 :class:`TraceResult` of deviation outputs: each chief value
    plus its ray's deviation; normals in f64 from the placed quadrics."""
    points, dirs, normals, segs = [], [rays], [], []
    for m in range(Ps.shape[0]):
        rows = slice(3 * m, 3 * m + 3)
        pts = Ps[m][:, None] + _f64_of(dq_hi[rows], dq_lo[rows])
        points.append(pts)
        dirs.append(Dns[m][:, None] + _f64_of(od_hi[rows], od_lo[rows]))
        normals.append(geo.surface_normal(system.mirrors[m].coeffs, pts))
        segs.append(Ts[m] + _f64_of(dt_hi[m], dt_lo[m]))
    return TraceResult(tuple(points), tuple(dirs), tuple(normals),
                       tuple(segs), valid)


def trace_pallas(system: OpticalSystem, rays: torch.Tensor,
                 origins: torch.Tensor, chief_idx: int | None = None
                 ) -> LazyTraceResult:
    """The fast trace: K1 forward, the VJP of the plain twin of its
    deviation chain (:func:`_trace_pallas_f32`) backward.  Same contract as :func:`trace`, its f64
    fields materialized on first access."""
    if chief_idx is None:
        chief_idx = rays.shape[1] // 2
    out = _TracePallas.apply((system, int(chief_idx)), rays, origins,
                             *_tensors_of(system))
    return LazyTraceResult(
        lambda: _materialize(system, rays, *out[7:], *out[:7]))


class FastDevOut(NamedTuple):
    """Raw deviation-level outputs of the fast engine core: per-ray f32
    hi/lo double-words + f64 chief-ray scalars.  ``ddet``/``dtot`` are
    deviations of the (tilt-corrected) detector intersection / total OPL
    from the chief's; ``det_c``/``total_chief`` are the chief values."""

    dq_hi: torch.Tensor      # (3*nm, N) per-mirror intersection deviations
    dq_lo: torch.Tensor
    od_hi: torch.Tensor      # (3*nm, N) reflected-direction deviations
    od_lo: torch.Tensor
    dt_hi: torch.Tensor      # (nm, N) leg-length deviations
    dt_lo: torch.Tensor
    ddet_hi: torch.Tensor    # (3, N) focal-plane intersection deviations
    ddet_lo: torch.Tensor
    ddet2_hi: torch.Tensor   # (3, N) defocused-plane deviations
    ddet2_lo: torch.Tensor
    dqr_hi: torch.Tensor     # (3, N) tilt-rotated exit-point deviations
    dqr_lo: torch.Tensor
    ddr_hi: torch.Tensor     # (3, N) tilt-rotated exit-dir deviations
    ddr_lo: torch.Tensor
    dtot_hi: torch.Tensor    # (N,) OPL deviation to the focal plane
    dtot_lo: torch.Tensor
    dtot2_hi: torch.Tensor   # (N,) OPL deviation to the defocused plane
    dtot2_lo: torch.Tensor
    valid: torch.Tensor      # (N,) bool
    theta_y: torch.Tensor    # tilt-removal angles (f64 scalars)
    theta_z: torch.Tensor
    focus: torch.Tensor      # (3,) pre-tilt mean focus (rotation pivot)
    P_chief: torch.Tensor    # (nm, 3) chief hit points
    D_chief: torch.Tensor    # (nm, 3) chief outgoing directions
    T_chief: torch.Tensor    # (nm,) chief leg lengths
    P4r: torch.Tensor        # (3,) tilt-rotated chief exit point
    D4r: torch.Tensor        # (3,) tilt-rotated chief exit direction
    det_c: torch.Tensor      # (3,) chief focal-plane intersection
    det_c2: torch.Tensor     # (3,) chief defocused-plane intersection
    total_chief: torch.Tensor   # chief OPL to the focal plane
    total2_chief: torch.Tensor  # chief OPL to the defocused plane


def _tilt_stats(D4, dd4_32, valid, tilt: bool, tilt_mode: str):
    """Tilt-removal angles from exit-direction deviations:
    ``arctan(d_w / d_x)`` = the chief angle (f64) + ``arctan((u - v) /
    (1 + u v))`` with u the per-ray and v the chief slope, the small
    difference term in the deviations' dtype (akbx's: K1's f32 hi words;
    the port's fast engine and its twin: f64)."""
    if not tilt:
        z = torch.zeros((), dtype=F64, device=D4.device)
        return z, z
    D432 = D4.to(dd4_32.dtype)

    def dev_angle(comp):
        num = D432[0] * dd4_32[comp] - D432[comp] * dd4_32[0]
        den = D432[0] * (D432[0] + dd4_32[0])
        w = num / den
        u = (D432[comp] + dd4_32[comp]) / (D432[0] + dd4_32[0])
        v = D432[comp] / D432[0]
        return torch.atan(w / (1.0 + u * v))

    da_zx = dev_angle(2)
    da_yx = dev_angle(1)
    a_zx_c = torch.atan(D4[2] / D4[0])
    a_yx_c = torch.atan(D4[1] / D4[0])
    if tilt_mode == "extremes":
        def mid(a):
            return 0.5 * (torch.min(torch.where(valid, a, float("inf")))
                          + torch.max(torch.where(valid, a, -float("inf"))))

        m_zx, m_yx = mid(da_zx), mid(da_yx)
    else:
        m_zx = masked_mean(da_zx, valid)
        m_yx = masked_mean(da_yx, valid)
    theta_y = -(a_zx_c + m_zx.to(F64))
    theta_z = a_yx_c + m_yx.to(F64)
    return theta_y, theta_z


def _pre_tilt_focus(P4, D4, det_x, dq4_32, dd4_32, valid):
    """Masked mean of the pre-tilt focal-plane intersections (the tilt
    rotation pivot), chief + the mean of the deviations (in their
    dtype)."""
    t_c0 = (det_x - P4[0]) / D4[0]
    det_c0 = P4 + t_c0 * D4
    D432 = D4.to(dq4_32.dtype)
    tc032 = t_c0.to(dq4_32.dtype)
    den = D432[0] + dd4_32[0]
    dt0 = -(dq4_32[0] + tc032 * dd4_32[0]) / den
    ddet0 = dq4_32 + tc032 * dd4_32 + dt0 * (D432[:, None] + dd4_32)
    return det_c0 + masked_mean(ddet0, valid[None, :], dim=1).to(F64)


def _tilt_rotation(theta_y, theta_z):
    """R = Ry(-theta_y) @ Rz(-theta_z), the tilt-removal rotation."""
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=F64, device=theta_y.device)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=F64, device=theta_y.device)
    return geo.rodrigues(ey, -theta_y) @ geo.rodrigues(ez, -theta_z)


def _det_plane_scalars(P4r, D4r, det_x):
    """Chief detector-plane constants: (t_c, det_c, L)."""
    t_c = (det_x - P4r[0]) / D4r[0]
    det_c = P4r + t_c * D4r
    L = torch.abs(t_c) * torch.sqrt(torch.sum(D4r * D4r))
    return t_c, det_c, L


def _fast_post_scalars(consts64, det_x, det_x2, theta_y, theta_z, focus,
                       tilt: bool):
    """Rotation + per-plane chief constants of the detector stage."""
    Ts = consts64.T
    P4 = consts64.P[-1]
    D4 = consts64.Dn[-1]
    if tilt:
        R = _tilt_rotation(theta_y, theta_z)
        P4r = R @ (P4 - focus) + focus
        D4r = R @ D4
    else:
        R = torch.eye(3, dtype=F64, device=P4.device)
        P4r, D4r = P4, D4
    t_c, det_c, L = _det_plane_scalars(P4r, D4r, det_x)
    t_c2, det_c2, L2 = _det_plane_scalars(P4r, D4r, det_x2)
    T_sum = torch.sum(Ts)
    return (R, P4r, D4r, t_c, det_c, L, t_c2, det_c2, L2,
            T_sum + L, T_sum + L2)


def _fast_devs_forward(system, rays, origins, det_x, det_x2, chief_idx: int,
                       tilt: bool, tilt_mode: str) -> FastDevOut:
    """Deviation-level fast engine: K1, the tilt reductions, K2 (both
    detector planes in one launch)."""
    consts64, (dq_hi, dq_lo, od_hi, od_lo, dt_hi, dt_lo, dsum_hi, dsum_lo,
               val) = _k1(system, rays, origins, chief_idx)
    Ps, Dns, Ts = consts64.P, consts64.Dn, consts64.T
    n_mirr = Ps.shape[0]
    valid = val[0] > 0.5
    s = slice(3 * (n_mirr - 1), 3 * n_mirr)
    q4_hi, q4_lo = dq_hi[s], dq_lo[s]
    d4_hi, d4_lo = od_hi[s], od_lo[s]
    P4, D4 = Ps[-1], Dns[-1]

    # the tilt angles and the pivot from K1's deviations as hi + lo in
    # f64, as the twin has them; akbx reduces the f32 hi words, ~1e-9 rad
    # off the f64 engine's angles (ROADMAP F9)
    with spans.span("trace.tilt"):
        d4, q4 = _f64_of(d4_hi, d4_lo), _f64_of(q4_hi, q4_lo)
        theta_y, theta_z = _tilt_stats(D4, d4, valid, tilt, tilt_mode)
        focus = _pre_tilt_focus(P4, D4, det_x, q4, d4, valid)
        (R, P4r, D4r, t_c, det_c, L, t_c2, det_c2, L2, total_chief,
         total2_chief) = _fast_post_scalars(consts64, det_x, det_x2,
                                            theta_y, theta_z, focus, tilt)
        dcon = torch.cat([tk.pack_det_consts(R, D4r, t_c, L),
                          tk.pack_det_consts(R, D4r, t_c2, L2)])
    with spans.span("trace.k2"):
        (ddet_hi, ddet_lo, dqr_hi, dqr_lo, ddr_hi, ddr_lo, dtot_hi,
         dtot_lo) = tk.detector(dcon, q4_hi, q4_lo, d4_hi, d4_lo, dsum_hi,
                                dsum_lo)
    return FastDevOut(dq_hi, dq_lo, od_hi, od_lo, dt_hi, dt_lo,
                      ddet_hi[0], ddet_lo[0], ddet_hi[1], ddet_lo[1],
                      dqr_hi, dqr_lo, ddr_hi, ddr_lo,
                      dtot_hi[0], dtot_lo[0], dtot_hi[1], dtot_lo[1], valid,
                      theta_y, theta_z, focus, Ps, Dns, Ts,
                      P4r, D4r, det_c, det_c2, total_chief, total2_chief)


def _det_stage_f32(R, D4r, t_c, L, dq32, dd32, dsum32):
    """Plain twin of K2's deviation algebra in the inputs' dtype, one
    detector plane: (ddet, dqr, ddr, dtot)."""
    R32, D432 = R.to(dq32.dtype), D4r.to(dq32.dtype)
    tc32, L32 = t_c.to(dq32.dtype), L.to(dq32.dtype)
    dqr = _mv(R32, dq32)
    ddr = _mv(R32, dd32)
    dt = -(dqr[0] + tc32 * ddr[0]) / (D432[0] + ddr[0])
    delta = tc32 * ddr + dt * (D432[:, None] + ddr)
    u = (2.0 * tc32 * _dot(D432, delta)
         + torch.sum(delta * delta, dim=0))
    dlast = u / (L32 + torch.sqrt(torch.clamp_min(L32 * L32 + u, 0.0)))
    return dqr + delta, dqr, ddr, dsum32 + dlast


def _fast_devs_f32(system, rays, origins, det_x, det_x2, chief_idx: int,
                   tilt: bool, tilt_mode: str) -> FastDevOut:
    """Plain twin of :func:`_fast_devs_forward`: the same chief scalars,
    every per-ray stage in plain float64 arithmetic, the lo words None
    (the double-word error terms, whose derivatives the twin drops)."""
    consts64, (dqs, dds, _, dts, valid) = _dev32_trace(
        system, rays, origins, chief_idx, F64)
    dq4, dd4 = dqs[-1], dds[-1]
    dt = torch.stack(dts)
    Ps, Dns, Ts = consts64.P, consts64.Dn, consts64.T
    theta_y, theta_z = _tilt_stats(Dns[-1], dd4, valid, tilt, tilt_mode)
    focus = _pre_tilt_focus(Ps[-1], Dns[-1], det_x, dq4, dd4, valid)
    (R, P4r, D4r, t_c, det_c, L, t_c2, det_c2, L2, total_chief,
     total2_chief) = _fast_post_scalars(consts64, det_x, det_x2,
                                        theta_y, theta_z, focus, tilt)
    dsum = torch.sum(dt, dim=0)
    ddet, dqr, ddr, dtot = _det_stage_f32(R, D4r, t_c, L, dq4, dd4, dsum)
    ddet2, _, _, dtot2 = _det_stage_f32(R, D4r, t_c2, L2, dq4, dd4, dsum)
    return FastDevOut(torch.cat(dqs), None, torch.cat(dds), None, dt, None,
                      ddet, None, ddet2, None, dqr, None, ddr, None,
                      dtot, None, dtot2, None, valid, theta_y, theta_z,
                      focus, Ps, Dns, Ts, P4r, D4r, det_c, det_c2,
                      total_chief, total2_chief)


class _FastDevs(_TwinVJP):
    """The fast engine as one autograd node: K1, the tilt reductions and
    K2 forward; the VJP of :func:`_fast_devs_f32` backward."""

    @staticmethod
    def forward(ctx, static, rays, origins, det_x, det_x2, *system_tensors):
        outs = tuple(_fast_devs_forward(static[0], rays, origins, det_x,
                                        det_x2, *static[1:]))
        return _TwinVJP.keep(ctx, _fast_devs_f32, static,
                             (rays, origins, det_x, det_x2, *system_tensors),
                             outs)


def _fast_devs(system, rays, origins, det_x, det_x2, chief_idx: int,
               tilt: bool, tilt_mode: str) -> FastDevOut:
    return FastDevOut(*_FastDevs.apply((system, chief_idx, tilt, tilt_mode),
                                       rays, origins, det_x, det_x2,
                                       *_tensors_of(system)))


def _f64_of(hi, lo):
    return hi.to(F64) + lo.to(F64)


def run_fast(system: OpticalSystem, rays, origins, det_x, det_x2,
             chief_idx: int | None = None, tilt_correction: bool = True,
             tilt_mode: str = "mean"):
    """The precision='pallas' engine pass (trace through OPL).

    Returns a dict with keys: detcenter, detcenter2, total, total2, valid,
    theta_y, theta_z, focus, trace (a :class:`LazyTraceResult`), w32
    (demeaned OPL deviation, f32), w32_2, ddet32 (f32 detcenter
    deviations).
    """
    if chief_idx is None:
        chief_idx = rays.shape[1] // 2
    det_x, det_x2 = (torch.as_tensor(x, dtype=F64, device=rays.device)
                     for x in (det_x, det_x2))
    d = _fast_devs(system, rays, origins, det_x, det_x2, int(chief_idx),
                   bool(tilt_correction), str(tilt_mode))
    with spans.span("trace.finish"):
        return _fast_fields(system, rays, d)


def _fast_fields(system, rays, d: FastDevOut) -> dict:
    """:func:`run_fast`'s f64 fields and demeaned f32 wavefronts from the
    fast engine's deviation outputs."""
    detcenter = d.det_c[:, None] + _f64_of(d.ddet_hi, d.ddet_lo)
    detcenter2 = d.det_c2[:, None] + _f64_of(d.ddet2_hi, d.ddet2_lo)
    total = d.total_chief + _f64_of(d.dtot_hi, d.dtot_lo)
    total2 = d.total2_chief + _f64_of(d.dtot2_hi, d.dtot2_lo)

    # f32 deviation-form wavefront fields (demeaned over valid rays)
    mh = masked_mean(d.dtot_hi, d.valid)
    ml = masked_mean(d.dtot_lo, d.valid)
    w32 = (d.dtot_hi - mh) + (d.dtot_lo - ml)
    mh2 = masked_mean(d.dtot2_hi, d.valid)
    ml2 = masked_mean(d.dtot2_lo, d.valid)
    w32_2 = (d.dtot2_hi - mh2) + (d.dtot2_lo - ml2)

    def materialize() -> TraceResult:
        tr = _materialize(system, rays, d.P_chief, d.D_chief, d.T_chief,
                          d.dq_hi, d.dq_lo, d.od_hi, d.od_lo, d.dt_hi,
                          d.dt_lo, d.valid)
        # the tilt-corrected exit point/dir replace the last mirror's
        return tr._replace(
            points=tr.points[:-1] + (d.P4r[:, None]
                                     + _f64_of(d.dqr_hi, d.dqr_lo),),
            directions=tr.directions[:-1] + (d.D4r[:, None]
                                             + _f64_of(d.ddr_hi, d.ddr_lo),))

    return {
        "detcenter": detcenter, "detcenter2": detcenter2,
        "total": total, "total2": total2, "valid": d.valid,
        "theta_y": d.theta_y, "theta_z": d.theta_z, "focus": d.focus,
        "trace": LazyTraceResult(materialize), "w32": w32, "w32_2": w32_2,
        "ddet32": d.ddet_hi,
    }


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """``jnp.interp(x, xp, fp)``: piecewise-linear through increasing
    ``xp``, clamped to ``fp[0]`` / ``fp[-1]`` outside, the same formula
    (searchsorted on the right, a zero-width interval takes its left
    value).  Leading dimensions, the same in all three, are a batch of
    independent rows."""
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True), 1, xp.shape[-1] - 1)
    xp0, xp1 = torch.gather(xp, -1, i - 1), torch.gather(xp, -1, i)
    fp0, fp1 = torch.gather(fp, -1, i - 1), torch.gather(fp, -1, i)
    dx = xp1 - xp0
    # np.spacing(eps), which is eps**2: eps is a power of two
    dx0 = torch.abs(dx) <= torch.finfo(xp.dtype).eps ** 2
    f = torch.where(dx0, fp0,
                    fp0 + ((x - xp0) / torch.where(dx0, 1.0, dx)) * (fp1 - fp0))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def exit_pupil_uniform_angles(result: TraceResult, rand_p0h, rand_p0v,
                              n_h: int, n_v: int, stage: int = -1,
                              mesh=None):
    """Re-derive source angles so *exit* angles are equally spaced.

    The exit angles of the center row/column map exit -> input angle by
    :func:`interp`, and the fan is rebuilt on equally spaced exit angles.
    ``stage`` selects which bounce's direction field to uniformize on:
    -1 (default) = final exit angles; 1 = after the first mirror.  With a
    ray-sharded ``result`` (``mesh``) the center row and column of the
    global fan are gathered from the ranks that hold them.
    """
    angle = result.directions[stage]
    dev = angle.device
    lo = 0 if mesh is None else sh.shard_bounds(n_h * n_v, mesh)[0]

    # center column: iH = (n_h-1)//2, iV varies
    center_col = (torch.arange(n_v, device=dev) * n_h
                  + round((n_h - 1) / 2))
    # center row: iV = (n_v-1)//2, iH varies (the reference's index rule,
    # Python round included)
    center_row = (round(n_v * (n_v - 1) / 2) + torch.arange(n_h, device=dev)
                  if n_h == n_v
                  else ((n_v - 1) // 2) * n_h + torch.arange(n_h, device=dev))

    col = sh.take_columns(angle, center_col, lo, mesh)
    row = sh.take_columns(angle, center_row, lo, mesh)
    av = torch.atan(col[2] / col[0])
    ah = torch.atan(row[1] / row[0])

    def remap(a_exit, a_in, n):
        eq = linspace(a_exit[0], a_exit[-1], n)
        sign = torch.where(a_exit[-1] >= a_exit[0], 1.0, -1.0).to(F64)
        return interp(sign * eq, sign * a_exit, a_in)

    return remap(ah, rand_p0h, n_h), remap(av, rand_p0v, n_v)


def detector_points(result: TraceResult, x_plane) -> torch.Tensor:
    """Intersect exit rays with the plane x = x_plane (a tensor or a
    number)."""
    pts = result.exit_points
    x_plane = torch.as_tensor(x_plane, dtype=F64, device=pts.device)
    return geo.plane_intersect(geo.detector_plane(x_plane), result.exit_rays,
                               pts)


def tilt_correct(result: TraceResult, detcenter: torch.Tensor,
                 mode: str = "mean", mesh=None):
    """Remove the mean exit-beam tilt: rotate exit rays and exit points
    about the approximate focus so the beam axis is +x.  Returns
    (new_exit_rays, new_exit_points, theta_y, theta_z, focus_apprx).
    ``mode``: ``"mean"`` (mean of the ray angles) or ``"extremes"``
    (midpoint of the extreme ray angles); over every rank of a
    ray-sharded ``mesh``."""
    angle = result.exit_rays
    v = result.valid
    a_zx = torch.atan(angle[2] / angle[0])
    a_yx = torch.atan(angle[1] / angle[0])
    if mode == "extremes":
        inf = float("inf")
        theta_y = -0.5 * (sh.all_min(torch.where(v, a_zx, inf), mesh)
                          + sh.all_max(torch.where(v, a_zx, -inf), mesh))
        theta_z = 0.5 * (sh.all_min(torch.where(v, a_yx, inf), mesh)
                         + sh.all_max(torch.where(v, a_yx, -inf), mesh))
    else:
        theta_y = -masked_mean(a_zx, v, mesh=mesh)
        theta_z = masked_mean(a_yx, v, mesh=mesh)
    focus_apprx = masked_mean(detcenter, v[None, :], dim=1, mesh=mesh)
    rays2 = geo.rotate_vectors_yz(result.exit_rays, -theta_y, -theta_z)
    pts2 = geo.rotate_points_about(result.exit_points, focus_apprx,
                                   -theta_y, -theta_z)
    return rays2, pts2, theta_y, theta_z, focus_apprx


class EngineResult(NamedTuple):
    """Everything the analysis layers need from one full engine run."""

    trace: TraceResult  # a LazyTraceResult on the fast path
    detcenter: torch.Tensor  # focal-plane intersections (3, N), tilt-corrected
    detcenter2: torch.Tensor  # defocused-plane intersections (3, N)
    total_dist: torch.Tensor  # OPL to focal plane (N,)
    total_dist2: torch.Tensor  # OPL to defocused plane (N,)
    wave2: torch.Tensor  # wavefront error on defocused plane [nm] (N,)
    valid: torch.Tensor
    theta_y: torch.Tensor
    theta_z: torch.Tensor
    focus_apprx: torch.Tensor
    rand_p0h: torch.Tensor
    rand_p0v: torch.Tensor
    # deviation-form f32 fields (precision='pallas' only, else None):
    # demeaned OPL deviations [m] (focal / defocused plane) and detcenter
    # deviations from the chief
    w32: torch.Tensor | None = None
    ddet32: torch.Tensor | None = None
    w32_2: torch.Tensor | None = None


def _wave2(detcenter, detcenter2, total2, v, mesh=None):
    """Wavefront on the defocused plane [nm]: OPL error minus the
    reference sphere about the mean focus."""
    mean_focus = masked_mean(detcenter, v[None, :], dim=1, mesh=mesh)
    dist_err2 = (total2 - masked_mean(total2, v, mesh=mesh)) * 1e9
    sph = torch.sqrt(torch.sum((detcenter2 - mean_focus[:, None]) ** 2,
                               dim=0)) * 1e9
    return dist_err2 - sph


def _trace_shard(trace_fn, system, rays, origins, chief_d0, chief_p0
                 ) -> TraceResult:
    """A deviation engine (:func:`trace_pallas`, :func:`trace_df`) on a
    ray shard against the chief ray of the whole fan (``chief_d0``,
    ``chief_p0``: (3, 1)), as akbx's trace of the whole fan has it: the
    chief rides in front of the shard as column 0 and is dropped from the
    result."""
    res = trace_fn(system, torch.cat([chief_d0, rays], dim=1),
                   torch.cat([chief_p0, origins], dim=1), chief_idx=0)
    if isinstance(res, LazyTraceResult):
        res = res.materialize()
    return TraceResult(*(tuple(x[..., 1:] for x in field)
                         for field in res[:4]), res.valid[1:])


@spans.spanned("trace.run")
def run(system: OpticalSystem, n_h: int, n_v: int, defocus,
        defocus_wave=1e-3, exit_pupil_uniform: bool = True,
        tilt_correction: bool = True, ray_sharding=None,
        uniform_stage: int = -1, precision: str = "f64",
        tilt_mode: str = "mean", fan_mode: str = "uniform") -> EngineResult:
    """Full engine pass: fan -> trace -> tilt removal -> detector planes
    -> OPL -> wavefront, on the device of ``system``; with the exit-pupil
    re-fan (``exit_pupil_uniform``: trace, re-derive the source angles on
    the ``uniform_stage`` directions, re-trace) or without.

    ``precision`` picks the engine, as akbx's ``run`` does:

    * ``"f64"``: :func:`trace` in f64;
    * ``"df32"``: :func:`trace_df`, the double-f32 deviation trace in
      plain PyTorch (no kernel);
    * ``"pallas"``: the fast engine, K1 and K2 (:func:`run_fast`; the
      re-fan's first trace is :func:`trace_pallas`).

    With figure errors on any mirror (``fig_coeffs`` other than (1, 1))
    ``"df32"`` and ``"pallas"`` both trace on the f64 engine, and so
    launch no kernel: K1 does not model figures (akbx's kernel does not
    either).  Every route sums the OPL with the compensated
    :func:`akbx_torch.core.precision.sum_segments`, except ``"pallas"``
    off the fast engine, which sums in plain f64 as akbx does.

    ``ray_sharding``: a one-dimensional ``DeviceMesh``
    (:func:`akbx_torch.parallel.sharding.ray_mesh`).  Each rank traces its
    columns of the one fan (:func:`akbx_torch.parallel.sharding.
    shard_bounds`) and gets its columns of every per-ray field; the
    reductions over rays (tilt, focus, wavefront means) are summed over
    the ranks.  As in akbx, the fast engine runs only unsharded:
    ``"pallas"`` traces each shard with K1 (:func:`trace_pallas`) and
    finishes on the f64 path; it and ``"df32"`` trace against the whole
    fan's chief ray.
    """
    if precision not in ("f64", "df32", "pallas"):
        raise ValueError(f"unknown precision {precision!r}")
    mesh = ray_sharding
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError("ray_sharding takes a DeviceMesh (akbx_torch."
                        f"parallel.sharding.ray_mesh), got {type(mesh)}")
    figure = any(has_figure(m) for m in system.mirrors)
    n = n_h * n_v
    lo, hi = (0, n) if mesh is None else sh.shard_bounds(n, mesh)

    rand_p0h = fan_angles(system.fan_h, n_h, mode=fan_mode)
    rand_p0v = fan_angles(system.fan_v, n_v, mode=fan_mode)
    src = system.source[:, None].expand(3, hi - lo)
    det_x = system.s2f_middle + defocus

    if precision == "pallas" and not figure and mesh is None:
        rays = ray_fan(rand_p0h, rand_p0v)
        if exit_pupil_uniform:
            pre = trace_pallas(system, rays, src)
            rand_p0h, rand_p0v = exit_pupil_uniform_angles(
                pre, rand_p0h, rand_p0v, n_h, n_v, stage=uniform_stage)
            rays = ray_fan(rand_p0h, rand_p0v)
        d = _fast_devs(system, rays, src, det_x, det_x + defocus_wave,
                       rays.shape[1] // 2, bool(tilt_correction),
                       str(tilt_mode))
        with spans.span("trace.finish"):
            out = _fast_fields(system, rays, d)
            v = out["valid"]
            wave2 = _wave2(out["detcenter"], out["detcenter2"],
                           out["total2"], v)
        return EngineResult(out["trace"], out["detcenter"],
                            out["detcenter2"], out["total"], out["total2"],
                            wave2, v, out["theta_y"], out["theta_z"],
                            out["focus"], rand_p0h, rand_p0v,
                            out["w32"], out["ddet32"], out["w32_2"])

    engine = trace
    if not figure and precision != "f64":
        engine = trace_pallas if precision == "pallas" else trace_df

    def trace_fan(angles_h, angles_v):
        rays = ray_fan(angles_h, angles_v, lo, hi)
        if engine is trace or mesh is None:
            return engine(system, rays, src)
        chief = ray_fan(angles_h, angles_v, n // 2, n // 2 + 1)
        return _trace_shard(engine, system, rays, src, chief,
                            system.source[:, None])

    result = trace_fan(rand_p0h, rand_p0v)
    if exit_pupil_uniform:
        rand_p0h, rand_p0v = exit_pupil_uniform_angles(
            result, rand_p0h, rand_p0v, n_h, n_v, stage=uniform_stage,
            mesh=mesh)
        result = trace_fan(rand_p0h, rand_p0v)
    detcenter = detector_points(result, det_x)
    if tilt_correction:
        rays2, pts2, theta_y, theta_z, focus_apprx = tilt_correct(
            result, detcenter, mode=tilt_mode, mesh=mesh)
        result = result._replace(
            points=result.points[:-1] + (pts2,),
            directions=result.directions[:-1] + (rays2,),
        )
        detcenter = detector_points(result, det_x)
    else:
        theta_y = torch.zeros((), dtype=F64, device=src.device)
        theta_z = torch.zeros((), dtype=F64, device=src.device)
        focus_apprx = masked_mean(detcenter, result.valid[None, :], dim=1,
                                  mesh=mesh)
    detcenter2 = detector_points(result, det_x + defocus_wave)

    d_last = torch.sqrt(torch.sum((detcenter - result.exit_points) ** 2,
                                  dim=0))
    d_last2 = torch.sqrt(torch.sum((detcenter2 - result.exit_points) ** 2,
                                   dim=0))
    if precision == "pallas":
        # off the fast engine (figures, or sharded): akbx's plain f64 sum
        # of the legs (~1e-13 m rms on the demeaned wavefront)
        total = sum(result.segments) + d_last
        total2 = sum(result.segments) + d_last2
    else:
        # compensated accumulation
        total = pr.sum_segments(list(result.segments) + [d_last])
        total2 = pr.sum_segments(list(result.segments) + [d_last2])
    v = result.valid
    wave2 = _wave2(detcenter, detcenter2, total2, v, mesh=mesh)
    return EngineResult(result, detcenter, detcenter2, total, total2, wave2,
                        v, theta_y, theta_z, focus_apprx, rand_p0h, rand_p0v)


def run_config(system: OpticalSystem, cfg, defocus) -> EngineResult:
    """Run the engine from a :class:`akbx_torch.config.TraceConfig`."""
    return run(system, cfg.n_rays_h, cfg.n_rays_v, defocus,
               defocus_wave=cfg.defocus_for_wave,
               exit_pupil_uniform=cfg.exit_pupil_uniform,
               tilt_correction=cfg.tilt_correction,
               tilt_mode=cfg.tilt_mode, fan_mode=cfg.fan_mode,
               precision=cfg.precision)


def spot_size(detcenter: torch.Tensor, valid: torch.Tensor, mesh=None):
    """Masked std of the spot in (horizontal, vertical); over every rank
    of a ray-sharded ``mesh``."""
    w = valid.to(detcenter.dtype)

    def total(x):
        return sh.all_sum(torch.sum(x), mesh)

    n = torch.clamp_min(total(w), 1.0)
    mu_y = total(detcenter[1] * w) / n
    mu_z = total(detcenter[2] * w) / n
    sy = torch.sqrt(total(w * (detcenter[1] - mu_y) ** 2) / n)
    sz = torch.sqrt(total(w * (detcenter[2] - mu_z) ** 2) / n)
    return sy, sz
