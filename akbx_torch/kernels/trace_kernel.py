"""The deviation-trace kernels K1 (bounce chain) and K2 (detector / OPL).

Port of :mod:`akbx.kernels.trace_kernel`.  Each kernel has three parts
here: the plain PyTorch twin (``bounce_chain`` / ``detector_chain``, run
by ``trace_deviation_reference`` / ``detector_reference``), the CUDA C++
kernel in ``akbx_torch/csrc/trace_kernel.cu``, and a dispatching wrapper
(``trace_deviation`` / ``detector``) that runs the twin on a CPU tensor
and launches the kernel on a CUDA tensor, never falling back.  Each
wrapper counts its kernel launches in ``<wrapper>.launches``.

Both compute in double-f32 ("df32", hi/lo f32 pairs, ~49 bits) the exact
degree-2 deviation of every ray from an f64 chief ray; see
:func:`akbx.trace.trace_df` for the math.  The twin and the kernel run the
same operations in the same order (``two_prod`` is the FMA form in both,
see :mod:`akbx_torch.core.precision`); the one expected difference is the
first guess of ``df_rsqrt`` (``rsqrtf`` on the card vs ``torch.rsqrt``),
which the double-word Newton step corrects.

K1 reads its constants table from ``__constant__`` memory, which its
launcher fills on the launch's stream.  Launches on one stream are
ordered; on two streams at once they would overwrite each other's table,
so :func:`trace_deviation` raises when a launch on another stream may
still be running.
"""

from __future__ import annotations

import torch

from akbx_torch.core import use_kernel
from akbx_torch.core.precision import (DF, df_add, df_mul, df_sqrt,
                                       fast_two_sum, two_prod)
from akbx_torch.kernels import (F32, F64, check, ptr, raise_on, split64,
                                stream)

# constants-row layout of K1 (one row of 64 f32 per mirror); the CUDA
# kernel reads the same offsets (csrc/trace_kernel.cu)
_M_HI, _M_LO = 0, 9            # 3x3 row-major
_GC_HI, _GC_LO = 18, 21
_GA_HI, _GA_LO = 24, 27
_D_HI, _D_LO = 30, 33
_DN_HI, _DN_LO = 36, 39
_T_HI, _T_LO = 42, 43
_A_HI, _A_LO = 44, 45
_BP_HI, _BP_LO = 46, 47
_RHO_HI, _RHO_LO = 48, 49
_BRANCH = 50
_T2_HI, _T2_LO = 51, 52
_BV_HI, _BV_LO = 53, 56        # quadric linear term (chief frame)
_N_CONST = 64
MAX_MIRRORS = 8                # the CUDA kernel's __constant__ table

# constants-row layout of K2 (one row of 32 f32 per detector plane)
_DR_HI, _DR_LO = 0, 9          # 3x3 tilt rotation R, row-major
_DD4_HI, _DD4_LO = 18, 21      # R-rotated chief exit direction D4'
_DTC_HI, _DTC_LO = 24, 25      # chief plane parameter t_c
_DL_HI, _DL_LO = 26, 27        # chief exit->plane distance L = |t_c D4'|
_DL2_HI, _DL2_LO = 28, 29      # L^2
_N_DCONST = 32
MAX_PLANES = 4


def pack_consts(Ms, gCs, gAs, Ds, Dns, Ts, A_noms, Bp_noms, rhos,
                branches, bvecs) -> torch.Tensor:
    """(n_mirr, 64) f32 table of hi/lo-split f64 chief constants."""
    n = Ms.shape[0]
    rows = torch.zeros((n, _N_CONST), dtype=F32, device=Ms.device)
    Mh, Ml = split64(Ms.reshape(n, 9))
    rows[:, _M_HI:_M_HI + 9] = Mh
    rows[:, _M_LO:_M_LO + 9] = Ml
    for col_hi, col_lo, v in ((_GC_HI, _GC_LO, gCs), (_GA_HI, _GA_LO, gAs),
                              (_D_HI, _D_LO, Ds), (_DN_HI, _DN_LO, Dns),
                              (_BV_HI, _BV_LO, bvecs)):
        h, low = split64(v)
        rows[:, col_hi:col_hi + 3] = h
        rows[:, col_lo:col_lo + 3] = low
    for col_hi, col_lo, v in ((_T_HI, _T_LO, Ts), (_A_HI, _A_LO, A_noms),
                              (_BP_HI, _BP_LO, Bp_noms),
                              (_RHO_HI, _RHO_LO, rhos),
                              (_T2_HI, _T2_LO, Ts * Ts)):
        h, low = split64(v)
        rows[:, col_hi] = h
        rows[:, col_lo] = low
    rows[:, _BRANCH] = branches.to(F32)
    return rows


def pack_det_consts(R, D4r, t_c, L) -> torch.Tensor:
    """(1, 32) f32 table of hi/lo-split f64 detector-stage constants."""
    row = torch.zeros((1, _N_DCONST), dtype=F32, device=R.device)
    Rh, Rl = split64(R.reshape(9))
    row[0, _DR_HI:_DR_HI + 9] = Rh
    row[0, _DR_LO:_DR_LO + 9] = Rl
    Dh, Dl = split64(D4r)
    row[0, _DD4_HI:_DD4_HI + 3] = Dh
    row[0, _DD4_LO:_DD4_LO + 3] = Dl
    for col_hi, col_lo, v in ((_DTC_HI, _DTC_LO, t_c), (_DL_HI, _DL_LO, L),
                              (_DL2_HI, _DL2_LO, L * L)):
        h, low = split64(v)
        row[0, col_hi] = h
        row[0, col_lo] = low
    return row


# --- the twins' df32 helpers (the CUDA kernel has the same, df32.cuh) ---

def _scale(a: DF, s: float) -> DF:
    """Exact scaling by a power of two (or a sign)."""
    return DF(a.hi * s, a.lo * s)


def _dot3(a, b) -> DF:
    return df_add(df_add(df_mul(a[0], b[0]), df_mul(a[1], b[1])),
                  df_mul(a[2], b[2]))


def _df_div(x: DF, y: DF) -> DF:
    """Double-word division on (hi, lo) pairs (Newton-corrected)."""
    q1 = x.hi / y.hi
    ph, plo = two_prod(y.hi, q1)
    e = plo + y.lo * q1
    rh, rl = df_add(x, DF(-ph, -e))
    q2 = (rh + rl) / y.hi
    return fast_two_sum(q1, q2)


def _df_rsqrt(x: DF) -> DF:
    s = torch.rsqrt(torch.clamp_min(x.hi, 1e-30))
    s2 = two_prod(s, s)
    xs = df_mul(x, s2)
    c = df_add(DF(-xs.hi, -xs.lo), DF(torch.full_like(s, 3.0),
                                      torch.zeros_like(s)))
    c = _scale(c, 0.5)
    p0 = two_prod(s, c.hi)
    return fast_two_sum(p0.hi, p0.lo + s * c.lo)


def _where(cond, a: DF, b: DF) -> DF:
    return DF(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))


def bounce_chain(get_c, dp, dd, n_mirr: int):
    """The full deviation bounce chain on df32 pairs (twin of K1).

    ``get_c(m, k)``: scalar access into the constants table;
    ``dp``/``dd``: per-component DF pairs.  Returns (dqs, dds, dts, valid):
    per-mirror lists of DF triples / DF pairs and the f32 validity mask.
    """

    def cdf(m, k_hi, k_lo):
        return DF(get_c(m, k_hi), get_c(m, k_lo))

    valid = torch.ones_like(dp[0].hi)
    dqs, dds, dts = [], [], []
    for m in range(n_mirr):
        M = [[cdf(m, _M_HI + 3 * r + q, _M_LO + 3 * r + q)
              for q in range(3)] for r in range(3)]
        gC = [cdf(m, _GC_HI + r, _GC_LO + r) for r in range(3)]
        gA = [cdf(m, _GA_HI + r, _GA_LO + r) for r in range(3)]
        Dv = [cdf(m, _D_HI + r, _D_LO + r) for r in range(3)]
        Dn = [cdf(m, _DN_HI + r, _DN_LO + r) for r in range(3)]
        bv = [cdf(m, _BV_HI + r, _BV_LO + r) for r in range(3)]
        Tc = cdf(m, _T_HI, _T_LO)
        T2c = cdf(m, _T2_HI, _T2_LO)
        Ac = cdf(m, _A_HI, _A_LO)
        Bpc = cdf(m, _BP_HI, _BP_LO)
        rhoc = cdf(m, _RHO_HI, _RHO_LO)
        branch = get_c(m, _BRANCH)

        Mdp = [_dot3(M[r], dp) for r in range(3)]
        Mdd = [_dot3(M[r], dd) for r in range(3)]
        dC = df_add(_dot3(gC, dp), _dot3(Mdp, dp))
        dA = df_add(_dot3(gA, dd), _dot3(Mdd, dd))
        dB = df_add(df_add(_dot3(gC, dd), _dot3(gA, dp)),
                    _scale(_dot3(Mdp, dd), 2.0))

        # R = dA T^2 + dB T + dC + rho
        R = df_add(df_add(df_mul(dA, T2c), df_mul(dB, Tc)), df_add(dC, rhoc))
        A_full = df_add(dA, Ac)
        Bp = df_add(df_add(_scale(df_mul(dA, Tc), 2.0), dB), Bpc)

        # stable q-form roots of A dt^2 + B' dt + R = 0
        disc = df_add(df_mul(Bp, Bp), _scale(df_mul(A_full, R), -4.0))
        ok = disc.hi > 0
        zero = torch.zeros_like(disc.hi)
        sq = df_sqrt(DF(torch.where(ok, disc.hi, zero),
                        torch.where(ok, disc.lo, zero)))
        b_pos = Bp.hi >= 0
        sgn = torch.where(b_pos, 1.0, -1.0).to(F32)
        qq = _scale(df_add(Bp, DF(sq.hi * sgn, sq.lo * sgn)), -0.5)
        safe_q = DF(torch.where(qq.hi != 0, qq.hi, 1.0), qq.lo)
        safe_A = DF(torch.where(A_full.hi != 0, A_full.hi, 1.0), A_full.lo)
        t_q_A = _df_div(qq, safe_A)
        t_R_q = _df_div(R, safe_q)
        t_plus = _where(b_pos, t_R_q, t_q_A)
        t_minus = _where(b_pos, t_q_A, t_R_q)
        dt = _where(branch >= 0, t_plus, t_minus)
        valid = valid * ok.to(F32)

        # dq = dp + T dd + dt (D + dd)
        d_full = [df_add(dd[r], Dv[r]) for r in range(3)]
        dq = [df_add(df_add(dp[r], df_mul(dd[r], Tc)), df_mul(d_full[r], dt))
              for r in range(3)]

        # unit normal: gradQ(dq) = bvec + 2 M dq (chief-centered frame)
        nvec = [df_add(_scale(_dot3(M[r], dq), 2.0), bv[r]) for r in range(3)]
        inv_n = _df_rsqrt(_dot3(nvec, nvec))
        n_unit = [df_mul(nvec[r], inv_n) for r in range(3)]

        # reflect: r = d - 2 (d.n) n; deviation from the chief's reflected
        dn2 = _scale(_dot3(d_full, n_unit), -2.0)
        refl = [df_add(d_full[r], df_mul(n_unit[r], dn2)) for r in range(3)]
        dd = [df_add(refl[r], _scale(Dn[r], -1.0)) for r in range(3)]
        dp = dq

        dqs.append(dq)
        dds.append(dd)
        dts.append(dt)
    return dqs, dds, dts, valid


def trace_deviation_reference(consts, dp64, dd64, n_mirr: int):
    """Plain PyTorch twin of K1, with the JAX launcher's contract.

    ``consts``: (n_mirr, 64) f32 from :func:`pack_consts`; ``dp64``/
    ``dd64``: (3, N) f64 deviations from the chief ray.  Returns
    ``(dq_hi, dq_lo, od_hi, od_lo, dt_hi, dt_lo, dsum_hi, dsum_lo,
    valid)`` shaped (3*n_mirr, N) / (n_mirr, N) / (N,) / (1, N); ``dsum``
    is the cumulative leg-length deviation up to the last mirror.
    """
    dph, dpl = split64(dp64)
    ddh, ddl = split64(dd64)
    dp = [DF(dph[r], dpl[r]) for r in range(3)]
    dd = [DF(ddh[r], ddl[r]) for r in range(3)]
    rows = [consts[m] for m in range(n_mirr)]
    dqs, dds, dts, valid = bounce_chain(lambda m, k: rows[m][k], dp, dd,
                                        n_mirr)

    def pack3(items, word):
        return torch.stack([items[m][r][word]
                            for m in range(n_mirr) for r in range(3)])

    def pack1(items, word):
        return torch.stack([items[m][word] for m in range(n_mirr)])

    dsum = dts[0]
    for m in range(1, n_mirr):
        dsum = df_add(dsum, dts[m])
    return (pack3(dqs, 0), pack3(dqs, 1), pack3(dds, 0), pack3(dds, 1),
            pack1(dts, 0), pack1(dts, 1), dsum.hi, dsum.lo, valid[None])


def _plane_chain(get_c, dqr, ddr, dsum):
    """Detector plane x = x_det + OPL finish on the tilt-rotated exit
    deviations (one constants row):

      dt  = -(dq'_x + t_c dd'_x) / (D4'_x + dd'_x)
      ddet = dq' + t_c dd' + dt (D4' + dd')
      delta = ddet - dq';  u = 2 t_c (D4' . delta) + delta . delta
      dlast = u / (L + sqrt(L^2 + u));  dtot = dsum + dlast
    """

    def cdf(k_hi, k_lo):
        return DF(get_c(k_hi), get_c(k_lo))

    D4 = [cdf(_DD4_HI + r, _DD4_LO + r) for r in range(3)]
    tc = cdf(_DTC_HI, _DTC_LO)
    L = cdf(_DL_HI, _DL_LO)
    L2 = cdf(_DL2_HI, _DL2_LO)

    den = df_add(D4[0], ddr[0])
    num = df_add(dqr[0], df_mul(tc, ddr[0]))
    dt = _df_div(_scale(num, -1.0), den)

    d_full = [df_add(D4[r], ddr[r]) for r in range(3)]
    delta = [df_add(df_mul(tc, ddr[r]), df_mul(dt, d_full[r])) for r in range(3)]
    ddet = [df_add(dqr[r], delta[r]) for r in range(3)]

    cd = df_mul(tc, _dot3(D4, delta))
    u = df_add(_scale(cd, 2.0), _dot3(delta, delta))
    s2 = df_add(L2, u)
    root = df_sqrt(DF(torch.clamp_min(s2.hi, 0.0), s2.lo))
    dlast = _df_div(u, df_add(L, root))
    return ddet, df_add(dsum, dlast)


def detector_chain(get_c, dq, dd, dsum):
    """Tilt-rotate + detector-plane + OPL-finish on df32 pairs (twin of K2,
    one plane): dq' = R dq, dd' = R dd, then :func:`_plane_chain`.
    Returns (ddet (3 DF), dq' (3 DF), dd' (3 DF), dtot DF)."""
    R = [[DF(get_c(_DR_HI + 3 * r + c), get_c(_DR_LO + 3 * r + c))
          for c in range(3)] for r in range(3)]
    dqr = [_dot3(R[r], dq) for r in range(3)]
    ddr = [_dot3(R[r], dd) for r in range(3)]
    ddet, dtot = _plane_chain(get_c, dqr, ddr, dsum)
    return ddet, dqr, ddr, dtot


def detector_reference(consts, dq_hi, dq_lo, dd_hi, dd_lo, dsum_hi,
                       dsum_lo):
    """Plain PyTorch twin of K2.

    ``consts``: (P, 32) f32, one :func:`pack_det_consts` row per detector
    plane, all rows with the same rotation R (row 0's is applied);
    ``dq_*``/``dd_*``: (3, N) f32 exit deviations; ``dsum_*``: (N,).
    Returns ``(ddet_hi, ddet_lo, dqr_hi, dqr_lo, ddr_hi, ddr_lo, dtot_hi,
    dtot_lo)`` shaped (P, 3, N) / (3, N) / (P, N): the JAX launcher's
    contract with a leading plane dimension on ``ddet`` and ``dtot``.
    """
    dq = [DF(dq_hi[r], dq_lo[r]) for r in range(3)]
    dd = [DF(dd_hi[r], dd_lo[r]) for r in range(3)]
    dsum = DF(dsum_hi, dsum_lo)
    rows = [consts[p] for p in range(consts.shape[0])]
    ddet, dqr, ddr, dtot = detector_chain(lambda k: rows[0][k], dq, dd, dsum)
    planes = [(ddet, dtot)] + [
        _plane_chain(lambda k, row=row: row[k], dqr, ddr, dsum)
        for row in rows[1:]]

    def pack(v, w):
        return torch.stack([v[r][w] for r in range(3)])

    return (torch.stack([pack(d, 0) for d, _ in planes]),
            torch.stack([pack(d, 1) for d, _ in planes]),
            pack(dqr, 0), pack(dqr, 1), pack(ddr, 0), pack(ddr, 1),
            torch.stack([t.hi for _, t in planes]),
            torch.stack([t.lo for _, t in planes]))


# --- dispatching wrappers -------------------------------------------------

# card index -> (stream handle, event after K1's last launch there)
_k1_last_launch: dict = {}


def _claim_constants(device) -> torch.cuda.Stream:
    """The stream K1 may launch on now: PyTorch's current one, unless
    K1's last launch on this card went to another stream and may still be
    running (it would lose its constants table)."""
    current = torch.cuda.current_stream(device)
    last = _k1_last_launch.get(current.device.index)
    if last and last[0] != current.cuda_stream and not last[1].query():
        raise RuntimeError(
            "trace_deviation: a launch on another stream is still running; "
            "K1's constants table is one per card, so launch it from one "
            "stream at a time (or synchronise first)")
    return current


def trace_deviation(consts, dp64, dd64, n_mirr: int):
    """K1: the twin on a CPU tensor, the CUDA kernel on a CUDA tensor;
    contract of :func:`trace_deviation_reference`."""
    if not use_kernel(consts, dp64, dd64):
        return trace_deviation_reference(consts, dp64, dd64, n_mirr)
    from akbx_torch.kernels import _build

    n = dp64.shape[1]
    if not 1 <= n_mirr <= MAX_MIRRORS:
        raise ValueError(f"n_mirr={n_mirr} outside 1..{MAX_MIRRORS}")
    check(consts, F32, (n_mirr, _N_CONST), "consts")
    check(dp64, F64, (3, n), "dp64")
    check(dd64, F64, (3, n), "dd64")
    lib = _build.load()
    current = _claim_constants(dp64.device)

    def empty(*shape):
        return torch.empty(shape, dtype=F32, device=dp64.device)

    outs = (empty(3 * n_mirr, n), empty(3 * n_mirr, n),
            empty(3 * n_mirr, n), empty(3 * n_mirr, n),
            empty(n_mirr, n), empty(n_mirr, n), empty(n), empty(n),
            empty(1, n))
    if n:
        rc = lib.akbx_trace_deviation(
            ptr(consts), n_mirr, ptr(dp64), ptr(dd64), n,
            *[ptr(o) for o in outs], stream(dp64))
        raise_on(rc, "trace_deviation")
        trace_deviation.launches += 1
        done = torch.cuda.Event()
        done.record(current)
        _k1_last_launch[current.device.index] = (current.cuda_stream, done)
    return outs


trace_deviation.launches = 0


def detector(consts, dq_hi, dq_lo, dd_hi, dd_lo, dsum_hi, dsum_lo):
    """K2: the twin on a CPU tensor, the CUDA kernel on a CUDA tensor;
    contract of :func:`detector_reference`.  One launch serves every
    constants row (detector plane)."""
    ins = (dq_hi, dq_lo, dd_hi, dd_lo, dsum_hi, dsum_lo)
    if not use_kernel(consts, *ins):
        return detector_reference(consts, *ins)
    from akbx_torch.kernels import _build

    n = dq_hi.shape[1]
    n_planes = consts.shape[0]
    if not 1 <= n_planes <= MAX_PLANES:
        raise ValueError(f"{n_planes} detector planes outside "
                         f"1..{MAX_PLANES}")
    check(consts, F32, (n_planes, _N_DCONST), "consts")
    for name, t in zip(("dq_hi", "dq_lo", "dd_hi", "dd_lo"), ins[:4]):
        check(t, F32, (3, n), name)
    check(dsum_hi, F32, (n,), "dsum_hi")
    check(dsum_lo, F32, (n,), "dsum_lo")
    lib = _build.load()

    def empty(*shape):
        return torch.empty(shape, dtype=F32, device=dq_hi.device)

    outs = (empty(n_planes, 3, n), empty(n_planes, 3, n), empty(3, n),
            empty(3, n), empty(3, n), empty(3, n), empty(n_planes, n),
            empty(n_planes, n))
    if n:
        rc = lib.akbx_detector(
            ptr(consts), n_planes, *[ptr(t) for t in ins], n,
            *[ptr(o) for o in outs], stream(dq_hi))
        raise_on(rc, "detector")
        detector.launches += 1
    return outs


detector.launches = 0
