"""The CUDA kernels K1-K4 and df32.cuh's two_prod on the card against
their PyTorch twins (K1 and K2 on every mirror system's constants), the
fast path and its gradient (Wolter III+I and KB) on the card against the
same on the CPU, the figure and df32 routes on the card, and the Huygens
path on the card against the same on the CPU.

Needs a CUDA card and nvcc; skips otherwise.  This file imports no jax,
so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import statistics
import time

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwad

from akbx_torch import align, graphs, systems, trace, wave
from akbx_torch.core import precision
from akbx_torch.kernels import df32_check
from akbx_torch.kernels import huygens as hk
from akbx_torch.kernels import huygens_f64 as k4
from akbx_torch.kernels import trace_kernel as tk
from akbx_torch.systems import (AlignParams, KBSpec, WOLTER_3_1_DEFAULT,
                                WOLTER_3_3_ALT_DEFAULT,
                                WOLTER_3_3_TANDEM_DEFAULT, build_kb,
                                build_wolter_3_1,
                                build_wolter_3_3_alternating,
                                build_wolter_3_3_tandem, calibrate_uv)

pytestmark = pytest.mark.cuda

# kernel vs twin, per output: the same df32 operations in the same order;
# only rsqrtf's first guess may round differently, and the double-word
# Newton step corrects it
KERNEL_REL = 1e-11
# K3 vs its twin, of the field's scale: the same f32 terms, summed in
# another order inside each 256-source tile (measured <= 5.3e-7)
HUYGENS_REL = 1e-6
# the df32 engine on the card vs on the CPU at 17x17, (detcenter,
# demeaned OPL) m: measured 3.6e-10 m and 4.3e-12 m on an H100
DF32_CARD_BARS = (1e-9, 1e-11)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def consts(dev):
    s = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.zeros(dev))
    rays = trace.ray_fan(trace.fan_angles(s.fan_h, 33),
                         trace.fan_angles(s.fan_v, 33))
    src = s.source[:, None].expand(3, rays.shape[1])
    chief_d0, _, c64 = trace._fast_scalars(s, rays, src, rays.shape[1] // 2)
    (Ms, bvecs, Ds, Dns, Ts, A, Bp, rho, gC, gA, br, Ps) = c64
    scale = (rays - chief_d0).abs().amax(dim=1, keepdim=True)
    return tk.pack_consts(Ms, gC, gA, Ds, Dns, Ts, A, Bp, rho, br,
                          bvecs), Dns[-1], scale


def _assert_match(kernel_out, twin_out, pairs):
    for k in pairs:
        a = kernel_out[k].double() + kernel_out[k + 1].double()
        b = twin_out[k].double() + twin_out[k + 1].double()
        err = float((a - b).abs().max()) if a.numel() else 0.0
        scale = float(b.abs().max()) if b.numel() else 0.0
        assert err <= KERNEL_REL * scale, (k, err, scale)


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 100_003])
def test_kernels_match_twins(dev, consts, n):
    """Ragged tails and block edges: K1 and K2 against their twins."""
    table, D4, scale = consts
    rng = np.random.default_rng(n)
    dd = torch.tensor(rng.uniform(-1, 1, (3, n)), dtype=torch.float64,
                      device=dev) * scale
    dp = torch.tensor(rng.normal(0, 1e-6, (3, n)), dtype=torch.float64,
                      device=dev)
    k1 = tk.trace_deviation(table, dp, dd, 4)
    torch.cuda.synchronize()
    t1 = tk.trace_deviation_reference(table, dp, dd, 4)
    assert torch.equal(k1[8], t1[8])
    _assert_match(k1, t1, range(0, 8, 2))

    R = torch.eye(3, dtype=torch.float64, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    dcon = torch.cat([tk.pack_det_consts(R, D4, torch.tensor(0.2, **f64),
                                         torch.tensor(0.2, **f64)),
                      tk.pack_det_consts(R, D4, torch.tensor(0.201, **f64),
                                         torch.tensor(0.201, **f64))])
    ins = (t1[0][9:12], t1[1][9:12], t1[2][9:12], t1[3][9:12], t1[6], t1[7])
    k2 = tk.detector(dcon, *ins)
    torch.cuda.synchronize()
    _assert_match(k2, tk.detector_reference(dcon, *ins), range(0, 8, 2))


def test_k1_k2_bit_identical_to_twins_at_a_ragged_size(dev, consts):
    """Every output word of K1 and K2 equals the twin's at 100,003 rays:
    the same df32 operations in the same order, the FMA two_prod in both,
    and ``rsqrtf`` behind ``torch.rsqrt`` on the card."""
    table, D4, scale = consts
    n = 100_003
    rng = np.random.default_rng(5)
    dd = torch.tensor(rng.uniform(-1, 1, (3, n)), dtype=torch.float64,
                      device=dev) * scale
    dp = torch.tensor(rng.normal(0, 1e-6, (3, n)), dtype=torch.float64,
                      device=dev)
    k1 = tk.trace_deviation(table, dp, dd, 4)
    t1 = tk.trace_deviation_reference(table, dp, dd, 4)
    for k, (a, b) in enumerate(zip(k1, t1)):
        assert torch.equal(a, b), f"K1 output {k}"
    R = torch.eye(3, dtype=torch.float64, device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    dcon = torch.cat([tk.pack_det_consts(R, D4, torch.tensor(0.2, **f64),
                                         torch.tensor(0.2, **f64)),
                      tk.pack_det_consts(R, D4, torch.tensor(0.201, **f64),
                                         torch.tensor(0.201, **f64))])
    ins = (t1[0][9:12], t1[1][9:12], t1[2][9:12], t1[3][9:12], t1[6], t1[7])
    for k, (a, b) in enumerate(zip(tk.detector(dcon, *ins),
                                   tk.detector_reference(dcon, *ins))):
        assert torch.equal(a, b), f"K2 output {k}"


@pytest.mark.parametrize("n_mirr", [1, 2, 3, 8])
def test_k1_every_mirror_count(dev, consts, n_mirr):
    """K1 is instantiated per mirror count: 1, 2, 3 and the largest, 8
    (the table's four rows twice), against the twin."""
    table, _, scale = consts
    rows = torch.cat([table, table])[:n_mirr].contiguous()
    rng = np.random.default_rng(n_mirr)
    n = 1000
    dd = torch.tensor(rng.uniform(-1, 1, (3, n)), dtype=torch.float64,
                      device=dev) * scale * 1e-3
    dp = torch.tensor(rng.normal(0, 1e-7, (3, n)), dtype=torch.float64,
                      device=dev)
    k1 = tk.trace_deviation(rows, dp, dd, n_mirr)
    torch.cuda.synchronize()
    t1 = tk.trace_deviation_reference(rows, dp, dd, n_mirr)
    assert k1[0].shape == (3 * n_mirr, n) and k1[4].shape == (n_mirr, n)
    assert torch.equal(k1[8], t1[8])
    _assert_match(k1, t1, range(0, 8, 2))


def test_k1_refuses_a_second_stream_while_running(dev, consts):
    """K1's constants table is one ``__constant__`` symbol per card: a
    launch from another stream while the last may still run raises, and
    goes through once that launch has finished."""
    table, _, scale = consts
    n = 4_000_000
    dd = torch.zeros(3, n, dtype=torch.float64, device=dev)
    tk.trace_deviation(table, dd, dd, 4)
    torch.cuda.synchronize()
    other = torch.cuda.Stream(dev)
    tk.trace_deviation(table, dd, dd, 4)
    with torch.cuda.stream(other):
        with pytest.raises(RuntimeError, match="one stream"):
            tk.trace_deviation(table, dd, dd, 4)
        torch.cuda.synchronize()
        out = tk.trace_deviation(table, dd, dd, 4)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out[0]).all())


def test_two_prod_entry_point_matches_twin(dev):
    """df32.cuh's two_prod against the twin's, bit for bit: 4,000,003
    seeded pairs over 2^-63..2^63 with signed zeros, so products down to
    2^-126 and subnormal error terms."""
    rng = np.random.default_rng(6)
    n = 4_000_003

    def operand():
        x = rng.uniform(-1, 1, n) * 2.0 ** rng.integers(-62, 63, n)
        x[::1009] = 0.0
        x[::2003] = -0.0
        return torch.tensor(x.astype(np.float32), device=dev)

    a, b = operand(), operand()
    got = df32_check.two_prod(a, b)
    torch.cuda.synchronize()
    want = precision.two_prod(a, b)
    tiny = torch.finfo(torch.float32).tiny
    assert bool(((want.lo != 0) & (want.lo.abs() < tiny)).any())
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    # and the twin on the card equals the twin on the CPU
    cpu = precision.two_prod(a.cpu(), b.cpu())
    for w, c in zip(want, cpu):
        assert torch.equal(w.cpu().view(torch.int32), c.view(torch.int32))


def test_wrappers_count_and_check(dev, consts):
    table, _, _ = consts
    d = torch.zeros(3, 10, dtype=torch.float64, device=dev)
    before = tk.trace_deviation.launches
    tk.trace_deviation(table, d, d, 4)
    assert tk.trace_deviation.launches == before + 1
    with pytest.raises(ValueError):
        tk.trace_deviation(table, d.float(), d, 4)
    with pytest.raises(ValueError):
        tk.trace_deviation(table, d, d.cpu(), 4)


def test_fast_path_card_matches_cpu(dev):
    """The whole slice at 33x33 on the card (kernels) and on the CPU
    (twins): the kernels match the twins bit for bit, but the float32
    tilt-angle mean sums in another order on the card (~1e-9 rad over a
    ~0.2 m lever arm; measured 3.6e-10 m on detcenter); 1e-9 m."""
    vec = np.random.default_rng(1).normal(0.0, 1e-5, 26)
    out = []
    for d in (dev, torch.device("cpu")):
        s = build_wolter_3_1(WOLTER_3_1_DEFAULT,
                             AlignParams.from_vector(vec, device=d))
        out.append(trace.run(s, 33, 33, defocus=float(vec[0]),
                             exit_pupil_uniform=False, precision="pallas"))
    for f in ("detcenter", "detcenter2", "w32", "w32_2"):
        a, b = getattr(out[0], f).cpu().double(), getattr(out[1], f).double()
        assert float((a - b).abs().max()) <= 1e-9, f
    assert torch.equal(out[0].valid.cpu(), out[1].valid)


@pytest.mark.parametrize("refan", [False, True], ids=["flat", "refan"])
def test_fast_path_gradient_card_matches_cpu(dev, refan):
    """The bench loss's gradient through the fast path at 33x33 on the
    card (K1 and K2 forward, the plain-f32 twin's VJP on the card) against
    the same on the CPU (the twins): K1 launches once (twice with the
    re-fan), K2 once, the backward none; the f32 sums of the tilt mean and
    of the backward run in another order, so each component agrees to the
    bar against the f64 engine: 1e-3, floored at 1e-6 of the largest."""
    vec = np.random.default_rng(1).normal(0.0, 1e-5, 26)
    grads = []
    for d in (dev, torch.device("cpu")):
        v = torch.tensor(vec, device=d, requires_grad=True)
        s = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.from_vector(v))
        k1, k2 = tk.trace_deviation.launches, tk.detector.launches
        r = trace.run(s, 33, 33, defocus=v[0], exit_pupil_uniform=refan,
                      precision="pallas")
        sy, sz = trace.spot_size(r.ddet32, r.valid)
        loss = torch.sum(torch.where(r.valid, r.w32, 0.0) ** 2) * 1e18 + sy + sz
        loss.backward()
        torch.cuda.synchronize()
        if d == dev:
            assert (tk.trace_deviation.launches - k1,
                    tk.detector.launches - k2) == (2 if refan else 1, 1)
        grads.append(v.grad.cpu().numpy())
    card, cpu = grads
    assert np.isfinite(card).all()
    scale = np.abs(cpu).max()
    assert (np.abs(card - cpu)
            / np.maximum(np.abs(cpu), 1e-6 * scale)).max() < 1e-3


KB7 = (146.0, 0.21, 0.16742, 0.180, 0.030, 0.15525, 0.05)
SYSTEMS = {
    "kb": lambda p: build_kb(KBSpec.from_kb_define(*KB7, device="cpu"), p),
    "tandem": lambda p: build_wolter_3_3_tandem(WOLTER_3_3_TANDEM_DEFAULT, p),
    "alternating": lambda p: build_wolter_3_3_alternating(
        WOLTER_3_3_ALT_DEFAULT, p),
    "two_mirror": lambda p: build_wolter_3_3_alternating(
        WOLTER_3_3_ALT_DEFAULT, p, two_mirror_only=True),
}


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_k1_k2_bit_identical_on_every_system(dev, name):
    """K1 (at two mirrors for KB and the two-mirror ordering, four for the
    III+III orderings) and K2 on each system's own constants: every output
    word equals the twin's, on a 33x33 fan and on 10,003 seeded rays."""
    vec = np.random.default_rng(1).normal(0.0, 1e-5, 26)
    s = SYSTEMS[name](AlignParams.from_vector(vec, device=dev))
    rays = trace.ray_fan(trace.fan_angles(s.fan_h, 33),
                         trace.fan_angles(s.fan_v, 33))
    src = s.source[:, None].expand(3, rays.shape[1])
    chief_d0, chief_p0, c64 = trace._fast_scalars(s, rays, src,
                                                  rays.shape[1] // 2)
    (Ms, bvecs, Ds, Dns, Ts, A, Bp, rho, gC, gA, br, Ps) = c64
    table = tk.pack_consts(Ms, gC, gA, Ds, Dns, Ts, A, Bp, rho, br, bvecs)
    n_mirr = len(s.mirrors)
    assert table.shape == (n_mirr, 64)
    dd_fan = (rays - chief_d0).contiguous()
    rng = np.random.default_rng(9)
    n = 10_003
    dd = torch.tensor(rng.uniform(-1, 1, (3, n)), dtype=torch.float64,
                      device=dev) * dd_fan.abs().amax(dim=1, keepdim=True)
    dp = torch.tensor(rng.normal(0, 1e-6, (3, n)), dtype=torch.float64,
                      device=dev)
    for dp_, dd_ in (((src - chief_p0).contiguous(), dd_fan), (dp, dd)):
        k1 = tk.trace_deviation(table, dp_, dd_, n_mirr)
        t1 = tk.trace_deviation_reference(table, dp_, dd_, n_mirr)
        for k, (a, b) in enumerate(zip(k1, t1)):
            assert torch.equal(a, b), f"K1 output {k}"
        last = slice(3 * n_mirr - 3, 3 * n_mirr)
        R = trace._tilt_rotation(torch.tensor(1e-4, dtype=torch.float64,
                                              device=dev),
                                 torch.tensor(-2e-4, dtype=torch.float64,
                                              device=dev))
        f64 = dict(dtype=torch.float64, device=dev)
        dcon = torch.cat([tk.pack_det_consts(R, Dns[-1],
                                             torch.tensor(0.2, **f64),
                                             torch.tensor(0.2, **f64)),
                          tk.pack_det_consts(R, Dns[-1],
                                             torch.tensor(0.21, **f64),
                                             torch.tensor(0.21, **f64))])
        ins = (t1[0][last], t1[1][last], t1[2][last], t1[3][last], t1[6],
               t1[7])
        ins = tuple(t.contiguous() for t in ins)
        for k, (a, b) in enumerate(zip(tk.detector(dcon, *ins),
                                       tk.detector_reference(dcon, *ins))):
            assert torch.equal(a, b), f"K2 output {k}"


def test_kb_fast_path_gradient_card_matches_cpu(dev):
    """The bench loss's gradient through KB's fast path at 33x33 (K1 at
    two mirrors) on the card against the CPU's: K1 and K2 launch once
    each, and each component agrees to 1e-3, floored at 1e-6 of the
    largest; the 12 channels that drive no KB mirror are 0 on both."""
    vec = np.random.default_rng(1).normal(0.0, 1e-5, 26)
    grads = []
    for d in (dev, torch.device("cpu")):
        v = torch.tensor(vec, device=d, requires_grad=True)
        s = SYSTEMS["kb"](AlignParams.from_vector(v))
        k1, k2 = tk.trace_deviation.launches, tk.detector.launches
        r = trace.run(s, 33, 33, defocus=v[0], exit_pupil_uniform=False,
                      precision="pallas")
        sy, sz = trace.spot_size(r.ddet32, r.valid)
        loss = torch.sum(torch.where(r.valid, r.w32, 0.0) ** 2) * 1e18 + sy + sz
        loss.backward()
        if d == dev:
            torch.cuda.synchronize()
            assert (tk.trace_deviation.launches - k1,
                    tk.detector.launches - k2) == (1, 1)
        grads.append(v.grad.cpu().numpy())
    card, cpu = grads
    assert np.isfinite(card).all() and (card[14:] == 0).all()
    scale = np.abs(cpu).max()
    assert (np.abs(card - cpu)
            / np.maximum(np.abs(cpu), 1e-6 * scale)).max() < 1e-3


def test_figure_and_df32_routes_on_the_card(dev):
    """With figure errors, run(precision="pallas") launches no kernel (K1
    does not model figures).  It, the f64 engine and the df32 engine on
    the figure-free system, all without the re-fan at 17x17, agree with
    the same runs on the CPU.  The same tensor ops run on both, but the
    card's tan, sin, cos and atan round differently by an ulp, and the
    f64 engine amplifies such rounding at grazing incidence (its own
    noise is ~2.8e-10 m rms of OPL, akbx's tests/test_trace_df.py): the
    figure route and the figure-free f64 engine, its witness, to 1e-9 m
    of detcenter and 1e-10 m of demeaned OPL, the card-vs-CPU bar of the
    fast path above (measured: figure route 5.6e-10 m and 5.7e-11 m).
    The df32 engine takes only its chief ray through libm and its square
    roots may differ by an ulp: its own bars, DF32_CARD_BARS (its
    detector points, reduced and tilted by the f64 engine's functions,
    read as far apart as the f64 engine's: 3.6e-10 m against 5.4e-10 m;
    its OPL 13x closer: 4.3e-12 m against 5.6e-11 m)."""
    fig = np.random.default_rng(7).normal(0.0, 1e-9, (3, 3))
    out = []
    for d in (dev, torch.device("cpu")):
        s = calibrate_uv(build_wolter_3_1(WOLTER_3_1_DEFAULT,
                                          AlignParams.zeros(d)))
        m0 = s.mirrors[0]._replace(fig_coeffs=torch.tensor(fig, device=d))
        sf = s._replace(mirrors=(m0,) + s.mirrors[1:])
        k1, k2 = tk.trace_deviation.launches, tk.detector.launches
        kw = dict(defocus=0.0, exit_pupil_uniform=False)
        rf = trace.run(sf, 17, 17, precision="pallas", **kw)
        if d == dev:
            torch.cuda.synchronize()
            assert (tk.trace_deviation.launches, tk.detector.launches) == \
                (k1, k2)
        out.append((rf, trace.run(s, 17, 17, precision="f64", **kw),
                    trace.run(s, 17, 17, precision="df32", **kw)))
    bars = {"figure": (1e-9, 1e-10), "f64": (1e-9, 1e-10),
            "df32": DF32_CARD_BARS}
    errs = {}
    for name, a, b in zip(bars, out[0], out[1]):
        assert torch.equal(a.valid.cpu(), b.valid)
        wa = a.total_dist.cpu() - a.total_dist.cpu().mean()
        wb = b.total_dist - b.total_dist.mean()
        errs[name] = (float((a.detcenter.cpu() - b.detcenter).abs().max()),
                      float((wa - wb).abs().max()))
    print("card vs CPU, (detcenter, demeaned OPL) m:", errs)
    for name, (e_det, e_opl) in errs.items():
        assert e_det <= bars[name][0] and e_opl <= bars[name][1], \
            (name, e_det, e_opl)


def _huygens_inputs(dev, n, m, lam, seed):
    """Re-centred df32 rows of a seeded source / target cloud (sources
    near 145 m, targets near 146 m) and the wavenumber pair."""
    rng = np.random.default_rng(seed)
    src = np.array([145.0, 0.02, 0.0])[:, None] + rng.normal(size=(3, m)) * 0.05
    tgt = np.array([146.0, 0.05, 0.01])[:, None] + rng.normal(size=(3, n)) * 0.02
    w = np.vstack([rng.normal(size=m), rng.normal(size=m)]) * 1e-8
    center = np.concatenate([src, tgt], axis=1).mean(axis=1, keepdims=True)
    k = 2 * np.pi / lam
    k_pair = np.array([np.float32(k), np.float32(k - float(np.float32(k)))])

    def rows(x):
        return hk._split_rows(torch.tensor(x - center, device=dev))

    return (rows(tgt), rows(src),
            torch.tensor(w, dtype=torch.float32, device=dev),
            torch.tensor(k_pair))


@pytest.mark.parametrize("lam", [13.5e-9, 0.135e-9], ids=["euv", "hard"])
@pytest.mark.parametrize("n,m", [(0, 5), (7, 0), (1, 1), (255, 257),
                                 (256, 256), (1025, 4099), (3000, 1)])
def test_huygens_matches_twin(dev, lam, n, m):
    """K3 against its twin at ragged target / source counts: within
    HUYGENS_REL of the field's scale, and bit for bit with one source
    (each sum is then one term: the same df32 ops, the same sinf)."""
    ins = _huygens_inputs(dev, n, m, lam, n + m)
    before = hk.huygens.launches
    k = hk.huygens(*ins)
    torch.cuda.synchronize()
    assert hk.huygens.launches == before + (1 if n else 0)
    t = hk.huygens_reference(*ins)
    for a, b in zip(k, t):
        assert a.dtype == torch.float64 and a.shape == (n,)
        if m == 1:
            assert torch.equal(a, b)
        scale = float(b.abs().max()) if n else 0.0
        assert float((a - b).abs().max() if n else 0.0) <= HUYGENS_REL * scale


def test_huygens_checks_and_never_runs_the_twin(dev, monkeypatch):
    ins = _huygens_inputs(dev, 10, 20, 13.5e-9, 0)

    def boom(*a, **k):
        raise AssertionError("the twin ran for CUDA tensors")

    monkeypatch.setattr(hk, "huygens_reference", boom)
    hk.huygens(*ins)
    with pytest.raises(ValueError):
        hk.huygens(ins[0].double(), *ins[1:])
    with pytest.raises(ValueError):
        hk.huygens(ins[0], ins[1].cpu(), *ins[2:])
    with pytest.raises(ValueError):
        hk.huygens(ins[0][:, ::2], *ins[1:])
    with pytest.raises(ValueError):   # the wavenumber stays on the host
        hk.huygens(*ins[:3], ins[3].to(dev))


def test_huygens_path_card_matches_cpu(dev):
    """propagate on the card (K3) and on the CPU (the twin), 600 x 500:
    the same terms summed in another order, <= 1e-6 of the field."""
    rng = np.random.default_rng(4)
    pts = np.array([145.0, 0.02, 0.0])[:, None] + rng.normal(size=(3, 600)) * 0.05
    tgt = np.array([146.0, 0.05, 0.01])[:, None] + rng.normal(size=(3, 500)) * 0.02
    u = rng.normal(size=600) + 1j * rng.normal(size=600)
    ds = np.abs(rng.normal(size=600)) * 1e-8
    out = []
    for d in (dev, torch.device("cpu")):
        src = wave.WaveField.from_complex(pts, u, ds, device=d)
        out.append(torch.complex(*wave.propagate(
            src, torch.tensor(tgt, device=d), 13.5e-9)).cpu())
    assert float((out[0] - out[1]).abs().max()) <= 1e-6 * float(
        out[1].abs().max())


# --- K4, the exact-f64 Huygens tile of huygens_ring -------------------------

# K4 vs its twin, of the field's scale.  Per pair both run the same f64
# operations, so r, the reduced phase and 1/r agree bit for bit (the
# double-word k r's lo word is an FMA in the kernel and Dekker's partial
# products in the twin: the same exact pair); sin and cos may differ by an
# ulp.  The rest is the order of the sums: the kernel adds each 512-source
# split's terms one by one and then the splits, the twin contracts each
# target chunk with matrix-vector products.  Either order rounds each of
# the m additions at ~1e-16 of the running sum: at the ring's 16,520
# sources ~1e-12 of the field, even where the terms cancel a hundredfold.
K4_REL = 1e-9


def _k4_inputs(dev, geometry, n, m, seed):
    """Seeded f64 sources and targets at akbx's EUV distances, absolute
    coordinates as the ring holds them: ``m1`` sources within 1 mm of the
    point source and targets on a 4-cm mirror 146 m away; ``focus``
    sources on a 4-cm M4 and targets on a +-1 um focal grid 0.1 m on."""
    rng = np.random.default_rng(seed)
    if geometry == "m1":
        src = rng.normal(size=(3, m)) * 1e-3
        tgt = (np.array([146.0, 0.03, 0.01])[:, None]
               + rng.normal(size=(3, n)) * np.array([[0.02], [1e-3], [1e-3]]))
    else:
        src = (np.array([146.3, 0.01, 0.005])[:, None]
               + rng.normal(size=(3, m)) * np.array([[0.02], [2e-4], [2e-4]]))
        tgt = (np.array([146.4, 0.0, 0.0])[:, None]
               + rng.uniform(-1e-6, 1e-6, size=(3, n)))
    w = rng.normal(size=(2, m)) * 1e-8
    t = [torch.tensor(x, dtype=torch.float64, device=dev)
         for x in (tgt, src, w[0], w[1])]
    return t[0], t[1], t[2], t[3], 2.0 * np.pi / 13.5e-9


def _k4(ins):
    n = ins[0].shape[1]
    acc = torch.zeros((2, n), dtype=torch.float64, device=ins[0].device)
    k4.huygens_f64(*ins, acc[0], acc[1])
    torch.cuda.synchronize()
    return acc


def _k4_twin(ins):
    n = ins[0].shape[1]
    acc = torch.zeros((2, n), dtype=torch.float64, device=ins[0].device)
    k4.huygens_f64_reference(*ins, acc[0], acc[1])
    return acc


@pytest.mark.parametrize("geometry", ["m1", "focus"])
@pytest.mark.parametrize("n,m", [(1, 1), (255, 257), (256, 512), (257, 513),
                                 (1000, 1537), (16520, 16520)])
def test_k4_matches_twin(dev, geometry, n, m):
    """K4 against its twin on the card at ragged target and source counts
    (not multiples of the block's 256 targets, the 256-source tile or the
    512-source split) and at the ring's tile, within K4_REL of the field;
    one launch a call."""
    ins = _k4_inputs(dev, geometry, n, m, n + m)
    before = k4.huygens_f64.launches
    got = _k4(ins)
    assert k4.huygens_f64.launches == before + 1
    want = _k4_twin(ins)
    assert torch.isfinite(got).all()
    scale = float(torch.complex(want[0], want[1]).abs().max())
    err = float(torch.complex(got[0] - want[0], got[1] - want[1]).abs().max())
    assert err <= K4_REL * scale, (err, scale)


@pytest.mark.parametrize("m", [9, 510, 512, 1030])
def test_k4_zero_weight_padding_adds_exactly_nothing(dev, m):
    """The ring pads each source block with zero-weight sources at the
    origin: with and without 7 of them (inside a split, crossing into a
    new one) the sums are the same bits."""
    tgt, src, w_re, w_im, k = _k4_inputs(dev, "m1", 700, m, m)
    pad = torch.zeros(7, dtype=torch.float64, device=dev)
    padded = (tgt, torch.cat([src, torch.zeros((3, 7), dtype=torch.float64,
                                               device=dev)], dim=1),
              torch.cat([w_re, pad]), torch.cat([w_im, pad]), k)
    assert torch.equal(_k4((tgt, src, w_re, w_im, k)), _k4(padded))


def test_k4_repeats_bit_for_bit_in_any_target_chunking(dev, monkeypatch):
    """No atomics: two runs give the same bits, and so does a launch per
    chunk of targets when the scratch cap forces chunks (one launch each)."""
    ins = _k4_inputs(dev, "focus", 3000, 2100, 7)
    a, b = _k4(ins), _k4(ins)
    assert torch.equal(a.view(torch.int64), b.view(torch.int64))
    splits = -(-2100 // k4.SPLIT)
    monkeypatch.setattr(k4, "SCRATCH_BYTES", 2 * splits * 8 * 1100)
    before = k4.huygens_f64.launches
    c = _k4(ins)
    assert k4.huygens_f64.launches == before + 3   # 1100, 1100, 800
    assert torch.equal(a.view(torch.int64), c.view(torch.int64))


def test_k4_counts_checks_and_never_runs_the_twin(dev, monkeypatch):
    """A launch a call with targets and sources, none without; CUDA
    tensors never reach the twin; f32, mixed devices and non-contiguous
    inputs raise."""
    def boom(*a, **kw):
        raise AssertionError("the twin ran for CUDA tensors")

    monkeypatch.setattr(k4, "huygens_f64_reference", boom)
    tgt, src, w_re, w_im, k = _k4_inputs(dev, "m1", 10, 20, 0)
    before = k4.huygens_f64.launches
    _k4((tgt, src, w_re, w_im, k))
    _k4((tgt[:, :0].contiguous(), src, w_re, w_im, k))
    _k4((tgt, src[:, :0].contiguous(), w_re[:0], w_im[:0], k))
    assert k4.huygens_f64.launches == before + 1
    acc = torch.zeros((2, 10), dtype=torch.float64, device=dev)
    for bad in ((tgt.float(), src, w_re, w_im),
                (tgt, src.cpu(), w_re, w_im),
                (tgt, src, w_re.float(), w_im),
                (torch.zeros((20, 3), dtype=torch.float64,
                             device=dev).t()[:, ::2], src, w_re, w_im)):
        with pytest.raises(ValueError):
            k4.huygens_f64(*bad, k, acc[0], acc[1])


def test_huygens_ring_on_the_card_matches_the_twin_path(dev, tmp_path):
    """A one-rank huygens_ring on an NCCL group: K4 once, against the twin
    on the same targets and sources, within K4_REL of the field.  An input
    that requires grad raises under grad mode and launches nothing."""
    import torch.distributed as dist

    from akbx_torch.parallel import sharding as sh

    ins = _k4_inputs(dev, "focus", 4100, 3000, 11)
    tgt, src, w_re, w_im, _ = ins
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = sh.ray_mesh(device_type="cuda")
        before = k4.huygens_f64.launches
        got = sh.huygens_ring(src, w_re, w_im, tgt, 13.5e-9, mesh)
        torch.cuda.synchronize()
        assert k4.huygens_f64.launches == before + 1
        with pytest.raises(ValueError, match="gradient"):
            sh.huygens_ring(src, w_re.clone().requires_grad_(True), w_im,
                            tgt, 13.5e-9, mesh)
        assert k4.huygens_f64.launches == before + 1
    finally:
        dist.destroy_process_group()
    want = _k4_twin(ins)
    g, w = torch.complex(*got), torch.complex(want[0], want[1])
    assert float((g - w).abs().max()) <= K4_REL * float(w.abs().max())


@pytest.mark.parametrize("inp", [0, 1, 2, 3])
def test_k4_refuses_inputs_that_require_grad(dev, inp):
    """K4 records no gradient: an input that requires grad raises under
    grad mode and launches nothing; under no_grad the call runs."""
    ins = list(_k4_inputs(dev, "m1", 40, 30, 3))
    ins[inp] = ins[inp].clone().requires_grad_(True)
    acc = torch.zeros((2, 40), dtype=torch.float64, device=dev)
    before = k4.huygens_f64.launches
    with pytest.raises(ValueError, match="gradient"):
        k4.huygens_f64(*ins, acc[0], acc[1])
    assert k4.huygens_f64.launches == before
    assert torch.equal(acc, torch.zeros_like(acc))
    with torch.no_grad():
        k4.huygens_f64(*ins, acc[0], acc[1])
    assert k4.huygens_f64.launches == before + 1


# --- the III+I placement replayed from CUDA graphs (akbx_torch.graphs) ---

def _graphed(p):
    return build_wolter_3_1(WOLTER_3_1_DEFAULT, p)


def _eager(p):
    """The same build, its placement run eagerly: ``graphs.call`` runs
    eagerly under forward-mode AD."""
    with fwad.dual_level():
        return build_wolter_3_1(WOLTER_3_1_DEFAULT, p)


def _bits(a, b):
    """Equal bit for bit (signed zeros included)."""
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return a.shape == b.shape and torch.equal(a, b)


def _bench_step(build, vec, dev, n=33):
    """The align cell's step at ``vec`` on an ``n`` x ``n`` fan: the
    system and the gradient of the bench loss."""
    v = torch.tensor(vec, device=dev, requires_grad=True)
    s = build(AlignParams.from_vector(v))
    r = trace.run(s, n, n, defocus=v[0], exit_pupil_uniform=False,
                  tilt_correction=True, precision="pallas")
    sy, sz = trace.spot_size(r.ddet32, r.valid)
    (torch.sum(torch.where(r.valid, r.w32, 0.0) ** 2) * 1e18
     + sy + sz).backward()
    return s, v.grad


def _mirror_loss(s):
    """A loss on every mirror's coefficients and center."""
    w = torch.Generator().manual_seed(0)
    dev = s.valid.device
    return sum((m.coeffs * torch.randn(10, generator=w, dtype=torch.float64)
                .to(dev)).sum()
               + (m.center * torch.randn(3, generator=w, dtype=torch.float64)
                  .to(dev)).sum() for m in s.mirrors)


def test_placement_graph_bit_identical_to_eager(dev):
    """On 8 vectors drawn as the align cell draws them, the graphed build
    returns the eager build's coefficients, centers, axes and ``valid``
    and the bench loss's gradient, bit for bit."""
    rng = np.random.default_rng(1717)
    replays, eager = graphs.replays, graphs.eager
    for _ in range(8):
        vec = rng.normal(0.0, 1e-5, 26)
        (sg, gg), (se, ge) = (_bench_step(b, vec, dev)
                              for b in (_graphed, _eager))
        for mg, me in zip(sg.mirrors, se.mirrors):
            for f in ("coeffs", "center", "axes"):
                assert _bits(getattr(mg, f), getattr(me, f)), f
        assert _bits(sg.valid, se.valid) and bool(sg.valid)
        assert _bits(gg, ge)
    assert (graphs.replays - replays, graphs.eager - eager) == (8, 8)


def test_placement_graph_returns_fresh_tensors(dev):
    """A step's tensors and gradient outlive the next step's replays; a
    backward after a later replay of its graph runs the placement again
    eagerly, and gives the eager gradient."""
    rng = np.random.default_rng(1718)
    vs = [torch.tensor(rng.normal(0.0, 1e-5, 26), device=dev,
                       requires_grad=True) for _ in range(2)]
    s1 = _graphed(AlignParams.from_vector(vs[0]))
    kept = [t.clone() for m in s1.mirrors for t in m]
    s2 = _graphed(AlignParams.from_vector(vs[1]))
    assert all(_bits(a, b) for a, b in
               zip(kept, [t for m in s1.mirrors for t in m]))
    assert not torch.equal(s1.mirrors[0].coeffs, s2.mirrors[0].coeffs)
    eager = graphs.eager
    _mirror_loss(s1).backward()
    assert graphs.eager == eager + 1
    g1 = vs[0].grad.clone()
    _mirror_loss(s2).backward()
    assert graphs.eager == eager + 1
    assert _bits(vs[0].grad, g1)
    for v in vs:
        w = v.detach().clone().requires_grad_(True)
        _mirror_loss(_eager(AlignParams.from_vector(w))).backward()
        assert _bits(w.grad, v.grad)


def test_placement_graph_counts(dev, monkeypatch):
    """N steps from a fresh layout: one capture, N replays, no eager
    placement."""
    monkeypatch.setattr(systems, "_LAYOUTS", {})
    rng = np.random.default_rng(1719)
    before = (graphs.captures, graphs.replays, graphs.eager)
    for _ in range(5):
        v = torch.tensor(rng.normal(0.0, 1e-5, 26), device=dev,
                         requires_grad=True)
        _mirror_loss(_graphed(AlignParams.from_vector(v))).backward()
        assert torch.isfinite(v.grad).all()
    assert (graphs.captures - before[0], graphs.replays - before[1],
            graphs.eager - before[2]) == (1, 5, 0)


def test_value_and_jacobian_graphed_equals_eager(dev):
    """``align._value_and_jacobian`` runs one backward a row through one
    forward (``retain_graph``): its rows are eager's, bit for bit."""
    w = torch.randn((4, 10), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64).to(dev)

    def metric(build):
        def fn(p):
            s = build(AlignParams.from_vector(p))
            rows = [(m.coeffs * w[i]).sum() for i, m in enumerate(s.mirrors)]
            return torch.stack(rows + [s.mirrors[2].center.sum(),
                                       s.mirrors[3].center.sum()])
        return fn

    vec = torch.tensor(np.random.default_rng(1720).normal(0.0, 1e-5, 26),
                       device=dev)
    idx = list(range(1, 26))
    replays = graphs.replays
    mg, Jg = align._value_and_jacobian(metric(_graphed), vec, idx)
    assert graphs.replays == replays + 1
    me, Je = align._value_and_jacobian(metric(_eager), vec, idx)
    assert _bits(mg, me) and _bits(Jg, Je)


def test_placement_graph_times(dev):
    """Prints the placement's forward and backward ms, eager and graphed
    (host clock around work that ends in a synchronize; medians of 10)."""
    lay = systems._layout_3_1(WOLTER_3_1_DEFAULT, (0.0, 0.0, 0.0), "theta1",
                              True, False, dev)
    v = torch.tensor(np.random.default_rng(1721).normal(0.0, 1e-5, 26),
                     device=dev, requires_grad=True)
    p = AlignParams.from_vector(v)
    ins = (p.astig_h, p.hyp_v, p.hyp_h, p.ell_v, p.ell_h)
    runs = {"eager": lambda: systems._place_3_1(lay, False, *ins),
            "graphed": lambda: graphs.call(
                lay.graphs, False,
                lambda *x: systems._place_3_1(lay, False, *x), ins)}
    for name, run in runs.items():
        fwd, bwd = [], []
        for i in range(12):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = run()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            torch.autograd.backward(outs[:6],
                                    [torch.ones_like(o) for o in outs[:6]])
            torch.cuda.synchronize()
            if i >= 2:
                fwd.append((t1 - t0) * 1e3)
                bwd.append((time.perf_counter() - t1) * 1e3)
        print(f"\nplacement {name} ({torch.cuda.get_device_name(dev)}): "
              f"forward {statistics.median(fwd):.3f} ms, backward "
              f"{statistics.median(bwd):.3f} ms")
