"""The other mirror systems of akbx_torch against akbx: the KB design
(``kb_define``), the KB, Wolter III+III tandem and alternating builders,
``build_system``, ``build_wolter_3_1``'s plain-f64 and shift_z-bug
placements; ``trace.run`` on every new system through the f64 and the
fast engine (K1 at two and four mirrors, as its twin on the CPU); the
bench loss's gradient; and ``cli trace --system``.  Fans are 9x9.

akbx's fast engine compiles its jnp twin of K1 once per mirror count.
At two mirrors XLA:CPU takes minutes to compile it at its default
optimization level, so akbx's KB runs compile once under an outer
``jax.jit`` at the lowest level (the same function with fewer passes,
~55 s), which also returns the gradient.  akbx's f64 engine's gradient,
the independent witness of the port's (ROADMAP F6), compiles in
~10-20 s a system at the default level."""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from akbx import cli as jcli
from akbx import design as jdesign
from akbx import systems as jsys
from akbx import trace as jtr
from akbx.config import WolterOrdering as JOrdering
from akbx_torch import align
from akbx_torch import cli as tcli
from akbx_torch import convert
from akbx_torch import design as tdesign
from akbx_torch import systems as tsys
from akbx_torch import trace as ttr
from akbx_torch.config import WolterOrdering

torch.set_num_threads(2)

N = 9
SEEDED = np.random.default_rng(1).normal(0.0, 1e-5, 26)
VECS = {"zero": np.zeros(26), "seeded": SEEDED}
KB7 = (146.0, 0.21, 0.16742, 0.180, 0.030, 0.15525, 0.05)
J_KB = jsys.KBSpec.from_kb_define(*KB7)
T_KB = tsys.KBSpec.from_kb_define(*KB7, device="cpu")
GRAD_REL = 1e-3

# name -> (akbx builder, port builder), each of an AlignParams
SYSTEMS = {
    "kb": (lambda p: jsys.build_kb(J_KB, p),
           lambda p: tsys.build_kb(T_KB, p)),
    "tandem": (lambda p: jsys.build_wolter_3_3_tandem(
                   jsys.WOLTER_3_3_TANDEM_DEFAULT, p),
               lambda p: tsys.build_wolter_3_3_tandem(
                   tsys.WOLTER_3_3_TANDEM_DEFAULT, p)),
    "alternating": (lambda p: jsys.build_wolter_3_3_alternating(
                        jsys.WOLTER_3_3_ALT_DEFAULT, p),
                    lambda p: tsys.build_wolter_3_3_alternating(
                        tsys.WOLTER_3_3_ALT_DEFAULT, p)),
    "two_mirror": (lambda p: jsys.build_wolter_3_3_alternating(
                       jsys.WOLTER_3_3_ALT_DEFAULT, p, two_mirror_only=True),
                   lambda p: tsys.build_wolter_3_3_alternating(
                       tsys.WOLTER_3_3_ALT_DEFAULT, p, two_mirror_only=True)),
}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _build(name, vec):
    jb, tb = SYSTEMS[name]
    return (jb(jsys.AlignParams.from_vector(vec)),
            tb(tsys.AlignParams.from_vector(vec, device="cpu")))


def _assert_same_system(t, j):
    """Coefficients to <= 1e-9 of each mirror's largest |coefficient|,
    centers and axes to <= 1e-12 (test_torch_systems.py's bars: the same
    placement formulas in f64, whose libm calls may round differently);
    the fan, source and focal distance to 1e-13 relative."""
    assert len(t.mirrors) == len(j.mirrors)
    for tm, jm in zip(t.mirrors, j.mirrors):
        jc = np.asarray(jm.coeffs)
        np.testing.assert_allclose(_np(tm.coeffs), jc, rtol=0,
                                   atol=1e-9 * np.abs(jc).max())
        np.testing.assert_allclose(_np(tm.center), np.asarray(jm.center),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(_np(tm.axes), np.asarray(jm.axes),
                                   rtol=0, atol=1e-12)
        assert float(tm.branch) == float(jm.branch)
    for f in ("s2f_middle", "fan_h", "fan_v", "source"):
        np.testing.assert_allclose(_np(getattr(t, f)),
                                   np.asarray(getattr(j, f)), rtol=1e-13,
                                   atol=1e-15)
    assert bool(t.valid) == bool(j.valid)


def test_kb_define_matches_akbx():
    """Every field of akbx's KB7 design, <= 1e-12 relative (the same
    closed forms and the same fixed point, ending on the same tol); the
    spec built from it equal to 1e-12 relative, field by field; the NA of
    its first mirror by ``calc_na`` to 1e-12 of itself."""
    j = jdesign.kb_define(*KB7)
    t = tdesign.kb_define(*KB7, device="cpu")
    for f in dataclasses.fields(j):
        a, b = float(getattr(t, f.name)), float(getattr(j, f.name))
        assert abs(a - b) <= 1e-12 * abs(b), (f.name, a, b)
    for f in dataclasses.fields(J_KB):
        a, b = getattr(T_KB, f.name), getattr(J_KB, f.name)
        assert abs(a - b) <= 1e-12 * abs(b), (f.name, a, b)
    assert convert.kb_spec_from_akbx(dataclasses.asdict(J_KB)) == \
        tsys.KBSpec(**dataclasses.asdict(J_KB))
    # calc_na on the first ellipse of the design, as akbx's
    args = (float(j.a_h), float(j.b_h), float(j.theta1_h), KB7[0], KB7[3])
    assert abs(float(tdesign.calc_na(*args, device="cpu"))
               - float(jdesign.calc_na(*args))) <= 1e-12 * float(j.na_h)
    # the design is differentiable in its inputs through the fixed point
    l1h = torch.tensor(KB7[0], dtype=torch.float64, requires_grad=True)
    tdesign.kb_define(l1h, *KB7[1:]).l1v.backward()
    assert torch.isfinite(l1h.grad) and float(l1h.grad) != 0.0


@pytest.mark.parametrize("name", sorted(SYSTEMS))
@pytest.mark.parametrize("vec", sorted(VECS))
def test_builder_matches_akbx(name, vec):
    j, t = _build(name, VECS[vec])
    _assert_same_system(t, j)


def test_setting1_spec_matches_akbx():
    """The second Wolter III+I design equals akbx's field by field, and
    the port places it (the builder itself is held to akbx in
    test_torch_systems.py)."""
    assert tsys.WOLTER_3_1_SETTING1 == tsys.AKBSpec(
        **dataclasses.asdict(jsys.WOLTER_3_1_SETTING1))
    s = tsys.build_wolter_3_1(tsys.WOLTER_3_1_SETTING1,
                              tsys.AlignParams.zeros("cpu"))
    assert bool(s.valid) and len(s.mirrors) == 4


def test_build_system_dispatch():
    """``build_system`` dispatches each ordering's value to its builder,
    and matches akbx's dispatch on the III+III orderings."""
    p = tsys.AlignParams.from_vector(SEEDED, device="cpu")
    pj = jsys.AlignParams.from_vector(SEEDED)
    for ordering, spec, builder in (
            (WolterOrdering.WOLTER_3_1, "WOLTER_3_1_DEFAULT",
             tsys.build_wolter_3_1),
            (WolterOrdering.WOLTER_3_3_TANDEM, "WOLTER_3_3_TANDEM_DEFAULT",
             tsys.build_wolter_3_3_tandem),
            (WolterOrdering.WOLTER_3_3_ALTERNATING, "WOLTER_3_3_ALT_DEFAULT",
             tsys.build_wolter_3_3_alternating)):
        got = tsys.build_system(ordering.value, getattr(tsys, spec), p)
        want = builder(getattr(tsys, spec), p)
        for a, b in zip(got.mirrors, want.mirrors):
            assert torch.equal(a.coeffs, b.coeffs)
        if ordering != WolterOrdering.WOLTER_3_1:   # test_torch_systems.py
            _assert_same_system(got, jsys.build_system(
                JOrdering(ordering.value), getattr(jsys, spec), pj))
    with pytest.raises(ValueError):
        tsys.build_system("wolter_2_2", tsys.WOLTER_3_1_DEFAULT, p)


PLACEMENTS = [(kw, uc) for kw in ("plain_f64", "shift_z_bug")
              for uc in ((False, True, "h") if kw == "plain_f64"
                         else (False,))]


@pytest.mark.parametrize("kw,unit_coupled", PLACEMENTS,
                         ids=[f"{k}-{u}" for k, u in PLACEMENTS])
@pytest.mark.parametrize("vec", sorted(VECS))
def test_build_wolter_3_1_placements_match_akbx(kw, vec, unit_coupled):
    """``precise=False`` in every coupling mode, and ``ref_shift_z_bug``
    (also held at the seeded vector in test_torch_systems.py), against
    akbx's at the builder bars."""
    kw = (dict(precise=False) if kw == "plain_f64"
          else dict(ref_shift_z_bug=True))
    j = jsys.build_wolter_3_1(jsys.WOLTER_3_1_DEFAULT,
                              jsys.AlignParams.from_vector(VECS[vec]),
                              unit_coupled=unit_coupled, **kw)
    t = tsys.build_wolter_3_1(tsys.WOLTER_3_1_DEFAULT,
                              tsys.AlignParams.from_vector(VECS[vec],
                                                           device="cpu"),
                              unit_coupled=unit_coupled, **kw)
    _assert_same_system(t, j)


def _loss(mod, res, dev_fields):
    """bench_common.make_step's losses: on the f32 deviation fields
    (``dev_fields``) or on the f64 fields."""
    tr = jtr if mod == "akbx" else ttr
    where = jnp.where if mod == "akbx" else torch.where
    total = jnp.sum if mod == "akbx" else torch.sum
    if dev_fields:
        w, det = res.w32, res.ddet32
    else:
        w = res.total_dist - tr.masked_mean(res.total_dist, res.valid)
        det = res.detcenter
    sy, sz = tr.spot_size(det, res.valid)
    return total(where(res.valid, w, 0.0) ** 2) * 1e18 + sy + sz


FIELDS = ("detcenter", "detcenter2", "total_dist", "total_dist2", "wave2",
          "valid", "w32", "ddet32")


def _akbx_runs(name, precision, focused=None):
    """akbx's runs at both vectors: {vec: {field: array}}; for KB's fast
    engine, and its gradient, one lowest-level compile (module doc), also
    at the ``focused`` vector."""
    jb = SYSTEMS[name][0]

    def run(vec):
        res = jtr.run(jb(jsys.AlignParams.from_vector(vec)), N, N,
                      defocus=vec[0], exit_pupil_uniform=False,
                      precision=precision)
        return res

    if name == "kb" and precision == "pallas":
        vecs = {**VECS, "focused": focused}
        def loss(vec):
            res = run(vec)
            return _loss("akbx", res, True), {f: getattr(res, f)
                                              for f in FIELDS}

        fn = jax.jit(jax.value_and_grad(loss, has_aux=True),
                     compiler_options={
                         "xla_backend_optimization_level": 0,
                         "xla_llvm_disable_expensive_passes": True})
        out = {}
        for k, v in vecs.items():
            (_, fields), g = fn(jnp.asarray(v))
            out[k] = {f: np.asarray(x) for f, x in fields.items()}
            out[k]["grad"] = np.asarray(g)
        return out
    out = {}
    for k, v in VECS.items():
        res = run(jnp.asarray(v))
        out[k] = {f: np.asarray(getattr(res, f)) for f in FIELDS
                  if getattr(res, f) is not None}
    return out


def _akbx_f64_grads(name, vecs):
    """akbx's ``jax.grad`` of the f64-field bench loss through its f64
    engine (one compile per system, ~10-20 s): {vec: gradient}."""
    jb = SYSTEMS[name][0]

    def loss(v):
        res = jtr.run(jb(jsys.AlignParams.from_vector(v)), N, N,
                      defocus=v[0], exit_pupil_uniform=False,
                      precision="f64")
        return _loss("akbx", res, False)

    fn = jax.jit(jax.grad(loss))
    return {k: np.asarray(fn(jnp.asarray(v))) for k, v in vecs.items()}


@pytest.fixture(scope="module")
def kb_focused():
    return _focused("kb", SEEDED)


@pytest.fixture(scope="module")
def akbx_runs(kb_focused):
    """akbx's f64 runs of every new system and its fast runs of KB,
    tandem and alternating (the two-mirror ordering runs the same
    two-mirror twin as KB, and is held to the f64 engines instead); the
    f64 engine's gradient of every system at the seeded vector, and of
    KB at the focused one (``(name, "grad64")``)."""
    out = {(n, "f64"): _akbx_runs(n, "f64") for n in SYSTEMS}
    for n in ("kb", "tandem", "alternating"):
        out[(n, "pallas")] = _akbx_runs(n, "pallas", kb_focused)
    for n in SYSTEMS:
        vecs = {"seeded": SEEDED, **({"focused": kb_focused}
                                    if n == "kb" else {})}
        out[(n, "grad64")] = _akbx_f64_grads(n, vecs)
    return out


def _port_run(name, vec, precision):
    return ttr.run(_build(name, vec)[1], N, N, defocus=torch.tensor(vec[0]),
                   exit_pupil_uniform=False, precision=precision)


def _demeaned(total, valid):
    total = _np(total)
    return total - total[_np(valid)].mean()


@pytest.mark.parametrize("name", sorted(SYSTEMS))
@pytest.mark.parametrize("vec", sorted(VECS))
def test_run_matches_akbx(akbx_runs, name, vec):
    """The port's f64 engine against akbx's: points of the detector
    planes to 1e-10 m, demeaned OPL to 1e-12 m, valid identical
    (test_torch_trace.py's f64 bars).  The port's fast engine (K1 and K2
    as their twins) against akbx's, where akbx's ran, at akbx's
    fast-vs-f64 bars (detcenter 5e-9 m, demeaned OPL 1e-9 m, w32 2e-9
    m), and against akbx's f64 engine at the same bars everywhere."""
    j64 = akbx_runs[(name, "f64")][vec]
    t64 = _port_run(name, VECS[vec], "f64")
    np.testing.assert_array_equal(_np(t64.valid), j64["valid"])
    assert bool(t64.valid.all())
    for f in ("detcenter", "detcenter2"):
        np.testing.assert_allclose(_np(getattr(t64, f)), j64[f], rtol=0,
                                   atol=1e-10)
    np.testing.assert_allclose(_demeaned(t64.total_dist, t64.valid),
                               _demeaned(j64["total_dist"], j64["valid"]),
                               rtol=0, atol=1e-12)

    t = _port_run(name, VECS[vec], "pallas")
    refs = [j64] + ([akbx_runs[(name, "pallas")][vec]]
                    if (name, "pallas") in akbx_runs else [])
    for ref in refs:
        np.testing.assert_array_equal(_np(t.valid), ref["valid"])
        np.testing.assert_allclose(_np(t.detcenter), ref["detcenter"],
                                   rtol=0, atol=5e-9)
        for f in ("total_dist", "total_dist2"):
            np.testing.assert_allclose(_demeaned(getattr(t, f), t.valid),
                                       _demeaned(ref[f], ref["valid"]),
                                       rtol=0, atol=1e-9)
    np.testing.assert_allclose(_np(t.w32),
                               _demeaned(j64["total_dist"], j64["valid"]),
                               rtol=0, atol=2e-9)
    if len(refs) > 1:
        np.testing.assert_allclose(_np(t.w32), refs[1]["w32"], rtol=0,
                                   atol=2e-9)
        np.testing.assert_allclose(_np(t.ddet32), refs[1]["ddet32"], rtol=0,
                                   atol=5e-9)


def _focused(name, vec):
    """``vec`` after the port's auto_focus at 21 (5 iterations)."""
    build = SYSTEMS[name][1]
    p = align.auto_focus(build, tsys.AlignParams.from_vector(vec,
                                                             device="cpu"),
                         n=21, iters=5)
    return p.to_vector().numpy()



def _port_grad(name, vec, precision="pallas", dev_fields=True):
    v = torch.tensor(vec, dtype=torch.float64, requires_grad=True)
    res = ttr.run(SYSTEMS[name][1](tsys.AlignParams.from_vector(v)), N, N,
                  defocus=v[0], exit_pupil_uniform=False, precision=precision)
    _loss("port", res, dev_fields and precision == "pallas").backward()
    return v.grad.numpy()


def _rel_err(g, ref):
    """Largest |g - ref| over max(|ref|, 1e-6 of ref's largest entry): a
    component that is exactly 0 in both (KB's unused channels) is 0."""
    scale = np.abs(ref).max()
    return float((np.abs(g - ref)
                  / np.maximum(np.abs(ref), scale * 1e-6)).max())


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_bench_loss_gradient(akbx_runs, name):
    """The bench loss's gradient through the fast engine, at akbx's bar
    (1e-3 of each component, floored at 1e-6 of the largest;
    test_torch_backward.py): at the seeded vector, the f64-field loss on
    the port's fast and f64 engines against akbx's ``jax.grad`` through
    akbx's f64 engine (measured <= 8.2e-7); against akbx's fast engine's
    gradient for KB at both vectors; and within the port, as akbx's
    tests/test_trace_pallas.py holds akbx, the f64-field loss on the fast
    engine against the f64 engine and the deviation-field loss against
    the f64-field loss.  KB's gradient is exactly 0 outside its 14
    channels (defocus, astig_h, hyp_v, hyp_h); the bar's floor counts
    those zeros as agreeing."""
    vecs = VECS if name == "kb" else {"seeded": SEEDED}
    for k, vec in vecs.items():
        g = _port_grad(name, vec)
        assert np.isfinite(g).all() and np.abs(g).max() > 0
        if name == "kb":
            assert _rel_err(g, akbx_runs[("kb", "pallas")][k]["grad"]) \
                < GRAD_REL
            assert (g[14:] == 0).all()
    g = _port_grad(name, SEEDED)
    g_fast64 = _port_grad(name, SEEDED, dev_fields=False)
    g_f64 = _port_grad(name, SEEDED, precision="f64")
    j64 = akbx_runs[(name, "grad64")]["seeded"]
    assert _rel_err(g_fast64, j64) < GRAD_REL
    assert _rel_err(g_f64, j64) < GRAD_REL
    assert _rel_err(g_fast64, g_f64) < GRAD_REL
    assert _rel_err(g, g_fast64) < GRAD_REL


def test_backward_twin_precision_at_focus(akbx_runs, kb_focused):
    """ROADMAP F6: at the seeded vector after auto_focus, KB's gradient
    has components near 1e-4 of its largest that a float32 backward twin
    (akbx's) cannot resolve.  With the port's float64 twin the fast
    engine's gradient, for both losses, and the port's f64 engine's meet
    akbx's bar (1e-3, floor 1e-6 of the largest) against akbx's
    ``jax.grad`` through akbx's f64 engine (measured 1.1e-5, 1.3e-5,
    1.3e-5) and against the port's f64 engine; akbx's fast engine's
    gradient misses it by more than 10x (measured 0.24 at 9x9)."""
    j64 = akbx_runs[("kb", "grad64")]["focused"]
    g64 = _port_grad("kb", kb_focused, precision="f64")
    g_fast64 = _port_grad("kb", kb_focused, dev_fields=False)
    g_dev = _port_grad("kb", kb_focused)
    for g in (g_fast64, g_dev, g64):
        assert _rel_err(g, j64) < GRAD_REL
    assert _rel_err(g_fast64, g64) < GRAD_REL
    assert _rel_err(g_dev, g64) < GRAD_REL
    assert _rel_err(akbx_runs[("kb", "pallas")]["focused"]["grad"],
                    j64) > 10 * GRAD_REL


def test_fast_tilt_angles_match_f64_engine(kb_focused):
    """ROADMAP F9: the fast engine's tilt-removal angles and pivot are
    reduced from K1's deviations as hi + lo in f64, not from the f32 hi
    words as akbx's are.  At KB's focused vector on a 16x16 fan the
    angles then agree with the f64 engine's to 1e-13 rad (measured
    1.4e-15; from the hi words 1.8e-9), the detector points to 1e-12 m
    and the demeaned OPL to 1e-12 m (2.3e-14, 5.7e-14; from the hi words
    1.1e-10, 2.0e-12), and the gradient of the f64-field bench loss meets
    akbx's bar against the f64 engine's (from the hi words 1.5e-3 of
    component 12, 1.2e-4 of the largest)."""
    n = 16
    v = torch.tensor(kb_focused)
    res = {p: ttr.run(SYSTEMS["kb"][1](tsys.AlignParams.from_vector(v)), n,
                      n, defocus=v[0], exit_pupil_uniform=False,
                      precision=p) for p in ("pallas", "f64")}
    fast, gold = res["pallas"], res["f64"]
    assert torch.equal(fast.valid, gold.valid)
    for f in ("theta_y", "theta_z"):
        assert abs(float(getattr(fast, f) - getattr(gold, f))) <= 1e-13
    np.testing.assert_allclose(_np(fast.detcenter), _np(gold.detcenter),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(_demeaned(fast.total_dist, fast.valid),
                               _demeaned(gold.total_dist, gold.valid),
                               rtol=0, atol=1e-12)

    def grad(precision):
        w = torch.tensor(kb_focused, requires_grad=True)
        r = ttr.run(SYSTEMS["kb"][1](tsys.AlignParams.from_vector(w)), n, n,
                    defocus=w[0], exit_pupil_uniform=False,
                    precision=precision)
        _loss("port", r, False).backward()
        return w.grad.numpy()

    assert _rel_err(grad("pallas"), grad("f64")) < GRAD_REL


@pytest.fixture(scope="module")
def cli_traces(tmp_path_factory):
    """``cli trace --system s --rays 9 --no-autofocus`` of both packages
    (akbx's default TraceConfig: the f64 engine with the re-fan)."""
    base = tmp_path_factory.mktemp("cli")
    out = {}
    for s in ("kb", "tandem", "alternating"):
        for mod, extra in ((jcli, []), (tcli, ["--device", "cpu"])):
            d = base / f"{s}_{mod.__name__}"
            argv = ["trace", "--system", s, "--rays", str(N),
                    "--no-autofocus", "--out", str(d)] + extra
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert mod.main(argv) == 0
            out[(s, mod is tcli)] = json.loads(
                buf.getvalue().strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("system", ["kb", "tandem", "alternating"])
def test_cli_trace_system_matches_akbx(cli_traces, system):
    """The JSON line of ``cli trace --system``: the same valid rays and
    parameters, PV 6 sigma to 1e-6 of itself, and the wavefront map to
    0.05 nm with NaN at the same places: the f64 engine with the re-fan
    on both sides, whose exit-angle noise moves the map by a few 1e-2 nm
    (ROADMAP F4; measured <= 2.5e-3 nm on maps of ~1e6 nm here, and
    test_torch_analysis.py's ~0.04 nm on the Wolter III+I system)."""
    j, t = cli_traces[(system, False)], cli_traces[(system, True)]
    for k in ("valid_rays", "defocus", "astig_h"):
        assert t[k] == j[k]
    assert t["valid_rays"] == N * N
    assert abs(t["pv_6sigma_lambda"] - j["pv_6sigma_lambda"]) <= \
        1e-6 * abs(j["pv_6sigma_lambda"])
    mats = [np.loadtxt(os.path.join(d["out_dir"], "matrixWave2(nm).txt"))
            for d in (t, j)]
    np.testing.assert_array_equal(np.isnan(mats[0]), np.isnan(mats[1]))
    np.testing.assert_allclose(mats[0], mats[1], rtol=0, atol=0.05,
                               equal_nan=True)
