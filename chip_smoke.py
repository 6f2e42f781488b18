#!/usr/bin/env python3
"""Smoke test of akbx_torch on one CUDA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, one printed line or more each:
  1. the card (nvidia-smi name and power limit); TF32 matmul must be off;
  2. build the CUDA kernels from akbx_torch/csrc (first use); their PTX
     must hold no approximate sin, cos, division or square root and no
     flush-to-zero (K1's one rsqrt.approx is df_rsqrt's first guess), and
     K3's FMAs must be those of sinf, cosf and its two_prods;
  3. df32.cuh's two_prod on 1e8 seeded pairs against the twin's, bit for
     bit; then each kernel against its plain PyTorch twin on the card, at
     the main path's shapes: the deviations of a 2048x2048 fan (4,194,304
     rays), and a seeded random set of the same scale at a ragged
     1,000,003;
  4. the forward main path: build_wolter_3_1 -> trace.run(precision=
     "pallas") at a 2048x2048 fan from a seeded misalignment, with the
     bench loss; it must launch K1 once and K2 once;
  5. the same fan through the port's f64 golden, against akbx's bars;
     and a 9x9 fan on the card against the same on the CPU (the twins);
  6. times from CUDA events (median of 10 after warm-up): the forward
     step; its split by stage, from events at the stage boundaries of the
     same step; and each kernel alone beside its twin, on the inputs the
     main path gave it;
  7. K3 (the Huygens contraction) against its twin on the card at ragged
     target x source counts and at 2,048 x 66,049, at 13.5 nm and 0.135 nm;
  8. the wave path at a 257x257 fan: seeded misalignment -> autofocus ->
     f64 trace with the exit-pupil re-fan -> wave handoff directory ->
     load -> propagate_stages (source, M1-M4, Image) + the defocus grid
     from M4 on K3; it must launch K3 6 times.  Each stage against the
     port's f64 path on 2,048 of its targets; the CLI's propagate twice
     with a stage cache (K3 6 times, then once); the gradient through K3
     against the f64 path's at 512 x 384, on the card and through the
     twin on the CPU;
  9. times: each stage of the wave chain and the chain (median of 3), the
     handoff, K3 alone beside its twin and the f64 path, peak memory; and
     K3 against its twin on the full M4 -> Image stage;
 10. the bench step forward and backward at 2048x2048 (the gradient of the
     bench loss with respect to the 26-vector): K1 and K2 once each, the
     backward (the plain float64 twin's VJP) no kernel; the gradient against
     the port's f64 engine's, and the deviation-field loss's against the
     f64-field loss's (akbx's pairs, bar 1e-3); a 9x9 gradient on the card
     against the CPU's; times (median of 10): the step, rays/s, peak
     memory, and its split into build, forward, the trace's backward and
     the build's backward;
 11. cli trace at 257x257 from a TraceConfig with precision="pallas"
     (autofocus at 21, the re-fan: K1 twice, K2 once), the same run at
     precision="f64" (|wave2| apart <= 1 nm), and the time of each stage:
     trace, wavefront_grid, Legendre, PSF;
 12. cli align at 21 rays (indices 2,3: the astigmatism must fall), then
     gradient_align, 20 Adam steps on the bench loss at 2048x2048 over the
     four pitches from the seeded misalignment (the loss must fall).
 13. the other mirror systems, figure errors and the df32 engine, each
     from the seeded misalignment after auto_focus at 21:
     a. KB (akbx's KB7 design; K1 at two mirrors), the Wolter III+III
        tandem and alternating orderings and the alternating V pair alone
        (two mirrors): K1 and K2 bit for bit against their twins on each
        system's constants at 4,194,304 and 1,000,003 rays; the fast
        engine at 2048x2048 (K1 and K2 once each) against the f64 engine
        (detcenter 5e-9 m, demeaned OPL 1e-9 m, valid identical); the
        bench loss's gradient against the f64 engine's (1e-3); K1 and K2
        alone, the fwd+bwd step, its split and peak memory;
     b. the Wolter III+I system with calibrate_uv and a seeded 3x3
        Legendre figure of 1 nm on every mirror, at precision="pallas"
        (the f64 engine: no kernel launch) at 2048x2048, its time and peak
        memory; the figures must move the demeaned OPL by >= 0.1 nm, and
        at 33x33 the card's change must be the CPU's to 1e-3 of its
        scale; the figure -> wavefront Jacobian of mirror 1 at 33x33 by
        reverse mode against central differences, >= 3 singular values
        above 1e-2 of the largest;
     c. run(precision="df32") at 2048x2048 against the f64 engine
        (detcenter 1e-8 m, wave2 0.5 nm, trace_df points 2e-9 m), its time
        and peak memory;
     and cli trace --system kb|tandem|alternating at its default fan.
 14. the design and fabrication path (no kernel: K1-K3 launch 0 times):
     a. cli design-kb and design-na on the card against the same on the
        CPU (1e-12; design-na's Newton root to 2e-3, its conditioning, and
        akbx's bars); the NA design's implicit gradient against the exact
        derivative; design_kb (EllipseNA on the card, scipy's DE on the
        host) against the CPU's, and its DE from the CPU's inputs;
     b. cli sweep-kb --num 5 --rays 257 with the milliseconds of each
        design point's stages (design, autofocus, trace, wavefront,
        Legendre, artifacts), its artifacts read back; the sweep at 33
        rays on the card against the host's CPU (PV to 1e-6: the
        re-fan's rounding, ROADMAP F4);
     c. cli fab-profiles at --num 100000 (7 finite CSVs, as the CPU's);
        the traced-versus-analytic loop on WOLTER_3_1_DEFAULT's hyp_v at
        33 x 2049 (1e-9 m on the conic, 1e-6 mm side profile); quadric_eval,
        stable_sqrt_diff and kahan_sum on card tensors;
     d. one 129^2 -> 129^2 wave stage: backend="native" (akbx's C++/OpenMP
        host engine, built at first use) against the f64 path (3e-7 of the
        field), timed beside K3.
Then a JSON line of the kernels, each with its bound (K1 and K2 also
at two mirrors, on KB's fan, and their launches on each path of 13): the larger of its
bytes over 3.35e12 B/s and its f32 operations over 3.35e13 op/s (the H100
SXM's 67 TFLOP/s f32 counts an FMA as two operations).  The operations
are counted on each twin, with every f32 two_prod at 2 (a multiply and an
FMA, as the kernels run it; the twin takes the FMA through f64).  As the
last line
{"ok": true, "device": {...}}.  Any failure raises: the exit code is not
0 and the last line is not printed.
"""

import contextlib
import dataclasses
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

N_SIDE = 2048           # the bench's fan: 4,194,304 rays
N_RAGGED = 1_000_003
SEED = 0
KERNEL_REL = 1e-11      # kernel vs twin, per output, of the output's scale
REPS = 10
W_SIDE = 257            # the wave path's fan: 66,049 points per surface
DEVICE = "cuda"
EUV, HARD = 13.5e-9, 0.135e-9
HUYGENS_REL = 1e-6      # K3 vs twin, of the field's scale (sum order only)
FIELD_REL = 1e-5        # K3 vs the f64 path, akbx's bar (test_kernels.py)
GRAD_REL = 2e-5         # gradient through K3 vs the f64 path's, akbx's bar
# the targets gradient at 512 x 384: akbx's own kernel reads 4.6e-5 of the
# scale there (tests/test_torch_wave.py::test_targets_grad_at_512x384_...)
TARGETS_GRAD_REL = 5e-5
SOURCE_STAGE_REL = 2e-3  # source -> M1: df32 with the source 145 m away
SUBSET = 2048           # targets of each stage held against the f64 path
FIG_NM = 1.0            # figure amplitude of phase 13 (sigma, nm)
HBM_BPS = 3.35e12       # H100 SXM, bytes/s
F32_OPS = 3.35e13       # H100 SXM f32 operations/s, an FMA counted once

# aten ops that move or make data rather than compute on it
_MOVES = {"view", "_unsafe_view", "reshape", "expand", "select", "slice",
          "unsqueeze", "squeeze", "t", "transpose", "permute", "clone",
          "copy_", "detach", "alias", "lift_fresh", "lift_fresh_copy",
          "zeros_like", "ones_like", "full_like", "empty_like", "zeros",
          "ones", "full", "empty", "new_zeros", "scalar_tensor", "fill_",
          "zero_", "stack", "cat", "index", "index_put_", "as_strided",
          "unbind", "split", "_local_scalar_dense", "empty_strided",
          # sign changes fold into the operands of the next instruction
          "neg", "abs"}
_REDUCTIONS = {"sum", "mean", "amax", "amin"}


class OpCount(TorchDispatchMode):
    """Counts the operations of the ops run under it: one per output
    element of an elementwise op, one per input element of a reduction;
    none for data movement and sign changes, nor while ``paused``.  A sin,
    a division or a square root counts as one, so the count is a floor."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if self.paused:
            pass
        elif name in _REDUCTIONS:
            self.ops += args[0].numel()
        elif name not in _MOVES and isinstance(out, torch.Tensor):
            self.ops += out.numel()
        return out


@contextlib.contextmanager
def two_prods_as_fma(counter):
    """Counts every ``two_prod`` of akbx_torch as the kernels run it:
    p = a b and e = fma(a, b, -p), two operations per element, not the
    tensor passes of the twin's detour through f64.  ``counter.calls``
    counts the ``two_prod`` calls."""
    from akbx_torch.core import precision

    twin = precision.two_prod
    counter.calls = 0

    def two_prod(a, b):
        counter.paused = True
        try:
            out = twin(a, b)
        finally:
            counter.paused = False
        counter.ops += 2 * out.hi.numel()
        counter.calls += 1
        return out

    mods = [m for k, m in list(sys.modules.items())
            if k.startswith("akbx_torch") and getattr(m, "two_prod", None)
            is twin]
    for m in mods:
        m.two_prod = two_prod
    try:
        yield
    finally:
        for m in mods:
            m.two_prod = twin


def count_ops(fn, *args):
    """(operations, two_prod calls) of ``fn(*args)`` on CPU copies of
    ``args``, with every two_prod at 2 operations per element."""
    cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    with OpCount() as c, two_prods_as_fma(c):
        fn(*cpu)
    return c.ops, c.calls


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time for the work on this card."""
    t_bytes, t_ops = n_bytes / HBM_BPS, n_ops / F32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def timed_once(fn):
    """(milliseconds between CUDA events, result) of one call of ``fn``."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), out


def time_ms(fn, reps=REPS, warmup=2, setup=None):
    """Median milliseconds of ``fn`` between CUDA events; with ``setup``,
    ``fn(setup())`` where the setup runs outside the timed window."""
    def once():
        arg = setup() if setup else None
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg) if setup else fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    for _ in range(warmup):
        once()
    return statistics.median(once() for _ in range(reps))


def f64_of(hi, lo):
    return hi.double() + lo.double()


class StageMarks:
    """Stands in for ``akbx_torch.trace``'s handle on the kernel module
    and records a CUDA event before and after each kernel wrapper, so one
    run of the real main path is cut at its stage boundaries.  Keeps the
    arguments each wrapper was last called with."""

    STAGES = {"before trace_deviation": "fan + chief + constants",
              "trace_deviation": "K1", "before detector": "tilt stats",
              "detector": "K2"}

    def __init__(self, module):
        self._module = module
        self.events = []
        self.args = {}

    def mark(self, stage):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((stage, ev))

    def spans(self):
        """Milliseconds of each stage, keyed by the stage that ends at
        each event (after a synchronize)."""
        return {stage: a.elapsed_time(b) for (_, a), (stage, b)
                in zip(self.events, self.events[1:])}

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if name not in ("trace_deviation", "detector"):
            return fn

        def timed(*args):
            self.mark(self.STAGES[f"before {name}"])
            self.args[name] = args
            out = fn(*args)
            self.mark(self.STAGES[name])
            return out

        return timed


def compare_outputs(kernel_out, twin_out, valid_index=None):
    """Largest |kernel - twin| (hi + lo pairs in f64) and its ratio to the
    output's largest magnitude, over every (hi, lo) output; the valid
    plane, if any, must be identical."""
    worst_ratio, worst_abs = 0.0, 0.0
    pairs = [k for k in range(0, len(kernel_out) - 1, 2)
             if k != valid_index]
    for k in pairs:
        a = f64_of(kernel_out[k], kernel_out[k + 1])
        b = f64_of(twin_out[k], twin_out[k + 1])
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        check(np.isfinite(err), f"non-finite kernel output {k}")
        worst_abs = max(worst_abs, err)
        worst_ratio = max(worst_ratio, err / scale if scale else err)
    if valid_index is not None:
        check(torch.equal(kernel_out[valid_index], twin_out[valid_index]),
              "kernel and twin valid masks differ")
    return worst_ratio, worst_abs


def field_err(got, want):
    """(max |got - want|, that over max |want|) of two (re, im) fields."""
    g, w = torch.complex(*got), torch.complex(*want)
    err = float((g - w).abs().max()) if w.numel() else 0.0
    scale = float(w.abs().max()) if w.numel() else 0.0
    check(np.isfinite(err), "non-finite field")
    return err, err / scale if scale else err


def huygens_cloud(dev, n, m, seed):
    """A seeded field of ``m`` sources near 145 m and ``n`` targets near
    146 m (akbx's kernel tests, tests/test_kernels.py::_mk)."""
    from akbx_torch import wave

    rng = np.random.default_rng(seed)
    src = np.array([145.0, 0.02, 0.0])[:, None] + rng.normal(size=(3, m)) * 0.05
    tgt = np.array([146.0, 0.05, 0.01])[:, None] + rng.normal(size=(3, n)) * 0.02
    u = rng.normal(size=m) + 1j * rng.normal(size=m)
    ds = np.abs(rng.normal(size=m)) * 1e-8
    return (wave.WaveField.from_complex(src, u, ds, device=dev),
            torch.tensor(tgt, device=dev))


def k3_against_twin(hk, args, label, phase, bitwise=False):
    """K3 and its twin on the same arguments; checks HUYGENS_REL (and bit
    equality with one source per target sum).  Returns max |err|."""
    k = hk.huygens(*args)
    torch.cuda.synchronize()
    t = hk.huygens_reference(*args)
    err, rel = field_err(k, t)
    same = torch.equal(k[0], t[0]) and torch.equal(k[1], t[1])
    print(f"[{phase}] K3 vs twin {label}: max |err| {err:.3e}, of the field "
          f"{rel:.3e} (bar {HUYGENS_REL}); bit-identical {same}", flush=True)
    check(rel <= HUYGENS_REL, f"K3 disagrees with its twin ({label})")
    check(same or not bitwise, f"K3 not bit-identical to its twin ({label})")
    return err


def phase7_k3(dev, hk):
    """K3 against its twin at ragged counts and at 2,048 x 66,049."""
    worst = 0.0
    for lam in (EUV, HARD):
        for n, m in ((1, 1), (255, 257), (1025, 4099), (SUBSET, W_SIDE ** 2),
                     (100_003, 1)):
            src, tgt = huygens_cloud(dev, n, m, n + m)
            worst = max(worst, k3_against_twin(
                hk, hk.kernel_args(src, tgt, lam),
                f"N={n} x M={m} at {lam * 1e9:g} nm", 7, bitwise=m == 1))
    # K3's work does not depend on the data: a synthetic full stage
    n = W_SIDE ** 2
    src, tgt = huygens_cloud(dev, n, n, 1)
    args = hk.kernel_args(src, tgt, EUV)
    print(f"[7] K3 on a synthetic {n} x {n} cloud: "
          f"{time_ms(lambda: hk.huygens(*args), reps=3, warmup=1):.3f} ms "
          "(median of 3)", flush=True)
    return worst


# approximate or flushing instructions that must not appear in a kernel's
# PTX ("sqrt.approx" but not "rsqrt.approx": df_rsqrt's first guess)
_BANNED_PTX = (r"sin\.approx", r"cos\.approx", r"div\.approx",
               r"(?<!r)sqrt\.approx", r"\.ftz")


def check_ptx(hk):
    """Phase 2's reading of the kernels' PTX.  Nothing approximate and no
    flush-to-zero in K3's and K1/K2's sources, but K1's rsqrt.approx.
    K3's ``fma.rn.f32`` are those of its pair chains: per chain, the FMAs
    of one sinf and one cosf (counted in a kernel of only those, built
    with the same flags) and one per ``two_prod`` (counted on the twin).
    That nothing else was contracted shows in the bit-identity with the
    twins, phases 3 and 7."""
    from akbx_torch.kernels import _build

    flags = [f for f in _build.NVCC_FLAGS
             if f not in ("-Xptxas=-v", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "sincos.cu")
        with open(ref, "w") as f:
            f.write("__global__ void k(const float* x, float* y) {\n"
                    "  float a = x[threadIdx.x];\n"
                    "  y[threadIdx.x] = sinf(a);\n"
                    "  y[threadIdx.x + 32] = cosf(a);\n}\n")
        jobs = {}
        for label, cu in (("K3", _build.CSRC / "huygens_kernel.cu"),
                          ("K1+K2", _build.CSRC / "trace_kernel.cu"),
                          ("sinf+cosf", ref)):
            out = os.path.join(tmp, f"{len(jobs)}.ptx")
            jobs[label] = (out, subprocess.Popen(
                [_build._nvcc(), *flags, "-I", str(_build.CSRC), "-ptx",
                 "-o", out, str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        ptx = {}
        for label, (out, proc) in jobs.items():
            msg = proc.communicate(timeout=600)[0]
            check(proc.returncode == 0, f"nvcc -ptx of {label}: {msg}")
            ptx[label] = open(out).read()
    fma = {k: v.count("fma.rn.f32") for k, v in ptx.items()}
    banned = {k: {pat: len(re.findall(pat, ptx[k])) for pat in _BANNED_PTX}
              for k in ("K3", "K1+K2")}
    rsqrt = ptx["K1+K2"].count("rsqrt.approx")
    # one pair on the twin: its two_prod calls are the kernel's sites
    one = [torch.zeros(6, 1), torch.ones(6, 1), torch.ones(2, 1),
           torch.ones(2)]
    _, sites = count_ops(hk.huygens_reference, *one)
    chains = ptx["K3"].count("sqrt.rn.f32")   # one df_sqrt per pair chain
    print(f"[2] K3 PTX: {fma['K3']} fma.rn.f32 in {chains} pair chains (the "
          f"unrolled sources and the tail); a kernel of only sinf and cosf: "
          f"{fma['sinf+cosf']}; two_prod sites per chain (the twin's calls "
          f"on one pair): {sites}; {chains} x ({fma['sinf+cosf']} + {sites}) "
          f"= {chains * (fma['sinf+cosf'] + sites)}.  K1+K2 PTX: "
          f"{fma['K1+K2']} fma.rn.f32, {rsqrt} rsqrt.approx (df_rsqrt's "
          f"first guess, one per mirror body).  Banned patterns: {banned}",
          flush=True)
    check(all(n == 0 for v in banned.values() for n in v.values()),
          "a kernel's PTX has an approximate or flushing instruction")
    check(chains > 0 and fma["K3"] == chains * (fma["sinf+cosf"] + sites),
          "K3's PTX has FMAs beyond sinf, cosf and its two_prods")


def check_two_prod(dev, n=100_000_000):
    """Phase 3's first check: df32.cuh's two_prod against the twin's on
    ``n`` seeded float32 pairs on the card, bit for bit in both words.
    Magnitudes from 2^-63 to 2^63, so products down to 2^-126 and error
    terms far into the subnormals; signed zeros mixed in."""
    from akbx_torch.core import precision
    from akbx_torch.kernels import df32_check

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def operand():
        x = torch.rand(n, generator=gen, device=dev) * 2.0 - 1.0
        x = torch.ldexp(x, torch.randint(-62, 63, (n,), generator=gen,
                                         device=dev))
        x[::1009] = 0.0
        x[::2003] = -0.0
        return x

    a, b = operand(), operand()
    got = df32_check.two_prod(a, b)
    torch.cuda.synchronize()
    want = precision.two_prod(a, b)
    tiny = torch.finfo(torch.float32).tiny
    sub = int(((want.lo != 0) & (want.lo.abs() < tiny)).sum())
    zero = int((want.hi == 0).sum())
    same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))
    print(f"[3] two_prod (df32.cuh) vs the twin on {n} seeded pairs: "
          f"bit-identical {same} ({sub} subnormal error terms, {zero} zero "
          "products among them)", flush=True)
    check(same and sub > 0 and zero > 0,
          "df32.cuh's two_prod differs from the twin's")


def reset_counts(tk, hk):
    tk.trace_deviation.launches = 0
    tk.detector.launches = 0
    hk.huygens.launches = 0


def counts(tk, hk):
    return {"K1": tk.trace_deviation.launches, "K2": tk.detector.launches,
            "K3": hk.huygens.launches}


def wave_stages(data):
    """The CLI's stage list of a handoff directory: M1..M4 with their dS,
    then the image grid."""
    stages = [{"points": data[f"M{i}"][:3], "ds": data[f"M{i}"][3],
               "name": f"M{i}"} for i in range(1, 5)]
    return stages + [{"points": data["gridImage"], "name": "Image"}]


def phase8_wave(dev, vec, base, tk, hk):
    """The wave path at W_SIDE x W_SIDE, its checks, and what phase 9
    times.  ``base``: a scratch directory."""
    import contextlib
    import io as _io

    from akbx_torch import align, cli, export, io, trace, wave
    from akbx_torch.systems import (AlignParams, WOLTER_3_1_DEFAULT,
                                    build_wolter_3_1)

    def build(p):
        return build_wolter_3_1(WOLTER_3_1_DEFAULT, p)

    def handoff():
        p = align.auto_focus(build, AlignParams.from_vector(vec), n=21,
                             iters=5)
        s = build(p)
        res = trace.run(s, W_SIDE, W_SIDE, defocus=p.defocus,
                        defocus_wave=1e-3)
        d = io.run_directory(base, "akb_wave")
        export.wave_handoff(d, s, res, W_SIDE, W_SIDE, defocus_for_wave=1e-3)
        return d, p, res

    def chain(data):
        src = wave.point_source(tuple(data["source"]), device=dev)
        fields = wave.propagate_stages(src, wave_stages(data), EUV)
        defocus = wave.propagate_field(fields[-2], data["gridDefocus"], EUV)
        return src, fields, defocus

    reset_counts(tk, hk)
    d, p, res = handoff()
    data = io.load_wave_data(d)
    src, fields, defocus = chain(data)
    torch.cuda.synchronize()
    launched = counts(tk, hk)
    check(launched == {"K1": 0, "K2": 0, "K3": 6},
          f"wave path launched {launched}, want K3 6 times")
    n_pts = W_SIDE ** 2
    outs = fields + [defocus]
    names = ["M1", "M2", "M3", "M4", "Image", "Defocus"]
    for name, f in zip(names, outs):
        check(f.n == n_pts and bool(torch.isfinite(f.re).all())
              and bool(torch.isfinite(f.im).all()), f"{name} field")
    inten = fields[4].intensity
    print(f"[8] wave path {W_SIDE}x{W_SIDE}: autofocus defocus "
          f"{float(p.defocus):.9e} m, astigH {float(p.astig_h):.9e} m; "
          f"valid rays {int(res.valid.sum())}/{n_pts}; handoff {d}; "
          f"launches {launched}; Image peak intensity "
          f"{float(inten.max()):.6e}", flush=True)

    # each stage against the f64 path on SUBSET of its targets, from the
    # same (K3-computed) field the stage propagated
    rng = np.random.default_rng(SEED)
    inputs = [src] + fields[:4] + [fields[3]]
    errs = {}
    for name, fin, fout in zip(names, inputs, outs):
        idx = torch.tensor(np.sort(rng.choice(n_pts, SUBSET, replace=False)),
                           device=dev)
        x = wave.propagate(fin, fout.points[:, idx], EUV, backend="xla",
                           chunk=256)
        errs[name] = field_err((fout.re[idx], fout.im[idx]), x)[1]
    print(f"[8] each stage vs the f64 path on {SUBSET} targets (of the "
          "field): "
          + "; ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (bars: M1 {SOURCE_STAGE_REL}, the source 145 m from the "
          f"stage's centroid; the others {FIELD_REL})", flush=True)
    check(errs["M1"] <= SOURCE_STAGE_REL
          and max(v for k, v in errs.items() if k != "M1") <= FIELD_REL,
          "a stage of the wave path misses its bar against the f64 path")

    # K3 vs its twin at the handoff's shapes: 2048 image targets, all M4
    img_idx = torch.tensor(np.sort(rng.choice(n_pts, SUBSET, replace=False)),
                           device=dev)
    sub_pts = fields[4].points[:, img_idx]
    sub_args = hk.kernel_args(fields[3], sub_pts, EUV)
    handoff_err = k3_against_twin(hk, sub_args, f"handoff M4 -> {SUBSET} "
                                  f"Image targets ({n_pts} sources)", 8)

    # the CLI's propagate, twice, with the stage cache
    out = os.path.join(base, "propagate")
    intens = []
    for want in (6, 1):
        reset_counts(tk, hk)
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["propagate", d, "--out", out, "--device", str(dev)])
        torch.cuda.synchronize()
        got = hk.huygens.launches
        summary = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"[8] cli propagate (cache in {out}): rc {rc}, K3 launches "
              f"{got} (want {want}); {summary}", flush=True)
        check(rc == 0 and got == want, "cli propagate launches")
        intens.append(np.load(os.path.join(out, "intensity_Image.npy")))
    check(np.array_equal(intens[0], intens[1]),
          "the cached rerun's intensity_Image.npy differs")
    print(f"[8] cached rerun: intensity_Image.npy identical; vs the "
          f"chain's Image intensity max |diff| "
          f"{float(np.abs(intens[0] - inten.cpu().numpy()).max()):.3e}",
          flush=True)

    # the gradient through K3 against the f64 path's, 512 x 384; the same
    # through the twin on the CPU
    for where in (dev, torch.device("cpu")):
        gsrc, gtgt = huygens_cloud(where, 384, 512, 7)
        grads = {}
        for backend in ("pallas", "xla"):
            leaves = [x.detach().clone().requires_grad_(True)
                      for x in (gsrc.re, gsrc.im, gsrc.ds, gsrc.points, gtgt)]
            re, im = wave.propagate(wave.WaveField(leaves[3], *leaves[:3]),
                                    leaves[4], EUV, backend=backend)
            torch.sum(re ** 2 + im ** 2).backward()
            grads[backend] = [x.grad for x in leaves]
        g_err = {}
        for name, a, b in zip(("re", "im", "ds", "points", "targets"),
                              grads["pallas"], grads["xla"]):
            check(bool(torch.isfinite(a).all()), f"non-finite gradient {name}")
            g_err[name] = float((a - b).abs().max() / b.abs().max())
        print(f"[8] gradient through {'K3' if where == dev else 'the twin'} "
              f"({where.type}) vs the f64 path, 512 x 384, of each "
              "gradient's scale: " + "; ".join(f"{k} {v:.3e}"
                                               for k, v in g_err.items())
              + f" (bars {GRAD_REL}; targets {TARGETS_GRAD_REL}, as akbx's "
              "own kernel: Re(conj(u) du/dt) cancels its leading -ik|u|^2 "
              "term)", flush=True)
        check(max(g_err[k] for k in ("re", "im", "ds", "points")) <= GRAD_REL
              and g_err["targets"] <= TARGETS_GRAD_REL, "gradient through K3")
    return {"data": data, "handoff": handoff, "chain": chain,
            "fields": fields, "src": src, "sub_args": sub_args,
            "sub_pts": sub_pts, "launches": launched["K3"],
            "handoff_err": handoff_err}


def phase9_times(dev, w, hk):
    """Times of the wave path (phase 8's ``w``)."""
    from akbx_torch import wave

    data, fields = w["data"], w["fields"]
    stages = wave_stages(data) + [{"points": data["gridDefocus"],
                                   "name": "Defocus", "from": 3}]
    names = [st["name"] for st in stages]
    per_stage = {k: [] for k in names}
    for rep in range(4):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True)]
        ev[0].record()
        done = []
        for st in stages:
            prev = done[st["from"]] if "from" in st else (
                done[-1] if done else w["src"])
            done.append(wave.propagate_field(prev, st["points"], EUV,
                                             target_ds=st.get("ds")))
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()
        ev[-1].synchronize()
        if rep:
            for k, a, b in zip(names, ev, ev[1:]):
                per_stage[k].append(a.elapsed_time(b))
    stage_ms = {k: statistics.median(v) for k, v in per_stage.items()}
    n_src = {"M1": 1}
    pairs = {k: n_src.get(k, W_SIDE ** 2) * W_SIDE ** 2 for k in names}

    # the chain's own peak: above what earlier phases left allocated
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    chain_ms = time_ms(lambda: w["chain"](data), reps=3, warmup=1)
    peak_gb = (torch.cuda.max_memory_allocated() - live) / 1e9

    def handoff_s():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w["handoff"]()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    handoff_ms = statistics.median(handoff_s() for _ in range(3)) * 1e3
    print("[9] wave stages (ms, median of 3; pairs/s): " + "; ".join(
        f"{k} {stage_ms[k]:.3f} ({pairs[k] / (stage_ms[k] / 1e3):.4e})"
        for k in names), flush=True)
    print(f"[9] wave chain (propagate_stages + defocus grid) {chain_ms:.3f} "
          f"ms, median of 3; its peak memory {peak_gb:.3f} GB; handoff "
          f"(autofocus + f64 trace with re-fan + export) {handoff_ms:.3f} "
          f"ms, median of 3, host clock", flush=True)

    sub = w["sub_args"]
    k3_sub = time_ms(lambda: hk.huygens(*sub))
    twin_sub = time_ms(lambda: hk.huygens_reference(*sub), reps=3, warmup=1)
    f64_sub = time_ms(lambda: wave.propagate(fields[3], w["sub_pts"], EUV,
                                             backend="xla", chunk=256),
                      reps=3, warmup=1)
    full = hk.kernel_args(fields[3], fields[4].points, EUV)
    k3_full = time_ms(lambda: hk.huygens(*full))
    k3_out = hk.huygens(*full)
    twin_full, twin_out = timed_once(lambda: hk.huygens_reference(*full))
    full_err, full_rel = field_err(k3_out, twin_out)
    print(f"[9] K3 vs twin on the full M4 -> Image stage: max |err| "
          f"{full_err:.3e}, of the field {full_rel:.3e} (bar {HUYGENS_REL})",
          flush=True)
    check(full_rel <= HUYGENS_REL, "K3 disagrees with its twin (full stage)")
    n_full = full[0].shape[1] * full[1].shape[1]
    ops_pair, _ = count_ops(hk.huygens_reference, full[0][:, :1],
                            full[1][:, :1], full[2][:, :1], full[3])
    # each input read once; the output, (2, N) f32, written once
    bound_ms, bound_by = bound(nbytes(*full) + 8 * full[0].shape[1],
                               ops_pair * n_full)
    print(f"[9] K3 on {SUBSET} x {W_SIDE ** 2} (M4 -> Image subset): kernel "
          f"{k3_sub:.3f} ms (median of {REPS}), twin {twin_sub:.3f} ms and "
          f"f64 path (chunk 256) {f64_sub:.3f} ms (median of 3)", flush=True)
    print(f"[9] K3 on the M4 -> Image stage ({W_SIDE ** 2} x {W_SIDE ** 2} = "
          f"{n_full} pairs): kernel {k3_full:.3f} ms (median of {REPS}, "
          f"{n_full / (k3_full / 1e3):.4e} pairs/s), twin {twin_full:.3f} ms "
          f"(one run); {ops_pair} f32 operations per pair -> bound "
          f"{bound_ms:.3f} ms ({bound_by}), {bound_ms / k3_full:.3f} of it",
          flush=True)
    return {"ms": k3_full, "plain_ms": twin_full, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": full_err}


def bench_loss(res):
    """bench_common.make_step's pallas loss, on the f32 deviation fields."""
    from akbx_torch import trace

    sy, sz = trace.spot_size(res.ddet32, res.valid)
    return (torch.sum(torch.where(res.valid, res.w32, 0.0) ** 2) * 1e18
            + sy + sz)


def f64_field_loss(res):
    """The same objective on the f64 fields (make_step's f64 loss)."""
    from akbx_torch import trace

    w = res.total_dist - trace.masked_mean(res.total_dist, res.valid)
    sy, sz = trace.spot_size(res.detcenter, res.valid)
    return torch.sum(torch.where(res.valid, w, 0.0) ** 2) * 1e18 + sy + sz


def grad_rel(g, ref):
    """Largest |g - ref| over max(|ref|, 1e-6 of ref's largest entry)."""
    scale = ref.abs().max()
    return float(((g - ref).abs()
                  / torch.clamp_min(ref.abs(), 1e-6 * scale)).max())


def build_system(v):
    from akbx_torch.systems import (AlignParams, WOLTER_3_1_DEFAULT,
                                    build_wolter_3_1)

    return build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.from_vector(v))


def grad_step(vec, n, loss_of=bench_loss, precision="pallas",
              build=build_system):
    """One forward-and-backward step of the bench: build from the
    26-vector (``build``, the Wolter III+I system by default), trace.run
    at n x n, the loss, its gradient."""
    from akbx_torch import trace

    v = vec.detach().clone().requires_grad_(True)
    res = trace.run(build(v), n, n, defocus=v[0],
                    exit_pupil_uniform=False, tilt_correction=True,
                    precision=precision)
    loss = loss_of(res)
    loss.backward()
    return loss.detach(), v.grad


def staged_step(vec, marks, build=build_system):
    """``grad_step`` cut by CUDA events into system build, forward (run +
    loss), the trace's backward (the twin's VJP, down to the mirrors'
    tensors) and the build's backward (the placement)."""
    from akbx_torch import trace
    from akbx_torch.surfaces import Mirror

    v = vec.detach().clone().requires_grad_(True)
    marks.mark(None)
    system = build(v)
    marks.mark("system build")
    tensors = trace._tensors_of(system)
    leaves = [t.detach().requires_grad_(t.requires_grad) for t in tensors]
    k = len(Mirror._fields)
    mirrors = tuple(Mirror(*leaves[i:i + k]) for i in range(0, len(leaves), k))
    res = trace.run(system._replace(mirrors=mirrors), N_SIDE, N_SIDE,
                    defocus=v[0], exit_pupil_uniform=False,
                    tilt_correction=True, precision="pallas")
    loss = bench_loss(res)
    marks.mark("forward (run + loss)")
    need = [i for i, t in enumerate(tensors) if t.requires_grad]
    loss.backward(inputs=[v] + [leaves[i] for i in need])
    marks.mark("trace backward (twin VJP)")
    reached = [i for i in need if leaves[i].grad is not None]
    torch.autograd.backward([tensors[i] for i in reached],
                            [leaves[i].grad for i in reached])
    marks.mark("build backward")
    return loss.detach(), v.grad


def phase10_fwd_bwd(dev, vec, tk, hk):
    """The bench step, forward and backward, at N_SIDE x N_SIDE."""
    n_rays = N_SIDE ** 2
    reset_counts(tk, hk)
    loss, g = grad_step(vec, N_SIDE)
    torch.cuda.synchronize()
    launched = counts(tk, hk)
    check(launched == {"K1": 1, "K2": 1, "K3": 0},
          f"the fwd+bwd step launched {launched}, want K1 once, K2 once")
    check(bool(torch.isfinite(g).all()), "non-finite gradient")
    print(f"[10] fwd+bwd step {N_SIDE}x{N_SIDE}: launches {launched}; loss "
          f"{float(loss):.9e}; gradient {g.cpu().numpy().tolist()}",
          flush=True)

    # akbx's pairs of tests/test_trace_pallas.py, at the bench's size
    _, g_fast64 = grad_step(vec, N_SIDE, f64_field_loss)
    _, g_f64 = grad_step(vec, N_SIDE, f64_field_loss, "f64")
    r_engine = grad_rel(g_fast64, g_f64)
    r_loss = grad_rel(g, g_fast64)
    print(f"[10] gradients at {N_SIDE}x{N_SIDE}, largest |g - g_ref| / "
          f"max(|g_ref|, 1e-6 of its largest): f64-field loss, fast path "
          f"vs the f64 engine {r_engine:.3e}; deviation-field loss vs "
          f"f64-field loss, fast path {r_loss:.3e} (bars 1e-3)", flush=True)
    check(r_engine < 1e-3 and r_loss < 1e-3,
          "fast-path gradient vs its references beyond 1e-3")
    del g_fast64, g_f64

    small = [grad_step(vec.to(d), 9)[1].cpu()
             for d in (dev, torch.device("cpu"))]
    r_small = grad_rel(small[0], small[1])
    print(f"[10] 9x9 gradient on the card vs on the CPU: {r_small:.3e} "
          "(bar 1e-3)", flush=True)
    check(r_small < 1e-3, "9x9 gradient, card vs CPU")

    # times: the step, then the same step cut at its stage boundaries
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    step_ms = time_ms(lambda: grad_step(vec, N_SIDE))
    peak_gb = (torch.cuda.max_memory_allocated() - live) / 1e9
    marks = StageMarks(tk)
    runs = []
    for rep in range(REPS + 2):
        marks.events.clear()
        torch.cuda.synchronize()
        _, g_staged = staged_step(vec, marks)
        torch.cuda.synchronize()
        if rep >= 2:
            runs.append(marks.spans())
    check(grad_rel(g_staged, g) < 1e-9, "the staged step's gradient differs")
    split = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    print(f"[10] fwd+bwd step {step_ms:.3f} ms (median of {REPS}), "
          f"{n_rays / (step_ms / 1e3):.6e} rays/s, peak memory "
          f"{peak_gb:.3f} GB; split (ms, median of {REPS}): "
          + "; ".join(f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    return launched


def phase11_cli_trace(dev, vec, base, tk, hk):
    """cli trace at W_SIDE x W_SIDE from a TraceConfig with the fast
    engine: autofocus at 21, the re-fan, wavefront, Legendre, PSF."""
    import contextlib
    import io as _io

    from akbx_torch import cli, config, io, trace, wavefront
    from akbx_torch.analysis import legendre, psf, rectify
    from akbx_torch.systems import AlignParams

    cfg = config.TraceConfig(n_rays_h=W_SIDE, n_rays_v=W_SIDE,
                             defocus_for_wave=1e-2, precision="pallas")
    path = os.path.join(base, "trace.json")
    config.save_config(cfg, path)
    io.write_optical_params(base, vec)
    reset_counts(tk, hk)
    buf = _io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["trace", "--config", path, "--params",
                       os.path.join(base, "optical_params.txt"), "--out",
                       base, "--device", str(dev)])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launched = counts(tk, hk)
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"[11] cli trace {W_SIDE}x{W_SIDE} (TraceConfig precision="
          f"'pallas', autofocus at 21): rc {rc}, launches {launched}, "
          f"{cli_s:.3f} s host clock; {summary}", flush=True)
    check(rc == 0 and launched == {"K1": 2, "K2": 1, "K3": 0},
          f"cli trace launched {launched}, want K1 twice and K2 once")
    check(summary["valid_rays"] == W_SIDE ** 2, "cli trace lost rays")

    # the same run, stage by stage, and at precision='f64'
    p = AlignParams.from_vector(io.read_optical_params(
        os.path.join(summary["out_dir"], "optical_params.txt")), device=dev)
    system = build_system(p.to_vector())
    lam_nm = cfg.energy.wavelength_nm
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    torch.cuda.synchronize()
    ev[0].record()
    res = trace.run_config(system, cfg, defocus=p.defocus)
    ev[1].record()
    mat, gy, gz = wavefront.wavefront_grid(res, W_SIDE, W_SIDE)
    ev[2].record()
    rect = rectify.extract_square_region(mat / lam_nm, W_SIDE)
    fits, ips, _ = legendre.match_multi(rect[1:-2, 1:-2], 5)
    ev[3].record()
    out = psf.psf_from_wavefront(mat, gy, gz, cfg.defocus_for_wave,
                                 cfg.energy.wavelength_m)
    ev[4].record()
    ev[4].synchronize()
    stages = dict(zip(("trace (run_config)", "wavefront_grid",
                       "Legendre (rectify + match_multi)",
                       f"PSF ({out['psf'].shape[0]}^2 complex128 FFT)"),
                      (a.elapsed_time(b) for a, b in zip(ev, ev[1:]))))
    res64 = trace.run_config(system, dataclasses.replace(cfg, precision="f64"),
                             defocus=p.defocus)
    check(torch.equal(res.valid, res64.valid), "valid differs from f64")
    d_wave = float((res.wave2 - res64.wave2)[res.valid].abs().max())
    mat64, _, _ = wavefront.wavefront_grid(res64, W_SIDE, W_SIDE)
    pv = float(wavefront.pv_6sigma(mat / lam_nm))
    pv64 = float(wavefront.pv_6sigma(mat64 / lam_nm))
    check(np.isfinite(pv) and bool(torch.isfinite(out["psf"]).all())
          and bool(torch.isfinite(ips).all()), "non-finite analysis output")
    print(f"[11] PV 6 sigma {pv:.9f} waves (f64 engine {pv64:.9f}); max "
          f"|wave2 - wave2_f64| over valid rays {d_wave:.3e} nm (bar 1 nm, "
          "the fast-vs-f64 OPL bar of 1e-9 m); stages (ms, CUDA events, one "
          "run after the CLI's): " + "; ".join(f"{k} {v:.3f}" for k, v in
                                             stages.items()), flush=True)
    check(d_wave <= 1.0, "wave2 of the fast path vs f64 beyond 1 nm")
    return launched


def phase12_align(dev, vec, base, tk, hk):
    """cli align at its own fan of 21, then gradient_align on the bench
    loss from the seeded misalignment over the pitches it perturbs."""
    import contextlib
    import io as _io

    from akbx_torch import align, cli, trace

    buf = _io.StringIO()
    reset_counts(tk, hk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["align", "--rays", "21", "--indices", "2,3",
                       "--no-autofocus", "--out", os.path.join(base, "al"),
                       "--device", str(dev)])
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"[12] cli align (21 rays, indices 2,3): rc {rc}, {align_s:.3f} s "
          f"host clock, launches {counts(tk, hk)}; {out}", flush=True)
    check(rc == 0 and abs(out["abrr_after"][0]) < abs(out["abrr_before"][0]),
          "cli align did not reduce the astigmatism component")

    free = [2, 8, 14, 20]       # the pitch of each mirror
    losses = []
    steps = 20

    def loss_fn(v):
        res = trace.run(build_system(v), N_SIDE, N_SIDE, defocus=v[0],
                        exit_pupil_uniform=False, tilt_correction=True,
                        precision="pallas")
        loss = bench_loss(res)
        losses.append(float(loss.detach()))
        return loss

    reset_counts(tk, hk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, last = align.gradient_align(loss_fn, vec, free, steps=steps,
                                     lr=1e-6)
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / steps * 1e3
    launched = counts(tk, hk)
    print(f"[12] gradient_align ({steps} Adam steps, lr 1e-6, bench loss at "
          f"{N_SIDE}x{N_SIDE}, pitches {free}): loss {losses[0]:.9e} -> "
          f"{losses[-1]:.9e}; injected {vec[free].cpu().numpy().tolist()}, "
          f"after {got[free].cpu().numpy().tolist()}; {per_step:.3f} ms a "
          f"step (host clock); launches {launched}", flush=True)
    check(launched == {"K1": steps, "K2": steps, "K3": 0},
          f"gradient_align launched {launched}")
    check(float(last) == losses[-1] and losses[-1] < losses[0],
          "gradient_align did not lower the loss")


def new_systems(dev):
    """Builders of the 26-vector for the new systems of phase 13: akbx's
    KB7 design, the Wolter III+III tandem and alternating orderings, and
    the alternating ordering's V pair alone."""
    from akbx_torch import cli
    from akbx_torch.systems import (AlignParams, KBSpec,
                                    WOLTER_3_3_ALT_DEFAULT,
                                    WOLTER_3_3_TANDEM_DEFAULT, build_kb,
                                    build_wolter_3_3_alternating,
                                    build_wolter_3_3_tandem)

    kb = KBSpec.from_kb_define(*cli.KB7_DESIGN, device=dev)

    def of(fn):
        return lambda v: fn(AlignParams.from_vector(v))

    return {
        "kb": of(lambda p: build_kb(kb, p)),
        "tandem": of(lambda p: build_wolter_3_3_tandem(
            WOLTER_3_3_TANDEM_DEFAULT, p)),
        "alternating": of(lambda p: build_wolter_3_3_alternating(
            WOLTER_3_3_ALT_DEFAULT, p)),
        "two_mirror": of(lambda p: build_wolter_3_3_alternating(
            WOLTER_3_3_ALT_DEFAULT, p, two_mirror_only=True)),
    }


def focused(build, vec):
    """The seeded vector after auto_focus at 21 (5 iterations)."""
    from akbx_torch import align
    from akbx_torch.systems import AlignParams

    p = align.auto_focus(lambda q: build(q.to_vector()),
                         AlignParams.from_vector(vec), n=21, iters=5)
    return p.to_vector().detach()


def k1_k2_bitwise(system, tk, label):
    """K1 and K2 against their twins, every output word, on the system's
    own constants: the N_SIDE^2 fan and N_RAGGED seeded rays.  Returns
    the fan's K1 and K2 arguments (for timing)."""
    from akbx_torch import trace

    dev = system.source.device
    rays = trace.ray_fan(trace.fan_angles(system.fan_h, N_SIDE),
                         trace.fan_angles(system.fan_v, N_SIDE))
    n_rays = rays.shape[1]
    src = system.source[:, None].expand(3, n_rays)
    chief_d0, chief_p0, consts64 = trace._fast_scalars(system, rays, src,
                                                       n_rays // 2)
    (Ms, bvecs, Ds, Dns, Ts, A_noms, Bp_noms, rhos, gCs, gAs, branches,
     Ps) = consts64
    n_mirr = Ps.shape[0]
    consts = tk.pack_consts(Ms, gCs, gAs, Ds, Dns, Ts, A_noms, Bp_noms,
                            rhos, branches, bvecs)
    fan_dp = (src - chief_p0).contiguous()
    fan_dd = (rays - chief_d0).contiguous()
    rng = np.random.default_rng(SEED)
    scale = fan_dd.abs().amax(dim=1, keepdim=True)
    rnd_dd = torch.tensor(rng.uniform(-1.0, 1.0, (3, N_RAGGED)),
                          dtype=torch.float64, device=dev) * scale
    rnd_dp = torch.tensor(rng.normal(0.0, 1e-6, (3, N_RAGGED)),
                          dtype=torch.float64, device=dev)
    det_x = system.s2f_middle
    last = slice(3 * (n_mirr - 1), 3 * n_mirr)
    args = None
    for which, dp, dd in (("fan", fan_dp, fan_dd), ("random", rnd_dp,
                                                    rnd_dd)):
        k1 = tk.trace_deviation(consts, dp, dd, n_mirr)
        torch.cuda.synchronize()
        t1 = tk.trace_deviation_reference(consts, dp, dd, n_mirr)
        same1 = all(torch.equal(a, b) for a, b in zip(k1, t1))
        valid = t1[8][0] > 0.5
        q4, d4 = (t1[0][last], t1[1][last]), (t1[2][last], t1[3][last])
        th_y, th_z = trace._tilt_stats(Dns[-1], f64_of(*d4), valid, True,
                                       "mean")
        focus = trace._pre_tilt_focus(Ps[-1], Dns[-1], det_x, f64_of(*q4),
                                      f64_of(*d4), valid)
        (R, _, D4r, t_c, _, L, t_c2, _, L2, _, _) = \
            trace._fast_post_scalars(consts64, det_x, det_x + 1e-3, th_y,
                                     th_z, focus, True)
        dcon = torch.cat([tk.pack_det_consts(R, D4r, t_c, L),
                          tk.pack_det_consts(R, D4r, t_c2, L2)])
        ins = (*q4, *d4, t1[6], t1[7])
        k2 = tk.detector(dcon, *ins)
        torch.cuda.synchronize()
        t2 = tk.detector_reference(dcon, *ins)
        same2 = all(torch.equal(a, b) for a, b in zip(k2, t2))
        print(f"[13a] {label} ({n_mirr} mirrors) {which} N={dp.shape[1]}: "
              f"K1 bit-identical to its twin {same1}, K2 {same2}; valid "
              f"{int(valid.sum())}", flush=True)
        check(same1 and same2, f"{label}: a kernel differs from its twin")
        if which == "fan":
            args = ((consts, fan_dp, fan_dd, n_mirr), (dcon, *ins))
        del k1, t1, k2, t2
    return args


def kernel_times(k1_in, k2_in, tk):
    """K1 and K2 alone (median of REPS) and their twins (one run), and
    their bounds, on the arguments of one fan."""
    n_rays = k1_in[1].shape[1]
    k1_ms = time_ms(lambda: tk.trace_deviation(*k1_in))
    k2_ms = time_ms(lambda: tk.detector(*k2_in))
    k1_plain, _ = timed_once(lambda: tk.trace_deviation_reference(*k1_in))
    k2_plain, _ = timed_once(lambda: tk.detector_reference(*k2_in))
    k1_out = tk.trace_deviation(*k1_in)
    k2_out = tk.detector(*k2_in)
    k1_ops, _ = count_ops(tk.trace_deviation_reference, k1_in[0],
                          k1_in[1][:, :1], k1_in[2][:, :1], k1_in[3])
    k2_ops, _ = count_ops(tk.detector_reference, k2_in[0],
                          *[t[..., :1] for t in k2_in[1:]])
    k1_b = bound(nbytes(*k1_in[:3], *k1_out), k1_ops * n_rays)
    k2_b = bound(nbytes(*k2_in, *k2_out), k2_ops * n_rays)
    return ({"ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_b[0],
             "bound_by": k1_b[1], "ops_per_ray": k1_ops},
            {"ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_b[0],
             "bound_by": k2_b[1], "ops_per_ray": k2_ops})


def gradient_pairs(vec, build):
    """The bench loss's gradient at N_SIDE x N_SIDE and akbx's two pairs:
    the f64-field loss on the fast engine against the f64 engine, the
    deviation-field loss against the f64-field loss (``grad_rel``).
    Returns (r_engine, r_loss, the worst component as (index, its |g_ref|
    over the largest, its error), the gradient)."""
    _, g = grad_step(vec, N_SIDE, build=build)
    _, g_fast64 = grad_step(vec, N_SIDE, f64_field_loss, build=build)
    _, g_f64 = grad_step(vec, N_SIDE, f64_field_loss, "f64", build=build)
    rel = ((g_fast64 - g_f64).abs()
           / torch.clamp_min(g_f64.abs(), 1e-6 * g_f64.abs().max()))
    i = int(rel.argmax())
    worst = (i, float(g_f64[i].abs() / g_f64.abs().max()), float(rel[i]))
    return grad_rel(g_fast64, g_f64), grad_rel(g, g_fast64), worst, g


def phase13a_system(label, build, vec, tk, hk):
    """One new system at N_SIDE x N_SIDE from the focused seeded vector:
    the kernels bit for bit, the fast engine against the f64 engine, the
    bench loss's gradient, times.  Returns (launches, kernel times)."""
    from akbx_torch import trace

    n_rays = N_SIDE ** 2
    system = build(vec)
    k1_in, k2_in = k1_k2_bitwise(system, tk, label)

    reset_counts(tk, hk)
    res = trace.run(system, N_SIDE, N_SIDE, defocus=vec[0],
                    exit_pupil_uniform=False, tilt_correction=True,
                    precision="pallas")
    loss = bench_loss(res)
    torch.cuda.synchronize()
    launched = counts(tk, hk)
    check(launched == {"K1": 1, "K2": 1, "K3": 0},
          f"{label}: the fast engine launched {launched}")
    gold = trace.run(system, N_SIDE, N_SIDE, defocus=vec[0],
                     exit_pupil_uniform=False, tilt_correction=True,
                     precision="f64")
    v = res.valid
    check(torch.equal(gold.valid, v), f"{label}: valid differs from f64")
    e_det = float((res.detcenter - gold.detcenter)[:, v].abs().max())
    w_gold = gold.total_dist - trace.masked_mean(gold.total_dist, v)
    w_fast = res.total_dist - trace.masked_mean(res.total_dist, v)
    e_opl = float((w_fast - w_gold)[v].abs().max())
    print(f"[13a] {label}: fast engine {N_SIDE}x{N_SIDE}, launches "
          f"{launched}, valid {int(v.sum())} of {n_rays}, loss "
          f"{float(loss):.9e}; vs the f64 engine: detcenter {e_det:.3e} m "
          f"(bar 5e-9), demeaned OPL {e_opl:.3e} m (bar 1e-9), valid "
          "identical", flush=True)
    check(int(v.sum()) > 0 and e_det <= 5e-9 and e_opl <= 1e-9,
          f"{label}: fast engine vs f64 beyond akbx's bars")
    del res, gold, w_gold, w_fast

    r_engine, r_loss, worst, g = gradient_pairs(vec, build)
    print(f"[13a] {label}: gradient, f64-field loss, fast vs f64 engine "
          f"{r_engine:.3e}; deviation-field vs f64-field loss {r_loss:.3e} "
          f"(bars 1e-3, floor 1e-6 of the largest); worst component "
          f"(index, |g| / largest, error) {worst}; gradient "
          f"{g.cpu().numpy().tolist()}", flush=True)
    check(bool(torch.isfinite(g).all()) and r_engine < 1e-3
          and r_loss < 1e-3, f"{label}: gradient beyond 1e-3")
    ktimes = kernel_times(k1_in, k2_in, tk)
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    step_ms = time_ms(lambda: grad_step(vec, N_SIDE, build=build))
    peak_gb = (torch.cuda.max_memory_allocated() - live) / 1e9
    marks = StageMarks(tk)
    runs = []
    for rep in range(REPS + 2):
        marks.events.clear()
        torch.cuda.synchronize()
        staged_step(vec, marks, build=build)
        torch.cuda.synchronize()
        if rep >= 2:
            runs.append(marks.spans())
    split = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    k1, k2 = ktimes
    print(f"[13a] {label}: K1 {k1['ms']:.3f} ms (twin {k1['plain_ms']:.3f}, "
          f"{k1['ops_per_ray']} ops/ray -> bound {k1['bound_ms']:.3f} ms, "
          f"{k1['bound_by']}, {k1['bound_ms'] / k1['ms']:.3f} of it); K2 "
          f"{k2['ms']:.3f} ms (twin {k2['plain_ms']:.3f}, bound "
          f"{k2['bound_ms']:.3f} ms, {k2['bound_by']}, "
          f"{k2['bound_ms'] / k2['ms']:.3f}); fwd+bwd step {step_ms:.3f} "
          f"ms (median of {REPS}), {n_rays / (step_ms / 1e3):.6e} rays/s, "
          f"peak memory {peak_gb:.3f} GB; split (ms): "
          + "; ".join(f"{k} {x:.3f}" for k, x in split.items()), flush=True)
    return launched, ktimes


def figure_system(vec, dev):
    """The Wolter III+I system at ``vec``, footprints calibrated, with a
    seeded 3x3 Legendre figure of nm amplitude on every mirror; and the
    same system without figures."""
    from akbx_torch.systems import calibrate_uv

    base = calibrate_uv(build_system(vec))
    figs = np.random.default_rng(SEED + 7).normal(0.0, FIG_NM * 1e-9,
                                                  (len(base.mirrors), 3, 3))
    mirrors = tuple(m._replace(fig_coeffs=torch.tensor(f, device=dev))
                    for m, f in zip(base.mirrors, figs))
    return base._replace(mirrors=mirrors), base


def phase13b_figure(dev, vec, tk, hk):
    """Figure errors: the fast route with figures at N_SIDE^2 (the f64
    engine; no kernel), time and memory; the figure -> wavefront Jacobian
    of mirror 1 at 33x33."""
    from akbx_torch import trace

    sysf, base = figure_system(vec, dev)
    kw = dict(defocus=vec[0], exit_pupil_uniform=False, tilt_correction=True)
    reset_counts(tk, hk)
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    res = trace.run(sysf, N_SIDE, N_SIDE, precision="pallas", **kw)
    torch.cuda.synchronize()
    launched = counts(tk, hk)
    fig_ms = time_ms(lambda: trace.run(sysf, N_SIDE, N_SIDE,
                                       precision="pallas", **kw),
                     reps=3, warmup=1)
    peak_gb = (torch.cuda.max_memory_allocated() - live) / 1e9
    torch.cuda.synchronize()
    check(counts(tk, hk) == {"K1": 0, "K2": 0, "K3": 0},
          f"the figure route launched {counts(tk, hk)}")
    bare = trace.run(base, N_SIDE, N_SIDE, precision="f64", **kw)
    v = res.valid & bare.valid
    w_fig = res.total_dist - trace.masked_mean(res.total_dist, v)
    w_bare = bare.total_dist - trace.masked_mean(bare.total_dist, v)
    moved = float((w_fig - w_bare)[v].abs().max())
    finite = all(bool(torch.isfinite(getattr(res, f)[..., res.valid]).all())
                 for f in ("detcenter", "total_dist", "wave2"))
    print(f"[13b] figures ({FIG_NM} nm, 3x3 Legendre, every mirror) "
          f"{N_SIDE}x{N_SIDE} at precision='pallas' (the f64 engine): "
          f"launches {launched}; {fig_ms:.3f} ms (median of 3, CUDA events); "
          f"peak memory {peak_gb:.3f} GB; valid {int(res.valid.sum())}; the "
          f"figures move the demeaned OPL by up to {moved:.3e} m",
          flush=True)
    del res, bare, w_fig, w_bare

    n = 33

    def figure_shift(d):
        """The figures' change of the demeaned OPL at n x n on ``d``."""
        f, b = figure_system(vec.to(d), d)
        rf, rb = (trace.run(x, n, n, precision=p, defocus=vec[0].to(d),
                            exit_pupil_uniform=False, tilt_correction=True)
                  for x, p in ((f, "pallas"), (b, "f64")))
        ok = rf.valid & rb.valid
        return torch.where(ok, (rf.total_dist - rf.total_dist[ok].mean())
                           - (rb.total_dist - rb.total_dist[ok].mean()),
                           0.0).cpu()

    shift_card, shift_cpu = figure_shift(dev), figure_shift("cpu")
    # the card's change fitted to the CPU's: its scale must be the CPU's
    # to 1e-3.  Pointwise they differ by the f64 engine's own card-vs-CPU
    # noise (libm roundings amplified at grazing incidence; measured on
    # an H100: 1.069e-10 m here, 5.6e-11 m on the figure-free system at
    # 17x17)
    scale = float(torch.sum(shift_card * shift_cpu)
                  / torch.sum(shift_cpu * shift_cpu))
    e_shift = float((shift_card - shift_cpu).abs().max())
    print(f"[13b] the figures' change of the demeaned OPL at {n}x{n}: up "
          f"to {float(shift_cpu.abs().max()):.6e} m on the CPU; the card's "
          f"is {scale:.9f} of it (bar 1 +- 1e-3), {e_shift:.3e} m apart at "
          f"most; at {N_SIDE}x{N_SIDE} up to {moved:.3e} m (bar >= 0.1 x "
          f"{FIG_NM} nm)", flush=True)
    check(launched == {"K1": 0, "K2": 0, "K3": 0} and finite
          and moved >= 0.1 * FIG_NM * 1e-9 and abs(scale - 1.0) <= 1e-3,
          "the figure route")

    def w_of(fig9):
        m0 = sysf.mirrors[0]._replace(fig_coeffs=fig9.reshape(3, 3))
        r = trace.run(sysf._replace(mirrors=(m0,) + sysf.mirrors[1:]), n, n,
                      defocus=vec[0], exit_pupil_uniform=False)
        w = r.total_dist - trace.masked_mean(r.total_dist, r.valid)
        return torch.where(r.valid, w, 0.0)

    x0 = sysf.mirrors[0].fig_coeffs.reshape(9).detach()
    t0 = time.perf_counter()
    J = torch.autograd.functional.jacobian(w_of, x0, vectorize=True)
    jac_s = time.perf_counter() - t0
    h = 1e-6
    eye = torch.eye(9, dtype=torch.float64, device=dev)
    fd = torch.stack([(w_of(x0 + h * e) - w_of(x0 - h * e)) / (2 * h)
                      for e in eye], dim=1)
    e_fd = float((fd - J).abs().max() / J.abs().max())
    sv = torch.linalg.svdvals(J).cpu().numpy()
    strong = int((sv > 1e-2 * sv[0]).sum())
    print(f"[13b] figure -> wavefront Jacobian of mirror 1 at {n}x{n} "
          f"(reverse mode, {jac_s:.3f} s host clock): vs central "
          f"differences (step {h} m) {e_fd:.3e} of its largest entry (bar "
          f"1e-3); singular values / the largest "
          f"{np.round(sv / sv[0], 6).tolist()}, largest {sv[0]:.6e}; "
          f"{strong} above 1e-2 of it (akbx's test: >= 3)", flush=True)
    check(e_fd <= 1e-3 and strong >= 3 and sv[0] > 1.0,
          "figure Jacobian")
    return launched


def phase13c_df32(dev, vec, tk, hk):
    """The df32 engine at N_SIDE^2 against the f64 engine."""
    from akbx_torch import trace

    system = build_system(vec)
    kw = dict(defocus=vec[0], exit_pupil_uniform=False, tilt_correction=True)
    reset_counts(tk, hk)
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    res = trace.run(system, N_SIDE, N_SIDE, precision="df32", **kw)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - live) / 1e9
    df_ms = time_ms(lambda: trace.run(system, N_SIDE, N_SIDE,
                                      precision="df32", **kw),
                    reps=3, warmup=1)
    launched = counts(tk, hk)
    gold = trace.run(system, N_SIDE, N_SIDE, precision="f64", **kw)
    check(torch.equal(gold.valid, res.valid), "df32: valid differs")
    v = res.valid
    e_det = float((res.detcenter - gold.detcenter)[:, v].abs().max())
    e_wave = float((res.wave2 - gold.wave2)[v].abs().max())
    del res, gold
    rays = trace.ray_fan(trace.fan_angles(system.fan_h, N_SIDE),
                         trace.fan_angles(system.fan_v, N_SIDE))
    src = system.source[:, None].expand(3, rays.shape[1])
    tdf = trace.trace_df(system, rays, src)
    t64 = trace.trace(system, rays, src)
    e_pts = max(float((a - b)[:, v].abs().max())
                for a, b in zip(tdf.points, t64.points))
    print(f"[13c] df32 engine {N_SIDE}x{N_SIDE}: launches {launched}; "
          f"{df_ms:.3f} ms (median of 3, CUDA events), peak memory "
          f"{peak_gb:.3f} GB; vs the f64 engine: detcenter {e_det:.3e} m "
          f"(bar 1e-8), wave2 {e_wave:.3e} nm (bar 0.5), trace_df points "
          f"{e_pts:.3e} m (bar 2e-9)", flush=True)
    check(e_det <= 1e-8 and e_wave <= 0.5 and e_pts <= 2e-9,
          "df32 engine vs f64 beyond akbx's bars")


def phase13_cli(dev, base, tk, hk):
    """cli trace --system kb|tandem|alternating on the card, once each at
    its default fan (65, autofocus at 21)."""
    import contextlib
    import io as _io

    from akbx_torch import cli

    for system in ("kb", "tandem", "alternating"):
        buf = _io.StringIO()
        reset_counts(tk, hk)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["trace", "--system", system, "--out",
                           os.path.join(base, "cli13"), "--device",
                           str(dev)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"[13] cli trace --system {system}: rc {rc}, {cli_s:.3f} s "
              f"host clock, launches {counts(tk, hk)}; {out}", flush=True)
        check(rc == 0 and out["valid_rays"] > 0
              and np.isfinite(out["pv_6sigma_lambda"]),
              f"cli trace --system {system}")


def two_mirror(t):
    """The JSON entry of a kernel's times on KB's fan (two mirrors)."""
    return {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}


def phase13(dev, vec, base, tk, hk):
    """The other mirror systems, figure errors and the df32 engine."""
    launches, times = {}, {}
    for label, build in new_systems(dev).items():
        v = focused(build, vec)
        launches[label], times[label] = phase13a_system(label, build, v, tk,
                                                        hk)
    v31 = focused(build_system, vec)
    launches["figure"] = phase13b_figure(dev, v31, tk, hk)
    phase13c_df32(dev, v31, tk, hk)
    phase13_cli(dev, base, tk, hk)
    return launches, times


# --- phase 14: the design and fabrication path ------------------------------
NA_REL = 2e-3           # design-na card vs CPU: the root's conditioning
DESIGN_REL = 1e-9       # design_kb across devices when its DE inputs differ
# d l_o2 / d (na_o, x_3) of the exact NA design at cli design-na's defaults
# (50 digits; tests/test_torch_design.py::test_solve_na_constrained_gradient
# computes and holds them)
EXACT_DLO2 = (0.762520721630886, 1.0242128033621023)
SWEEP_RAYS = 257        # cli sweep-kb on the card: cli trace's fan
SWEEP_CPU_RAYS = 33     # the sweep on the card and on the host's CPU
# PV card vs CPU: the f64 engine's re-fan amplifies the two devices'
# rounding (ROADMAP F4) as it does the two packages' (the port's re-fan
# parity bar against akbx, tests/test_torch_systems_variants.py)
SWEEP_PV_REL = 1e-6
FAB_FAN = (33, 2049)    # the traced hyp_v cloud: across x along the mirror
NATIVE_SIDE = 129       # [14d]: a 129^2 -> 129^2 wave stage
NATIVE_REL = 3e-7       # native vs the f64 path, akbx's bar (test_native.py)


def run_cli(argv):
    """(JSON line, host seconds, synchronised) of one port CLI call."""
    import contextlib
    import io as _io

    from akbx_torch import cli

    buf = _io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return (json.loads(buf.getvalue().strip().splitlines()[-1]),
            time.perf_counter() - t0)


def rel_diff(a, b):
    a, b = float(a), float(b)
    return abs(a - b) / abs(b) if b else abs(a - b)


class StageClock:
    """Host-clock milliseconds of named calls, each between two
    synchronisations, counting only the outermost of nested calls (the
    traces inside auto_focus belong to the autofocus stage)."""

    def __init__(self):
        self.ms = {}
        self.depth = 0
        self._undo = []

    def wrap(self, owner, name, stage):
        raw = inspect.getattr_static(owner, name)
        fn = getattr(owner, name)

        def timed(*args, **kw):
            if self.depth:
                return fn(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.depth += 1
            try:
                return fn(*args, **kw)
            finally:
                self.depth -= 1
                torch.cuda.synchronize()
                self.ms[stage] = (self.ms.get(stage, 0.0)
                                  + (time.perf_counter() - t0) * 1e3)

        setattr(owner, name, staticmethod(timed)
                if isinstance(raw, staticmethod) else timed)
        self._undo.append((owner, name, raw))

    def restore(self):
        for owner, name, raw in reversed(self._undo):
            setattr(owner, name, raw)
        self._undo.clear()


def phase14a_design(dev, base):
    """cli design-kb and design-na, design_kb (EllipseNA + DE) and the
    NA design's implicit gradient, on the card against the CPU."""
    from akbx_torch import design, design_na

    cpu = torch.device("cpu")
    sides = (("card", dev), ("cpu", cpu))
    outs = {}
    for label, d in sides:
        outs[label] = run_cli(["design-kb", "--out",
                               os.path.join(base, f"dk_{label}"),
                               "--device", str(d)])
    (kb_card, s_card), (kb_cpu, s_cpu) = outs["card"], outs["cpu"]
    worst = max(rel_diff(kb_card[k], kb_cpu[k]) for k in ("na_h", "na_v",
                                                          "gap"))
    files = [[float(ln.split(":")[1]) for ln in open(o["kb_design"])]
             for o in (kb_card, kb_cpu)]
    worst = max([worst] + [rel_diff(a, b) for a, b in zip(*files)])
    print(f"[14a] cli design-kb: card {s_card * 1e3:.3f} ms, CPU "
          f"{s_cpu * 1e3:.3f} ms (host clock); {kb_card['na_h']:.15g} NA_h, "
          f"{kb_card['gap']:.15g} m gap; kb_design.txt and JSON card vs CPU "
          f"max rel {worst:.3e} (bar 1e-12)", flush=True)
    check(worst <= 1e-12, "cli design-kb: card vs CPU beyond 1e-12")

    # the first call on the card also loads the CUDA solver libraries
    cold = run_cli(["design-na", "--device", str(dev)])[1]
    for label, d in sides:
        outs[label] = run_cli(["design-na", "--device", str(d)])
    (na_card, s_card), (na_cpu, s_cpu) = outs["card"], outs["cpu"]
    fields = [k for k in na_cpu if not k.startswith("check_")
              and k != "iterations"]
    worst = max(rel_diff(na_card[k], na_cpu[k]) for k in fields)
    same = sum(na_card[k] == na_cpu[k] for k in na_cpu)
    print(f"[14a] cli design-na: card {s_card * 1e3:.3f} ms (first call "
          f"{cold * 1e3:.3f} ms; {na_card['iterations']} Newton steps, one "
          "host read each), "
          f"CPU {s_cpu * 1e3:.3f} ms ({na_cpu['iterations']}); fields card "
          f"vs CPU max rel {worst:.3e} (bar {NA_REL}, the root's "
          f"conditioning), {same} of {len(na_cpu)} bit-identical; checks "
          f"card a {na_card['check_a_error']:.3e}, na_i "
          f"{na_card['check_na_i_error']:.3e}, x_3 "
          f"{na_card['check_x_3_error']:.3e}", flush=True)
    for o in (na_card, na_cpu):
        check(abs(o["check_a_error"]) < 1e-10
              and abs(o["check_na_i_error"]) < 1e-7
              and abs(o["check_x_3_error"]) < 1e-4 and o["iterations"] < 50,
              "cli design-na misses akbx's bars")
    check(worst <= NA_REL, f"cli design-na: card vs CPU beyond {NA_REL}")

    # the IFT gradient of l_o2 in (na_o, x_3)
    grads = {}
    for label, d in sides:
        v = torch.tensor([0.02, 0.55], dtype=torch.float64, device=d,
                         requires_grad=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = design_na.solve_na_constrained(146.0, v[1], 1e-4, v[0])
        g, = torch.autograd.grad(sol.l_o2, v)
        grads[label] = (g.cpu().numpy(), time.perf_counter() - t0)
    g_card, t_card = grads["card"]
    g_cpu, t_cpu = grads["cpu"]
    e_exact = np.abs(g_card - EXACT_DLO2) / np.abs(EXACT_DLO2)
    e_cpu = np.abs(g_card - g_cpu) / np.abs(g_cpu)

    def l_o2(na_o, x_3):
        return float(design_na.solve_na_constrained(146.0, x_3, 1e-4, na_o,
                                                    device=dev).l_o2)

    fd = []
    for h in (1e-4, 1e-2):
        fd.append(((l_o2(0.02 * (1 + h), 0.55) - l_o2(0.02 * (1 - h), 0.55))
                   / (0.04 * h),
                   (l_o2(0.02, 0.55 * (1 + h)) - l_o2(0.02, 0.55 * (1 - h)))
                   / (1.1 * h)))
    e_fd = [np.abs(g_card - f) / np.abs(g_card) for f in fd]
    print(f"[14a] solve_na_constrained + IFT backward: card {t_card * 1e3:.3f}"
          f" ms, CPU {t_cpu * 1e3:.3f} ms (host clock); d l_o2/d(na_o, x_3) "
          f"card {g_card.tolist()}, vs the exact derivative "
          f"{e_exact.tolist()} (bar 1e-2), vs the CPU's {e_cpu.tolist()} "
          f"(bar 1e-2); central differences (relative step 1e-4: "
          f"{e_fd[0].tolist()}, 1e-2: {e_fd[1].tolist()}) resolve the root's "
          "rounding noise, not the derivative", flush=True)
    check(e_exact.max() <= 1e-2 and e_cpu.max() <= 1e-2,
          "the NA design's implicit gradient is off the exact derivative")

    # design_kb: EllipseNA on the device, the DE on the host
    case = (145.75, 1.05, 0.21, 0.0082, 0.0082, 0.32, 0.2287, 0.0)
    pairs, xs = {}, {}
    import scipy.optimize as so

    de = so.differential_evolution

    def record(*a, **kw):
        r = de(*a, **kw)
        xs[current] = r
        return r

    so.differential_evolution = record
    try:
        for current, d in sides:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pairs[current] = (design.design_kb(*case, seed=0, device=d),
                              time.perf_counter() - t0)
        # the card's DE from the CPU's V mirror: the same inputs
        v_cpu = pairs["cpu"][0][0]
        current = "same"
        design.design_ell_h(type("V", (), {
            k: getattr(v_cpu, k).to(dev) for k in ("edge", "f", "l_i2",
                                                   "theta_g1", "l_o2",
                                                   "l_i1")})(),
            0.32, 0.2287, 0.0, 0.0082, seed=0)
    finally:
        so.differential_evolution = de
    (v_card, h_card), t_card = pairs["card"]
    (v_cpu, h_cpu), t_cpu = pairs["cpu"]
    inputs = ("edge", "f", "l_i2", "theta_g1", "l_o2")
    ulps = {k: int(abs(np.float64(float(getattr(v_card, k))).view(np.int64)
                       - np.float64(float(getattr(v_cpu, k))).view(np.int64)))
            for k in inputs}
    same_inputs = not any(ulps.values())
    x_same = np.array_equal(xs["card"].x, xs["cpu"].x)
    bar = 1e-12 if same_inputs else DESIGN_REL
    worst = max(rel_diff(getattr(h_card, k), getattr(h_cpu, k))
                for k in ("l_o2", "x_1", "f"))
    print(f"[14a] design_kb (DE, seed 0, de_maxiter 10000): card "
          f"{t_card:.3f} s, CPU {t_cpu:.3f} s (host clock; "
          f"{xs['card'].nfev} objective calls); the DE's inputs from the V "
          f"mirror, card vs CPU in ulps {ulps}; DE x card {xs['card'].x.tolist()}"
          f" CPU {xs['cpu'].x.tolist()} (identical {x_same}); from the CPU's"
          f" inputs the card's DE x identical "
          f"{np.array_equal(xs['same'].x, xs['cpu'].x)}; H mirror l_o2, x_1,"
          f" f card vs CPU max rel {worst:.3e} (bar {bar})", flush=True)
    check(np.array_equal(xs["same"].x, xs["cpu"].x),
          "the DE differs from the same inputs")
    check(x_same or not same_inputs, "design_kb's DE x differs")
    check(worst <= bar, f"design_kb card vs CPU beyond {bar}")


def phase14b_sweep(dev, base, tk, hk):
    """cli sweep-kb at 5 designs and SWEEP_RAYS on the card, its stages
    and launches; the same sweep at SWEEP_CPU_RAYS on the card and on the
    host's CPU; the artifacts read back."""
    from akbx_torch import align, design, systems, tooling, trace, wavefront
    from akbx_torch.analysis import legendre, rectify

    clock = StageClock()
    for owner, name, stage in (
            (design, "kb_define", "design"),
            (systems.KBSpec, "from_kb_define", "design"),
            (align, "auto_focus", "autofocus"),
            (systems, "build_kb", "trace"), (trace, "run", "trace"),
            (wavefront, "wavefront_grid", "wavefront"),
            (wavefront, "pv_6sigma", "wavefront"),
            (rectify, "extract_square_region", "Legendre"),
            (legendre, "match_multi", "Legendre"),
            (legendre, "mode_pvs", "Legendre"),
            (legendre, "fit_sum", "Legendre"),
            (tooling, "write_sweep_artifacts", "artifacts"),
            (tooling, "write_kb_design", "artifacts")):
        clock.wrap(owner, name, stage)
    num = 5
    try:
        out, secs = run_cli(["sweep-kb", "--num", str(num), "--rays",
                             str(SWEEP_RAYS), "--out",
                             os.path.join(base, "sweep"), "--device",
                             str(dev)])
    finally:
        clock.restore()
    launched = counts(tk, hk)
    per_point = {k: v / num for k, v in clock.ms.items()}
    print(f"[14b] cli sweep-kb --num {num} --rays {SWEEP_RAYS}: {secs:.3f} s "
          f"host clock; NA {out['na']}, PV {out['pv']} waves, r2 "
          f"{out['r2']}; ms per design point (host clock, synchronised): "
          + "; ".join(f"{k} {v:.3f}" for k, v in per_point.items())
          + f"; launches {launched}", flush=True)
    check(launched == {"K1": 0, "K2": 0, "K3": 0},
          f"the sweep (the f64 engine) launched {launched}")
    check(out["r2"] is not None and np.isfinite(out["r2"])
          and np.all(np.isfinite(out["pv"])), "sweep-kb: non-finite output")
    data = tooling.collect_sweep(os.path.join(base, "sweep"), pv_index=-1)
    check(np.array_equal(data["NA_h"], out["na"])
          and np.array_equal(data["pv"], out["pv"])
          and len(data["folder"]) == num,
          "the sweep's artifacts do not read back")
    ips = [np.loadtxt(os.path.join(f, "inner_products.csv"), delimiter=",")
           for f in data["folder"]]
    n_modes = len(legendre.triangular_orders(5))
    check(all(np.all(np.isfinite(x)) and x.size == n_modes for x in ips),
          "the sweep's inner products")

    values = np.linspace(145.0, 147.0, num)
    six = (0.21, 0.16742, 0.180, 0.030, 0.15525, 0.05)
    runs = {}
    for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[label] = (tooling.kb_design_sweep(
            values, six, os.path.join(base, f"sweep_{label}"),
            n_rays=SWEEP_CPU_RAYS, device=d), time.perf_counter() - t0)
    (card, t_card), (cpu, t_cpu) = runs["card"], runs["cpu"]
    e_na = max(rel_diff(a, b) for a, b in zip(card["na"], cpu["na"]))
    e_pv = [rel_diff(a, b) for a, b in zip(card["pv"], cpu["pv"])]
    print(f"[14b] sweep at {SWEEP_CPU_RAYS} rays: card {t_card:.3f} s, the "
          f"host's CPU {t_cpu:.3f} s; NA card vs CPU max rel {e_na:.3e}; PV "
          f"card {card['pv'].tolist()} vs CPU: rel {e_pv} (bar "
          f"{SWEEP_PV_REL})", flush=True)
    check(e_na <= 1e-12, "sweep NA card vs CPU")
    check(max(e_pv) <= SWEEP_PV_REL,
          f"sweep PV card vs CPU beyond {SWEEP_PV_REL}")


def phase14c_fab(dev, base):
    """cli fab-profiles at its default length, the traced-versus-analytic
    loop on the card, and the core helpers on card tensors."""
    from akbx_torch import fab, trace
    from akbx_torch.core import geometry as geo
    from akbx_torch.core import precision as pr
    from akbx_torch.systems import (AlignParams, WOLTER_3_1_DEFAULT,
                                    build_wolter_3_1)

    out_dir = os.path.join(base, "fab")
    out, secs = run_cli(["fab-profiles", "--out", out_dir, "--device",
                         str(dev)])
    cpu_out, cpu_secs = run_cli(["fab-profiles", "--out", out_dir + "_cpu",
                                 "--device", "cpu"])
    files = sorted(os.listdir(out_dir))
    rows = {}
    for f in files:
        a = np.loadtxt(os.path.join(out_dir, f), delimiter=",", skiprows=1)
        b = np.loadtxt(os.path.join(out_dir + "_cpu", f), delimiter=",",
                       skiprows=1)
        check(a.ndim == 2 and a.shape[0] > 10 and np.all(np.isfinite(a)),
              f"fab-profiles wrote a bad {f}")
        # the CSVs print 1e-6 mm: an ulp of a mirror centre may flip a digit
        check(a.shape == b.shape and np.abs(a - b).max() <= 1.5e-6,
              f"fab-profiles {f}: card vs CPU")
        rows[f] = a.shape[0]
    e_rot = max(rel_diff(out[k]["rotation_deg"], cpu_out[k]["rotation_deg"])
                for k in out)
    print(f"[14c] cli fab-profiles --num 100000: {secs:.3f} s (CPU run "
          f"{cpu_secs:.3f} s), host clock; {len(files)} CSVs, rows {rows}, "
          f"within 1.5e-6 mm of the CPU run's; rotations "
          f"{ {k: v['rotation_deg'] for k, v in out.items()} } deg, card vs "
          f"CPU max rel {e_rot:.3e}", flush=True)
    check(len(files) == 7, f"fab-profiles wrote {len(files)} files")

    spec = WOLTER_3_1_DEFAULT
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sys_ = build_wolter_3_1(spec, AlignParams.zeros(dev))
    res = trace.run(sys_, *FAB_FAN, defocus=0.0, exit_pupil_uniform=False,
                    tilt_correction=False)
    cloud, coeffs = res.trace.points[0], sys_.mirrors[0].coeffs
    torch.cuda.synchronize()
    t_trace = time.perf_counter() - t0
    t0 = time.perf_counter()
    x_c, r = fab.canonical_conic_profile(cloud, coeffs)
    y_ana = fab.hyperbola_profile(spec.a_hyp_v, spec.b_hyp_v, 0.0, x_c)
    e_conic = float(np.abs(r - y_ana).max())
    order = np.argsort(x_c)
    x_c, r = x_c[order], r[order]
    prof = fab.sideview_profile(np.stack([x_c, 0 * x_c, r]))
    ana = fab.machining_profile(
        lambda x: fab.hyperbola_profile(spec.a_hyp_v, spec.b_hyp_v, 0.0, x),
        float(x_c.min() + x_c.max()) / 2, float(x_c.max() - x_c.min()),
        num=8000, pre_margin=(0.005, 0.02))
    x_a = ana["x_raw"] - np.min(ana["x_raw"])
    y_a = ana["y_raw"] - np.min(ana["y_raw"])
    x_t, y_t = prof[0] * 1e3, prof[1] * 1e3
    y_at = np.interp(x_t, x_a * 1e3, y_a * 1e3)
    dev_mm = y_t - (y_at - y_at.max() + y_t.max())
    dev_mm -= np.polyval(np.polyfit(x_t, dev_mm, 1), x_t)
    e_side = float(np.abs(dev_mm).max())
    resid = fab.compare_profiles(x_t, y_t, x_a * 1e3, y_a * 1e3, dx=0.05)[3]
    e_cmp = float(np.abs(resid).max())
    t_loop = time.perf_counter() - t0
    n_pts = cloud.shape[1]
    print(f"[14c] traced hyp_v cloud, {FAB_FAN[0]} x {FAB_FAN[1]} = {n_pts} "
          f"points on the f64 engine: build + trace {t_trace * 1e3:.3f} ms, "
          f"the host's loop {t_loop * 1e3:.3f} ms; |r - y_ana| "
          f"{e_conic:.3e} m (bar 1e-9), side profile after detrend "
          f"{e_side:.3e} mm (bar 1e-6), compare_profiles {e_cmp:.3e} mm "
          "(bar 2e-4)", flush=True)
    check(e_conic <= 1e-9 and e_side <= 1e-6 and e_cmp <= 2e-4,
          "the traced cloud misses the analytic profile")

    # core helpers on card tensors, against the same calls on the CPU
    s_card = geo.quadric_eval(coeffs, cloud)
    s_cpu = geo.quadric_eval(coeffs.cpu(), cloud.cpu())
    e_s = float(s_card.abs().max())
    e_s_cpu = float((s_card.cpu() - s_cpu).abs().max())
    rng = np.random.default_rng(SEED + 14)
    # a path near r_ref with a relative change eps of 1e-12 to 1e-11:
    # sqrt(d2) - r_ref = r_ref eps / 2 to 1e-11 of itself, and d2's three
    # roundings move it by up to ~4e-4 (akbx's bar, 1e-3)
    r_ref = torch.tensor(rng.uniform(70.0, 150.0, 1 << 20),
                         dtype=torch.float64, device=dev)
    eps = torch.tensor(rng.choice([-1.0, 1.0], 1 << 20)
                       * 10.0 ** rng.uniform(-12.0, -11.0, 1 << 20),
                       dtype=torch.float64, device=dev)
    d2 = r_ref ** 2 * (1 + eps)
    sd = pr.stable_sqrt_diff(d2, r_ref)
    sd_cpu = pr.stable_sqrt_diff(d2.cpu(), r_ref.cpu())
    want = r_ref * eps / 2
    e_sd = float(((sd - want).abs() / want.abs()).max())
    e_sd_cpu = float((sd.cpu() - sd_cpu).abs().max() / sd_cpu.abs().max())
    legs = torch.tensor(np.append(rng.uniform(1.0, 100.0, 4), 1e-10),
                        dtype=torch.float64)
    k_card = float(pr.kahan_sum(legs.to(dev)))
    k_cpu = float(pr.kahan_sum(legs))
    print(f"[14c] core on the card: quadric_eval of the cloud max |S| "
          f"{e_s:.3e} (bar 1e-9), card vs CPU {e_s_cpu:.3e}; "
          f"stable_sqrt_diff on {d2.numel()} values vs r eps / 2 max rel "
          f"{e_sd:.3e} (bar 1e-3), card vs CPU {e_sd_cpu:.3e}; kahan_sum "
          f"card {k_card!r} CPU {k_cpu!r}", flush=True)
    check(e_s <= 1e-9 and e_s_cpu <= 1e-9, "quadric_eval of the cloud")
    check(e_sd <= 1e-3 and e_sd_cpu <= 1e-15, "stable_sqrt_diff")
    check(k_card == k_cpu, "kahan_sum card vs CPU")


def phase14d_native(dev, hk):
    """One NATIVE_SIDE^2 -> NATIVE_SIDE^2 stage: the native host engine
    against the f64 path on the card, beside K3."""
    from akbx_torch import native, wave

    n = NATIVE_SIDE ** 2
    src, tgt = huygens_cloud(dev, n, n, SEED + 14)
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    nat_s, nat = [], None
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nat = wave.propagate(src, tgt, EUV, backend="native")
        torch.cuda.synchronize()
        nat_s.append(time.perf_counter() - t0)
    check(nat[0].device == tgt.device, "native's result is not on the card")
    xla = wave.propagate(src, tgt, EUV, backend="xla")
    k3 = wave.propagate(src, tgt, EUV, backend="pallas")
    err, rel = field_err(nat, xla)
    k3_err, k3_rel = field_err(k3, xla)
    xla_ms = time_ms(lambda: wave.propagate(src, tgt, EUV, backend="xla"),
                     reps=3, warmup=1)
    k3_ms = time_ms(lambda: wave.propagate(src, tgt, EUV, backend="pallas"),
                    reps=REPS, warmup=2)
    pairs = n * n
    nat_ms = min(nat_s) * 1e3
    print(f"[14d] {n} x {n} = {pairs} pairs at 13.5 nm: native (g++ -O3 "
          f"-march=native -fopenmp, built in {build_s:.2f} s, "
          f"{native.num_threads()} threads) {nat_ms:.3f} ms host clock "
          f"(best of 2, copies included; {pairs / (nat_ms / 1e3):.4e} "
          f"pairs/s); the f64 path on the card {xla_ms:.3f} ms; K3 "
          f"{k3_ms:.3f} ms (CUDA events, median of {REPS}; "
          f"{pairs / (k3_ms / 1e3):.4e} pairs/s); native vs f64 max |err| "
          f"{err:.3e}, of the field {rel:.3e} (bar {NATIVE_REL}); K3 vs f64 "
          f"{k3_rel:.3e} (bar {FIELD_REL})", flush=True)
    check(rel <= NATIVE_REL, "native disagrees with the f64 path")
    check(k3_rel <= FIELD_REL, "K3 disagrees with the f64 path")


def phase14(dev, base, tk, hk):
    """The design and fabrication path on the card; returns its launches
    of K1-K3 (all 0: design, the sweep's f64 engine and fab run none)."""
    reset_counts(tk, hk)
    phase14a_design(dev, base)
    phase14b_sweep(dev, base, tk, hk)
    phase14c_fab(dev, base)
    launched = counts(tk, hk)
    check(launched == {"K1": 0, "K2": 0, "K3": 0},
          f"design and fab launched {launched}")
    phase14d_native(dev, hk)
    return launched


def main():
    t_start = time.perf_counter()
    # --- 1. the card -----------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from akbx_torch import trace
    from akbx_torch.kernels import _build
    from akbx_torch.kernels import huygens as hk
    from akbx_torch.kernels import trace_kernel as tk
    from akbx_torch.systems import (AlignParams, WOLTER_3_1_DEFAULT,
                                    build_wolter_3_1)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device(DEVICE, 0)
    name = torch.cuda.get_device_name(0)
    print(f"[1] card {name!r}, {torch.cuda.device_count()} visible; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "torch.backends.cuda.matmul.allow_tf32 is on")

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    log = (_build.BUILD_ROOT / _build.source_hash() / "build.log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    print(f"[2] kernels built and loaded in {build_s:.2f} s; "
          + " | ".join(ptxas), flush=True)
    check_ptx(hk)

    # --- 3. kernels vs twins on the card ---------------------------------
    check_two_prod(dev)
    system0 = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.zeros(dev))
    rays = trace.ray_fan(trace.fan_angles(system0.fan_h, N_SIDE),
                         trace.fan_angles(system0.fan_v, N_SIDE))
    n_rays = rays.shape[1]
    src = system0.source[:, None].expand(3, n_rays)
    chief_d0, chief_p0, consts64 = trace._fast_scalars(system0, rays, src,
                                                       n_rays // 2)
    (Ms, bvecs, Ds, Dns, Ts, A_noms, Bp_noms, rhos, gCs, gAs, branches,
     Ps) = consts64
    consts = tk.pack_consts(Ms, gCs, gAs, Ds, Dns, Ts, A_noms, Bp_noms,
                            rhos, branches, bvecs)
    fan_dp = (src - chief_p0).contiguous()
    fan_dd = (rays - chief_d0).contiguous()
    rng = np.random.default_rng(SEED)
    scale = fan_dd.abs().amax(dim=1, keepdim=True)
    rnd_dd = torch.tensor(rng.uniform(-1.0, 1.0, (3, N_RAGGED)),
                          dtype=torch.float64, device=dev) * scale
    rnd_dp = torch.tensor(rng.normal(0.0, 1e-6, (3, N_RAGGED)),
                          dtype=torch.float64, device=dev)
    det_x = system0.s2f_middle
    k_err = {"K1": [0.0, 0.0], "K2": [0.0, 0.0]}
    for label, dp, dd in (("fan", fan_dp, fan_dd),
                          ("random", rnd_dp, rnd_dd)):
        n = dp.shape[1]
        k1 = tk.trace_deviation(consts, dp, dd, 4)
        torch.cuda.synchronize()
        t1 = tk.trace_deviation_reference(consts, dp, dd, 4)
        r1, a1 = compare_outputs(k1, t1, valid_index=8)
        # K2 with the path's own detector constants for these rays
        valid = t1[8][0] > 0.5
        q4 = (t1[0][9:12], t1[1][9:12])
        d4 = (t1[2][9:12], t1[3][9:12])
        th_y, th_z = trace._tilt_stats(Dns[-1], f64_of(*d4), valid, True,
                                       "mean")
        focus = trace._pre_tilt_focus(Ps[-1], Dns[-1], det_x, f64_of(*q4),
                                      f64_of(*d4), valid)
        (R, P4r, D4r, t_c, _, L, t_c2, _, L2, _, _) = \
            trace._fast_post_scalars(consts64, det_x, det_x + 1e-3, th_y,
                                     th_z, focus, True)
        dcon = torch.cat([tk.pack_det_consts(R, D4r, t_c, L),
                          tk.pack_det_consts(R, D4r, t_c2, L2)])
        ins = (*q4, *d4, t1[6], t1[7])
        k2 = tk.detector(dcon, *ins)
        torch.cuda.synchronize()
        t2 = tk.detector_reference(dcon, *ins)
        r2, a2 = compare_outputs(k2, t2)
        for key, r, a in (("K1", r1, a1), ("K2", r2, a2)):
            k_err[key] = [max(k_err[key][0], r), max(k_err[key][1], a)]
        print(f"[3] {label} N={n}: K1 vs twin max |err|/scale {r1:.3e} "
              f"(max |err| {a1:.3e}), valid identical; K2 vs twin "
              f"{r2:.3e} (max |err| {a2:.3e})", flush=True)
        check(r1 <= KERNEL_REL and r2 <= KERNEL_REL,
              f"kernel disagrees with its twin beyond {KERNEL_REL}")
        del k1, t1, k2, t2

    # --- 4. the forward main path ----------------------------------------
    vec = torch.tensor(np.random.default_rng(SEED + 1).normal(0.0, 1e-5, 26),
                       dtype=torch.float64, device=dev)

    def run_and_loss(system):
        res = trace.run(system, N_SIDE, N_SIDE, defocus=vec[0],
                        exit_pupil_uniform=False, tilt_correction=True,
                        precision="pallas")
        return res, bench_loss(res), trace.spot_size(res.ddet32, res.valid)

    def forward():
        system = build_wolter_3_1(WOLTER_3_1_DEFAULT,
                                  AlignParams.from_vector(vec))
        return (system, *run_and_loss(system))

    reset_counts(tk, hk)
    system, res, loss, (sy, sz) = forward()
    torch.cuda.synchronize()
    launches = counts(tk, hk)
    check(launches == {"K1": 1, "K2": 1, "K3": 0},
          f"main path launched {launches}, want K1 once and K2 once")
    n_valid = int(res.valid.sum())
    check(n_valid == n_rays, f"{n_rays - n_valid} invalid rays")
    for f in ("detcenter", "detcenter2", "total_dist", "total_dist2",
              "wave2", "w32", "w32_2", "ddet32"):
        x = getattr(res, f)
        check(bool(torch.isfinite(x).all()), f"non-finite {f}")
        check(x.shape[-1] == n_rays, f"{f} has shape {tuple(x.shape)}")
    sy64, sz64 = trace.spot_size(res.detcenter, res.valid)
    print(f"[4] main path {N_SIDE}x{N_SIDE} ({n_rays} rays): launches "
          f"{launches}; loss {float(loss):.9e}; spot (ddet32) sy "
          f"{float(sy):.6e} m sz {float(sz):.6e} m; spot (detcenter f64) "
          f"sy {float(sy64):.6e} sz {float(sz64):.6e}; valid fraction "
          f"{n_valid / n_rays}", flush=True)

    # --- 5. against the port's f64 golden ---------------------------------
    gold = trace.run(system, N_SIDE, N_SIDE, defocus=vec[0],
                     exit_pupil_uniform=False, tilt_correction=True,
                     precision="f64")
    check(torch.equal(gold.valid, res.valid), "valid differs from golden")
    e_det = float((res.detcenter - gold.detcenter).abs().max())
    w_gold = gold.total_dist - trace.masked_mean(gold.total_dist, gold.valid)
    w_fast = res.total_dist - trace.masked_mean(res.total_dist, res.valid)
    e_opl = float((w_fast - w_gold).abs().max())
    e_w32 = float((res.w32.double() - w_gold).abs().max())
    e_pts = [float((res.trace.points[i] - gold.trace.points[i]).abs().max())
             for i in range(4)]
    print(f"[5] vs f64 golden: detcenter {e_det:.3e} m (bar 5e-9), demeaned "
          f"OPL {e_opl:.3e} m (bar 1e-9), w32 {e_w32:.3e} m (bar 2e-9), "
          f"points m1-m4 {[f'{e:.3e}' for e in e_pts]} m (bar 5e-9 on "
          f"m1-m3)", flush=True)
    check(e_det <= 5e-9 and e_opl <= 1e-9 and e_w32 <= 2e-9
          and max(e_pts[:3]) <= 5e-9, "fast path vs f64 golden beyond bars")
    del gold, w_gold, w_fast

    small = []
    for d in (dev, torch.device("cpu")):
        s = build_wolter_3_1(WOLTER_3_1_DEFAULT,
                             AlignParams.from_vector(vec.to(d)))
        small.append(trace.run(s, 9, 9, defocus=vec[0].to(d),
                               exit_pupil_uniform=False, precision="pallas"))
    e_small = float((small[0].detcenter.cpu() - small[1].detcenter).abs().max())
    e_small_w = float((small[0].w32.cpu() - small[1].w32).abs().max())
    e_small_t = abs(float(small[0].theta_y) - float(small[1].theta_y))
    # same kernels/twins bit for bit; the f64 reductions and libm calls
    # round differently on the card
    print(f"[5] 9x9 on the card vs on the CPU: detcenter {e_small:.3e} m, "
          f"w32 {e_small_w:.3e} m (bar 1e-9), theta_y {e_small_t:.3e} rad",
          flush=True)
    check(e_small <= 1e-9 and e_small_w <= 1e-9, "card vs CPU at 9x9")

    # --- 6. times ---------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: forward()[2])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[6] forward step (build + run + loss) {step_ms:.3f} ms, "
          f"{n_rays / (step_ms / 1e3):.6e} rays/s, peak memory "
          f"{peak_gb:.3f} GB", flush=True)

    # the split: the same step, cut by CUDA events at its stage boundaries
    marks = StageMarks(tk)
    trace.tk = marks
    try:
        runs = []
        for rep in range(REPS + 2):
            marks.events.clear()
            torch.cuda.synchronize()
            marks.mark(None)
            system_t = build_wolter_3_1(WOLTER_3_1_DEFAULT,
                                        AlignParams.from_vector(vec))
            marks.mark("system build")
            _, loss_t, _ = run_and_loss(system_t)
            marks.mark("f64 fields + loss")
            torch.cuda.synchronize()
            if rep >= 2:
                runs.append(marks.spans())
    finally:
        trace.tk = tk
    check(float(loss_t) == float(loss), "the staged step's loss differs")
    split = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    split_total = statistics.median(sum(r.values()) for r in runs)
    rays_m = trace.ray_fan(trace.fan_angles(system.fan_h, N_SIDE),
                           trace.fan_angles(system.fan_v, N_SIDE))
    src_m = system.source[:, None].expand(3, n_rays)
    det_x = system.s2f_middle + vec[0]
    materialize_ms = time_ms(
        lambda lazy: lazy.materialize(), reps=5,
        setup=lambda: trace.run_fast(system, rays_m, src_m, det_x,
                                     det_x + 1e-3)["trace"])
    print(f"[6] split (ms, median of {REPS}; staged step {split_total:.3f}): "
          + "; ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; materialize f64 TraceResult (on access only, not in the "
          f"step) {materialize_ms:.3f}", flush=True)

    # each kernel alone and its twin, on the inputs the main path gave it
    k1_in, k2_in = marks.args["trace_deviation"], marks.args["detector"]
    k1_ms = time_ms(lambda: tk.trace_deviation(*k1_in))
    k1_plain = time_ms(lambda: tk.trace_deviation_reference(*k1_in),
                       warmup=1)
    k2_ms = time_ms(lambda: tk.detector(*k2_in))
    k2_plain = time_ms(lambda: tk.detector_reference(*k2_in), warmup=1)
    print(f"[6] K1 kernel {k1_ms:.3f} ms vs twin {k1_plain:.3f} ms; K2 "
          f"kernel {k2_ms:.3f} ms vs twin {k2_plain:.3f} ms "
          f"(N={n_rays})", flush=True)
    # bounds: each input read and each output written once; operations
    # counted on the twins at one ray
    k1_out = tk.trace_deviation(*k1_in)
    k2_out = tk.detector(*k2_in)
    k1_ops, _ = count_ops(tk.trace_deviation_reference, k1_in[0],
                          k1_in[1][:, :1], k1_in[2][:, :1], k1_in[3])
    k2_ops, _ = count_ops(tk.detector_reference, k2_in[0],
                          *[t[..., :1] for t in k2_in[1:]])
    k1_bound = bound(nbytes(*k1_in[:3], *k1_out), k1_ops * n_rays)
    k2_bound = bound(nbytes(*k2_in, *k2_out), k2_ops * n_rays)
    del k1_out, k2_out
    print(f"[6] bounds (a two_prod counted as 2 operations): K1 {k1_ops} "
          f"ops/ray -> {k1_bound[0]:.3f} ms ({k1_bound[1]}), "
          f"{k1_bound[0] / k1_ms:.3f} of it; K2 {k2_ops} ops/ray -> "
          f"{k2_bound[0]:.3f} ms ({k2_bound[1]}), "
          f"{k2_bound[0] / k2_ms:.3f} of it", flush=True)

    # --- 7. K3 against its twin ------------------------------------------
    k3_err = phase7_k3(dev, hk)

    # --- 8. the wave path ----------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="akbx_wave_") as base:
        w = phase8_wave(dev, vec, base, tk, hk)
        k3_err = max(k3_err, w["handoff_err"])
        w_launches = w["launches"]

        # --- 9. times of the wave path -----------------------------------
        k3_t = phase9_times(dev, w, hk)
        k3_err = max(k3_err, k3_t.pop("max_abs_err"))
        del w

        # --- 10.-12. the backward, cli trace and align ---------------------
        launches = phase10_fwd_bwd(dev, vec, tk, hk)
        phase11_cli_trace(dev, vec, base, tk, hk)
        phase12_align(dev, vec, base, tk, hk)

        # --- 13. the other systems, figure errors, the df32 engine ------
        t13 = time.perf_counter()
        print(f"[13] phases 1-12 took {t13 - t_start:.1f} s", flush=True)
        launches13, times13 = phase13(dev, vec, base, tk, hk)
        print(f"[13] phase 13 took {time.perf_counter() - t13:.1f} s",
              flush=True)

        # --- 14. the design and fabrication path ------------------------
        t14 = time.perf_counter()
        launches14 = phase14(dev, base, tk, hk)
        print(f"[14] phase 14 took {time.perf_counter() - t14:.1f} s",
              flush=True)

    kernels = [
        {"name": "K1 trace_deviation (bounce chain)", "route": "cuda",
         "source": "akbx_torch/csrc/trace_kernel.cu",
         "replaces": "akbx/kernels/trace_kernel.py:227",
         "launches": launches["K1"], "max_abs_err": k_err["K1"][1],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None,
         "n_mirr_2": two_mirror(times13["kb"][0]),
         "launches_phase_13": {k: v["K1"] for k, v in launches13.items()},
         "launches_phase_14": launches14["K1"]},
        {"name": "K2 detector (tilt + detector planes + OPL)",
         "route": "cuda", "source": "akbx_torch/csrc/trace_kernel.cu",
         "replaces": "akbx/kernels/trace_kernel.py:469",
         "launches": launches["K2"], "max_abs_err": k_err["K2"][1],
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None,
         "n_mirr_2": two_mirror(times13["kb"][1]),
         "launches_phase_13": {k: v["K2"] for k, v in launches13.items()},
         "launches_phase_14": launches14["K2"]},
        {"name": "K3 huygens (df32 Huygens contraction)", "route": "cuda",
         "source": "akbx_torch/csrc/huygens_kernel.cu",
         "replaces": "akbx/kernels/huygens.py:150",
         "launches": w_launches, "max_abs_err": k3_err, **k3_t,
         "library_ms": None, "launches_phase_14": launches14["K3"]},
    ]
    print(f"[14] wall time {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
