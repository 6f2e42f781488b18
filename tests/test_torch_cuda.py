"""The CUDA kernels K1/K2 on the card against their PyTorch twins, and the
fast path on the card against the same on the CPU.

Needs a CUDA card and nvcc; skips otherwise.  This file imports no jax,
so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from akbx_torch import trace
from akbx_torch.kernels import trace_kernel as tk
from akbx_torch.systems import AlignParams, WOLTER_3_1_DEFAULT, build_wolter_3_1

pytestmark = pytest.mark.cuda

# kernel vs twin, per output: the same df32 operations in the same order;
# only rsqrtf's first guess may round differently, and the double-word
# Newton step corrects it
KERNEL_REL = 1e-11


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
