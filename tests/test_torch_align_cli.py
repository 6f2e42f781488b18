"""``cli align`` of the port against akbx's at a 9-ray fan: the
compare_sep aberration vector before and after one sensitivity solve
over pitch and roll of the V hyperbola (indices 2, 3), and the solved
parameters.  akbx takes the sensitivity matrix with ``jax.jacfwd``, the
port in reverse mode, both on the f64 engine, so this also holds
``align.sensitivity_matrix`` against akbx's."""

import contextlib
import io as _io
import json
import os

import numpy as np
import pytest
import torch

from akbx import cli as jcli
from akbx_torch import cli as tcli

torch.set_num_threads(2)

# of each vector's largest entry: the two packages' f64 engines trace the
# same system to 1e-10 m (tests/test_torch_trace.py), and the solve
# divides such differences by the Jacobian (measured <= 1.5e-8)
REL = 1e-5


def _cli(mod, *argv):
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(list(argv)) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("align")
    argv = ("align", "--rays", "9", "--no-autofocus", "--indices", "2,3")
    return (d, _cli(jcli, *argv, "--out", str(d / "j")),
            _cli(tcli, *argv, "--out", str(d / "t"), "--device", "cpu"))


@pytest.mark.parametrize("key", ["abrr_before", "abrr_after", "params"])
def test_cli_align_matches_akbx(runs, key):
    _, j, t = runs
    a, b = np.asarray(t[key]), np.asarray(j[key])
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=REL * np.abs(b).max())


def test_cli_align_solves(runs):
    """The solve moves only the chosen parameters, lowers the dominant
    (astigmatism) component, and writes the solved vector where akbx's
    reader finds it."""
    from akbx import io as jio

    d, _, t = runs
    assert t["indices"] == [2, 3]
    p = np.asarray(t["params"])
    assert np.count_nonzero(p) == 2 and p[2] != 0 and p[3] != 0
    assert abs(t["abrr_after"][0]) < abs(t["abrr_before"][0])
    np.testing.assert_array_equal(
        jio.read_optical_params(os.path.join(d / "t", "optical_params.txt")),
        p)
