"""The port's design and fabrication commands against akbx's CLI on the
CPU (``cli sweep-kb`` is held in tests/test_torch_fab_tooling.py).

``design-kb`` and ``fab-profiles`` print akbx's JSON line to 1e-12 of
each value and write the same files.  ``design-na``'s Newton root is
conditioning-limited (tests/test_torch_design.py): its values are held to
akbx's within 2e-3, and its check errors, which sit at the noise floor,
to akbx's bars (tests/test_cli.py, tests/test_design_na.py).
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from akbx import cli as jcli
from akbx_torch import cli as tcli

torch.set_num_threads(2)


def _run(mod, *argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(list(argv)) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _close(t, j, rel=1e-12):
    assert abs(t - j) <= rel * abs(j), (t, j)


def test_design_kb(tmp_path):
    j = _run(jcli, "design-kb", "--out", str(tmp_path / "j"))
    t = _run(tcli, "design-kb", "--out", str(tmp_path / "t"), "--device",
             "cpu")
    assert sorted(t) == sorted(j)
    for k in ("na_h", "na_v", "gap"):
        _close(t[k], j[k])
    lines = [open(run["kb_design"]).read().splitlines() for run in (t, j)]
    assert [ln.split(":")[0] for ln in lines[0]] == \
        [ln.split(":")[0] for ln in lines[1]]
    for a, b in zip(*lines):
        _close(float(a.split(":")[1]), float(b.split(":")[1]))


def test_fab_profiles(tmp_path):
    """All seven CSVs, byte for byte, and the JSON line (the mirror
    centres come from the port's geometry.intersect and
    wolter_iii_angles, in torch)."""
    j = _run(jcli, "fab-profiles", "--num", "4000", "--out",
             str(tmp_path / "j"))
    t = _run(tcli, "fab-profiles", "--num", "4000", "--out",
             str(tmp_path / "t"), "--device", "cpu")
    assert sorted(t) == sorted(j) == ["ell_v", "hyp_v", "wolter1"]
    for name in j:
        _close(t[name]["rotation_deg"], j[name]["rotation_deg"])
    files = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == files and len(files) == 7
    for f in files:
        a = np.loadtxt(tmp_path / "t" / f, delimiter=",", skiprows=1)
        b = np.loadtxt(tmp_path / "j" / f, delimiter=",", skiprows=1)
        assert a.shape == b.shape and a.shape[0] > 10
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-6)


def test_mirror_centers_match_akbx():
    """The two V-mirror centres of fab-profiles to 1e-12 of themselves."""
    import jax.numpy as jnp

    from akbx import design as jd
    from akbx.core import geometry as jgeo
    from akbx.surfaces import ellipse_coeffs, hyperbola_coeffs
    from akbx.systems import WOLTER_3_1_DEFAULT as spec

    t = tcli.mirror_centers(spec, "cpu")
    d = jnp.array([[np.cos(spec.theta1_v)], [0.0], [np.sin(spec.theta1_v)]])
    c_hyp = jgeo.shift_x(hyperbola_coeffs(spec.a_hyp_v, spec.b_hyp_v, "xz"),
                         spec.org_hyp_v)
    _close(t["hyp_v"], float(jgeo.intersect(c_hyp, d, jnp.zeros((3, 1)))
                             [0][0, 0]))
    th3 = float(jd.wolter_iii_angles(
        spec.a_hyp_v, spec.b_hyp_v, spec.org_hyp_v, spec.a_ell_v,
        spec.b_ell_v, spec.org_ell_v, spec.theta1_v)[1])
    c_ell = jgeo.shift_x(ellipse_coeffs(spec.a_ell_v, spec.b_ell_v, "xz"),
                         2 * spec.org_hyp_v + spec.org_ell_v)
    d3 = jnp.array([[np.cos(th3)], [0.0], [np.sin(th3)]])
    src3 = jnp.array([[2 * spec.org_hyp_v], [0.0], [0.0]])
    _close(t["ell_v"], float(jgeo.intersect(c_ell, d3, src3)[0][0, 0]))


def test_design_na():
    j = _run(jcli, "design-na")
    t = _run(tcli, "design-na", "--device", "cpu")
    assert sorted(t) == sorted(j)
    for k in j:
        if k.startswith("check_") or k == "iterations":
            continue
        _close(t[k], j[k], 2e-3)
    assert t["x_1"] == j["x_1"] == 146.0
    assert abs(t["check_a_error"]) < 1e-10
    assert abs(t["check_na_i_error"]) < 1e-7
    assert abs(t["check_x_3_error"]) < 1e-4
    assert t["iterations"] < 50


@pytest.mark.parametrize("cmd", ["plot", "gui"])
def test_unported_commands_raise(cmd, capsys):
    """akbx's last two commands are ported: the port keeps no list of
    unported ones, and each parses akbx's arguments plus ``--device``
    (``cli plot`` runs in tests/test_torch_plotting.py)."""
    assert not hasattr(tcli, "UNPORTED")
    with pytest.raises(SystemExit) as done:
        tcli.main([cmd, "--help"])
    assert done.value.code == 0
    assert "--device" in capsys.readouterr().out
