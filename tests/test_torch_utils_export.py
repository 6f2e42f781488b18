"""akbx_torch.export.around_focus_spots against akbx's, and the port's
utils.TeeOutput, progress_chunks (against akbx's) and profile_trace."""

import io
import json
import os

import numpy as np
import pytest

import torch

import jax.numpy as jnp

from akbx import export as jexport, trace as jtr, utils as jutils
from akbx_torch import export, trace, utils
from akbx_torch.systems import AlignParams, WOLTER_3_1_DEFAULT, build_wolter_3_1


def test_around_focus_spots_matches_akbx():
    """Five planes around focus of one 9x9 trace (f64 engine, tilt
    removal), handed to both packages (akbx's as jax arrays of the same
    values; the engines' own parity is tests/test_torch_trace.py's): x
    exact, spot std and centroid at 1e-12 m."""
    offsets = np.linspace(-2e-4, 2e-4, 5)
    t_sys = build_wolter_3_1(WOLTER_3_1_DEFAULT, AlignParams.zeros("cpu"))
    t = trace.run(t_sys, 9, 9, defocus=0.0, exit_pupil_uniform=False)
    got = export.around_focus_spots(t.trace, t_sys.s2f_middle, offsets)
    j_trace = jtr.TraceResult(*(tuple(jnp.asarray(x.numpy()) for x in f)
                                for f in t.trace[:4]),
                              jnp.asarray(t.trace.valid.numpy()))
    want = jexport.around_focus_spots(j_trace, float(t_sys.s2f_middle),
                                      offsets)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["x"] == pytest.approx(w["x"], rel=1e-15)
        for k in ("std_y", "std_z"):
            assert abs(g[k] - w[k]) <= 1e-12
        np.testing.assert_allclose(g["centroid"], w["centroid"], rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose([g["x"] for g in got],
                               float(t_sys.s2f_middle) + offsets, rtol=1e-15)


@pytest.mark.parametrize("total,fraction", [(1000, 0.01), (7, 0.5),
                                            (3, 0.01), (0, 0.1)])
def test_progress_chunks_matches_akbx(total, fraction):
    assert (utils.progress_chunks(total, fraction)
            == jutils.progress_chunks(total, fraction))


def test_tee_output(tmp_path):
    stream = io.StringIO()
    path = str(tmp_path / "log.txt")
    tee = utils.TeeOutput(path, stream=stream)
    tee.write("one\n")
    tee.write("two\n")
    tee.flush()
    tee.close()
    assert stream.getvalue() == "one\ntwo\n"
    with open(path) as f:
        assert f.read() == "one\ntwo\n"
    # appends, as akbx's does
    tee = utils.TeeOutput(path, stream=io.StringIO())
    tee.write("three\n")
    tee.close()
    with open(path) as f:
        assert f.read().splitlines() == ["one", "two", "three"]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """A profiled block leaves a Chrome trace in log_dir that names the
    block's stage ranges and its ops."""
    log_dir = str(tmp_path / "prof")
    with utils.profile_trace(log_dir) as prof:
        with utils.stage_timer("akbx_stage", log=lambda _: None):
            torch.ones(64, dtype=torch.float64).cumsum(0)
    assert prof is not None
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "akbx_stage" in names
    assert any(n and "cumsum" in n for n in names)
