"""The program's own spans (``akbx_torch.spans``) and the benchmark: an
untraced run leaves them off; ``portbench/program_spans.py`` reads the
six per-layer numbers from their records and from a profile."""

import types

import pytest
import torch
from conftest import run_small

from akbx_torch import spans
from portbench import program_spans


@pytest.mark.parametrize("cell", ["kb7.align-2048", "wolter31.wave-257"])
def test_untraced_run_never_enables_the_spans(bench, cell, monkeypatch):
    spans.disable()
    spans.take()
    calls = []
    monkeypatch.setattr(spans, "enable", lambda *a: calls.append(a))
    out = run_small(bench, cell, trace=False)
    assert out["correct"] is True
    assert calls == [] and not spans.enabled() and spans.take() == []


def _rec(i, parent, path, start, end):
    return spans.Record(i, parent, path.rpartition("/")[2], path, 0,
                        start, end)


def test_ring_wait_totals_the_waits_of_each_ring():
    recs = [_rec(0, None, "ring", 0.0, 10.0),
            _rec(1, 0, "ring/ring.sum", 0.0, 4.0),
            _rec(2, 0, "ring/ring.wait", 4.0, 5.0),
            _rec(3, 0, "ring/ring.wait", 8.0, 10.0),
            _rec(4, None, "ring", 20.0, 30.0),
            _rec(5, 4, "ring/ring.wait", 21.0, 22.0),
            _rec(6, None, "ring", 40.0, 50.0)]
    assert program_spans.ring_wait_ms(recs) == 1.0
    assert program_spans.ring_wait_ms(recs[:4]) == 3.0
    assert program_spans.ring_wait_ms(recs[1:4]) is None
    got = program_spans.readings({}, None, [1.0, 4.0, 2.5])
    assert got == {"ring_wait_ms.wave": 4.0}


def test_idle_by_span_puts_the_device_gaps_in_the_spans():
    """Ranges nest by thread; a range on another thread is a root; the
    device's idle time inside each range's host interval (us in the
    trace, seconds out)."""
    def ann(tid, ts, dur, name):
        return {"ph": "X", "cat": "user_annotation", "tid": tid, "ts": ts,
                "dur": dur, "name": name}

    def kern(ts, dur):
        return {"ph": "X", "cat": "kernel", "tid": 9, "ts": ts, "dur": dur,
                "name": "k"}

    events = [ann(1, 0, 100, "trace.run"), ann(1, 10, 20, "trace.k1"),
              ann(1, 50, 10, "other"), ann(2, 200, 100, "twin.backward"),
              ann(2, 210, 50, "twin.vjp"),
              kern(15, 10), kern(20, 30), kern(90, 40), kern(240, 10)]
    got = program_spans.idle_by_span(events, {"trace.run", "trace.k1",
                                              "twin.backward", "twin.vjp"})
    want = {"trace.run": [55e-6, 100e-6],
            "trace.run/trace.k1": [5e-6, 20e-6],
            "twin.backward": [90e-6, 100e-6],
            "twin.backward/twin.vjp": [40e-6, 50e-6]}
    assert set(got) == set(want)
    for k, (idle, length) in want.items():
        assert got[k] == [pytest.approx(idle), pytest.approx(length)]
    assert program_spans.readings({}, got, None) == {
        "twin_idle.align": pytest.approx(90.0)}


def test_readings_of_a_step_with_the_spans_on(bench):
    """One tiny KB7 step on the CPU twins with the spans on: the four
    step readings, nothing of the profile or the ring."""
    from conftest import small_cell

    from portbench import harness

    cpu = torch.device("cpu")
    cell = small_cell(bench, "kb7.align-2048")
    ctx = types.SimpleNamespace(device=cpu, seed=2**31 + 5,
                                config=cell.config, traffic=cell.traffic,
                                chips=1, trace=False, mesh=None)
    spans.disable()
    spans.take()
    state = cell.kind.setup(ctx, harness.Spans(cpu, False))
    spans.enable("cpu")
    try:
        spans.step(0)
        cell.kind.step(state, 0, None)
        got = program_spans.readings(spans.summary(spans.take()), None,
                                     None)
    finally:
        spans.disable()
        spans.take()
        cell.kind.free(state)
    assert set(got) == {"chief_ms.align", "tilt_ms.align",
                        "twin_rebuild_ms.align", "twin_vjp_ms.align"}
    assert all(v > 0.0 for v in got.values())
