"""akbx_torch.spans: off, nothing; on, one record a span at the layer
boundaries of a KB alignment step (build, trace forward, the twin's
backward) and of the wave stages, with the step id, parents and self
times; the step's numbers the same either way."""

import os
import threading

import pytest
import torch

from akbx_torch import spans, systems, trace, utils, wave

KB7 = dict(l1h=146.0, l2h=0.21, inc_h=0.16742, mlen_h=0.18, wd_v=0.03,
           inc_v=0.15525, mlen_v=0.05)
FAN = 16
STEP_PATHS = ("systems.build", "trace.run", "trace.run/trace.chief",
              "trace.run/trace.k1", "trace.run/trace.tilt",
              "trace.run/trace.k2", "trace.run/trace.finish",
              "twin.backward", "twin.backward/twin.rebuild",
              "twin.backward/twin.rebuild/trace.chief",
              "twin.backward/twin.vjp")
NAMES = {p.rpartition("/")[2] for p in STEP_PATHS}


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with the spans off and no records."""
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


@pytest.fixture(scope="module")
def spec():
    return systems.KBSpec.from_kb_define(**KB7, device="cpu")


def kb_step(spec, seed: int = 0):
    """One alignment step of KB7 on the CPU twins: build, the fast trace,
    the bench's loss, its gradient.  Returns (loss, gradient)."""
    v = (torch.randn(26, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(seed)) * 1e-5)
    v.requires_grad_(True)
    system = systems.build_kb(spec, systems.AlignParams.from_vector(v))
    res = trace.run(system, FAN, FAN, v[0], exit_pupil_uniform=False,
                    tilt_correction=True, precision="pallas")
    sy, sz = trace.spot_size(res.ddet32, res.valid)
    loss = (torch.sum(torch.where(res.valid, res.w32, 0.0) ** 2) * 1e18
            + sy + sz)
    loss.backward()
    return loss.detach(), v.grad


def test_off_span_is_the_one_null_context():
    assert not spans.enabled()
    a, b = spans.span("trace.run"), spans.span("ring")
    assert a is b
    with a as got:
        assert got is None


def test_off_step_records_nothing_and_opens_no_range(spec, monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(1))
    with torch.profiler.profile() as prof:
        kb_step(spec)
    assert not ({e.name for e in prof.events()} & NAMES)
    assert spans.take() == [] and made == []


def test_on_step_records_each_span_once(spec):
    spans.enable("cpu")
    spans.step(7)
    kb_step(spec)
    recs = spans.take()
    by_path = spans.summary(recs)
    assert set(by_path) == set(STEP_PATHS)
    assert all(d["count"] == 1 for d in by_path.values())
    assert all(r.step == 7 for r in recs)
    roots = {r.path for r in recs if r.parent is None}
    assert roots == {"systems.build", "trace.run", "twin.backward"}
    for r in recs:
        kids = [c for c in recs if c.parent == r.id]
        own = by_path[r.path]["self_ms"][0]
        assert own >= 0.0
        assert own + sum(c.ms for c in kids) == pytest.approx(r.ms,
                                                               abs=1e-9)
    assert spans.take() == []


def test_loss_and_gradient_bit_identical_on_and_off(spec):
    off = kb_step(spec, seed=3)
    spans.enable("cpu")
    on = kb_step(spec, seed=3)
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])


def test_a_span_on_another_thread_is_a_root_of_the_step():
    """The twin's backward runs on autograd's device thread on a card: a
    span opened on a thread with none open there is a root, with the
    step id set on any thread."""
    spans.enable("cpu")
    spans.step(2)
    with spans.span("outer"):
        t = threading.Thread(target=lambda: spans.span("inner").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join(timeout=60)
        assert not t.is_alive()
    recs = {r.path: r for r in spans.take()}
    assert set(recs) == {"outer", "inner"}
    assert recs["inner"].parent is None and recs["inner"].step == 2


def _rec(i, parent, path, start, end):
    return spans.Record(i, parent, path.rpartition("/")[2], path, 0, start,
                        end)


def test_summary_self_times_of_hand_made_records():
    """Two occurrences of a parent: children that overlap and one that
    runs past its parent's end count once, and only inside the parent."""
    recs = [_rec(0, None, "a", 0.0, 10.0), _rec(1, 0, "a/b", 1.0, 4.0),
            _rec(2, 0, "a/b", 3.0, 6.0), _rec(3, 0, "a/c", 8.0, 12.0),
            _rec(4, None, "a", 20.0, 25.0), _rec(5, 4, "a/b", 21.0, 22.0),
            _rec(6, 5, "a/b/d", 21.0, 21.5)]
    got = spans.summary(recs)
    assert got["a"] == {"count": 2, "ms": [10.0, 5.0],
                        "self_ms": [3.0, 4.0]}
    assert got["a/b"] == {"count": 3, "ms": [3.0, 3.0, 1.0],
                          "self_ms": [3.0, 3.0, 0.5]}
    assert got["a/c"]["self_ms"] == [4.0]
    assert got["a/b/d"]["self_ms"] == [0.5]


def test_wave_stages_are_spans(monkeypatch):
    """``huygens:<stage>`` a span of a stage with the spans on, a bare
    profiler range of that name with them off."""
    gen = torch.Generator().manual_seed(1)
    pts = torch.randn(3, 8, dtype=torch.float64, generator=gen) * 1e-3
    pts[0] += 1.0
    src = wave.WaveField(torch.zeros(3, 1, dtype=torch.float64),
                         torch.ones(1, dtype=torch.float64),
                         torch.zeros(1, dtype=torch.float64),
                         torch.ones(1, dtype=torch.float64), 0, 0)
    stages = [{"points": pts, "name": "M1"},
              {"points": pts + torch.tensor([[1.0], [0.0], [0.0]],
                                            dtype=torch.float64),
               "name": "M2"}]
    with torch.profiler.profile() as prof:
        off = wave.propagate_stages(src, stages, 13.5e-9)
    assert [e.name for e in prof.events()
            if e.name.startswith("huygens:")] == ["huygens:M1", "huygens:M2"]
    assert spans.take() == []
    spans.enable("cpu")
    on = wave.propagate_stages(src, stages, 13.5e-9)
    assert [r.path for r in spans.take()] == ["huygens:M1", "huygens:M2"]
    for a, b in zip(off, on):
        assert torch.equal(a.re, b.re) and torch.equal(a.im, b.im)


def test_stage_timer_is_a_span_when_on_and_profile_trace_restores(tmp_path):
    """``stage_timer`` records one span (and one range) with the spans on;
    ``profile_trace`` turns them on for its block, takes the block's
    records onto the profiler, then turns them off: nothing lingers."""
    with utils.profile_trace(str(tmp_path)) as prof:
        assert spans.enabled()
        with utils.stage_timer("akbx_stage", log=lambda _: None):
            torch.ones(4).sum()
    assert not spans.enabled()
    assert [r.path for r in prof.spans] == ["akbx_stage"]
    assert spans.take() == []
    assert sum(e.name == "akbx_stage" for e in prof.events()) == 1
    assert os.path.exists(tmp_path / "trace.json")


def test_profile_trace_leaves_spans_already_on_to_their_caller(tmp_path):
    spans.enable("cpu")
    with spans.span("outer"):
        with utils.profile_trace(str(tmp_path)) as prof:
            with spans.span("inner"):
                pass
    assert spans.enabled() and prof.spans is None
    assert [r.path for r in spans.take()] == ["outer", "outer/inner"]


@pytest.mark.parametrize("on", [False, True])
def test_span_or_range_is_a_bare_range_off_and_a_span_on(on):
    if on:
        spans.enable("cpu")
    with torch.profiler.profile() as prof:
        with spans.span_or_range("akbx_marked"):
            torch.ones(4).sum()
    assert sum(e.name == "akbx_marked" for e in prof.events()) == 1
    assert [r.path for r in spans.take()] == (["akbx_marked"] if on else [])


def test_spanned_calls_through_off_and_records_each_call_on():
    @spans.spanned("akbx_fn")
    def double(x):
        """Twice x."""
        return 2 * x

    assert double.__name__ == "double" and double(3) == 6
    assert spans.take() == []
    spans.enable("cpu")
    assert double(4) == 8 and double(5) == 10
    assert spans.summary(spans.take())["akbx_fn"]["count"] == 2


def test_a_span_that_raises_is_closed_and_leaves_no_parent():
    """An exception closes the span, passes through, and the next span
    opened on the thread is a root."""
    spans.enable("cpu")
    with pytest.raises(ValueError):
        with spans.span("fails"):
            raise ValueError("inside")
    with spans.span("after"):
        pass
    recs = spans.take()
    assert [(r.path, r.parent) for r in recs] == [("fails", None),
                                                 ("after", None)]


def test_each_step_of_two_carries_its_own_id(spec):
    """Two KB steps: each span twice, each occurrence with its step's id,
    the twin's backward on the autograd thread too."""
    spans.enable("cpu")
    for i in (4, 5):
        spans.step(i)
        kb_step(spec, seed=i)
    recs = spans.take()
    by_path = spans.summary(recs)
    assert set(by_path) == set(STEP_PATHS)
    assert all(d["count"] == 2 for d in by_path.values())
    for path in STEP_PATHS:
        assert sorted(r.step for r in recs if r.path == path) == [4, 5]
