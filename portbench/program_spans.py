"""The readings of the program's own spans (``akbx_torch.spans``), for
the harness to take over.

No metric reads them yet: the harness switches the spans on in no run.
A run that does (``spans.enable`` before the set-up, ``spans.step(i)``
before each step of the window, ``spans.summary(spans.take())`` after
it, ``ring_wait_ms`` of the records on each rank, and ``idle_by_span``
of a step profiled with the host's and the device's activity) gives
``readings`` the per-layer numbers it names.
"""

from __future__ import annotations

import statistics
from collections import defaultdict

from portbench import harness


def idle_by_span(events, names) -> dict:
    """Per span path, [the device's idle seconds inside the span's host
    intervals, the intervals' seconds], over the ``user_annotation``
    ranges of a profile's complete events whose name is in ``names``.  A
    range's path is its name under the ranges open around it on its own
    thread."""
    ops = sorted((a, b) for a, b, _ in harness._device_ops(events))
    ranges = sorted(((e["tid"], float(e["ts"]), float(e["dur"]), e["name"])
                     for e in events if e.get("cat") == "user_annotation"
                     and e["name"] in names), key=lambda r: (r[0], r[1],
                                                             -r[2]))
    out = defaultdict(lambda: [0.0, 0.0])
    stack = []
    for tid, ts, dur, name in ranges:
        while stack and (stack[-1][0] != tid or stack[-1][1] <= ts):
            stack.pop()
        path = f"{stack[-1][2]}/{name}" if stack else name
        stack.append((tid, ts + dur, path))
        busy = harness._union([(max(a, ts), min(b, ts + dur))
                               for a, b in ops if b > ts and a < ts + dur])
        out[path][0] += (dur - busy) * 1e-6
        out[path][1] += dur * 1e-6
    return dict(out)


def ring_wait_ms(records) -> float | None:
    """The median, over the ``ring`` spans of ``records``, of the total of
    their ``ring.wait`` children."""
    rings = {r.id: 0.0 for r in records if r.path == "ring"}
    for r in records:
        if r.path == "ring/ring.wait" and r.parent in rings:
            rings[r.parent] += r.ms
    return statistics.median(rings.values()) if rings else None


def _median(by_path, path):
    ms = by_path.get(path, {}).get("ms")
    return statistics.median(ms) if ms else None


def readings(by_path, idle, rank_ring_wait) -> dict:
    """The per-layer readings of the spans, where there is something to
    read: the median milliseconds a step of the chief trace, the tilt
    stage and the twin's two parts (``by_path``: ``spans.summary``); the
    device's idle share (%) of the twin's backward in the profiled step
    (``idle``: ``idle_by_span``); the largest rank's ``ring_wait_ms``."""
    out = {"chief_ms.align": _median(by_path, "trace.run/trace.chief"),
           "tilt_ms.align": _median(by_path, "trace.run/trace.tilt"),
           "twin_rebuild_ms.align": _median(by_path,
                                            "twin.backward/twin.rebuild"),
           "twin_vjp_ms.align": _median(by_path, "twin.backward/twin.vjp"),
           "twin_idle.align": None, "ring_wait_ms.wave": None}
    twin = (idle or {}).get("twin.backward")
    if twin and twin[1] > 0:
        out["twin_idle.align"] = 100.0 * twin[0] / twin[1]
    waits = [w for w in rank_ring_wait or () if w is not None]
    if waits:
        out["ring_wait_ms.wave"] = max(waits)
    return {k: v for k, v in out.items() if v is not None}
