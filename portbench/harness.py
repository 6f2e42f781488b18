"""The harness of portbench: one run of one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

* ``configs/<config>.json``: the configuration as it is run (the
  ``configs`` entry's ``file``); its ``system`` names the program's
  builder and, under ``reference`` and ``reference_trace``, the modules
  of ``reference/`` that hold its plain reference (``resolve.py``);
* ``traffic/<traffic>.json``: the traffic mix, a file of parameters whose
  ``kind`` names the general generator ``kinds/<kind>.py`` that reads it
  (set-up from the seed, the step, the check against the reference);
* ``workloads/<cell>.json``: the limits of the cell's ``correct``;
* ``metrics/<metric>.py``: a reader ``read(rec)`` of one metric, which
  returns a number or ``None`` where it finds nothing to read.

A run: look for the cards; check that every name the configuration gives
resolves in the program and in its reference; set up the kind (inputs
from the seed, the program's state, every shape the cell uses warmed
up), which is ``setup_s``; run steps until ``seconds`` have passed, the
window; read the peak memory; with ``trace`` run a short profiled window
after it; free the program's state; check its outputs against the
configuration's plain reference; check that no JAX module was loaded;
print the result as the last line of standard output.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import types
from collections import defaultdict

from portbench.resolve import unresolved

BANNED = ("jax", "jaxlib", "flax", "akbx")
PROFILE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def banned_modules(names=None) -> list:
    """The top-level names among ``names`` (default: ``sys.modules``)
    that are JAX's or the JAX package's, compared whole: ``akbx_torch``
    is not ``akbx``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


class LoadedJax(RuntimeError):
    """Some rank of the run loaded JAX or the JAX package."""


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _json(self, *parts):
        with open(os.path.join(self.root, *parts)) as f:
            return json.load(f)

    def cell(self, name: str) -> types.SimpleNamespace:
        work = {w["name"]: w for w in self.spec["workloads"]}
        if name not in work:
            raise SystemExit(f"portbench: no workload {name!r} in "
                             "BENCHMARK.json")
        w = work[name]
        config = {c["name"]: c for c in self.spec["configs"]}[w["config"]]
        traffic = self._json("portbench", "traffic", w["traffic"] + ".json")
        return types.SimpleNamespace(
            name=name, chips=w["chips"], config=self._json(config["file"]),
            traffic=traffic, limits=self._json("portbench", "workloads",
                                               name + ".json")["limits"],
            kind=importlib.import_module("portbench.kinds."
                                         + traffic["kind"]))

    def metrics(self, cell: str, trace: bool) -> list:
        """The metrics a run of ``cell`` reports: the end-to-end ones, or
        with ``trace`` the per-layer ones, that name the cell or name no
        cells."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = os.path.join(self.root, "portbench", "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Spans:
    """Named spans around the program's layers: CUDA events on a card,
    the host clock on the CPU; milliseconds once ``resolve`` is called
    after a synchronize.  ``on`` is False in an untraced run, where
    ``span`` records nothing."""

    def __init__(self, device, on: bool):
        self.cuda = device.type == "cuda"
        self.on = on
        self._open = []
        self.ms = defaultdict(list)

    def _mark(self):
        if self.cuda:
            import torch

            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        a = self._mark()
        yield
        self._open.append((name, a, self._mark()))

    def resolve(self) -> dict:
        for name, a, b in self._open:
            self.ms[name].append(a.elapsed_time(b) if self.cuda
                                 else (b - a) * 1e3)
        self._open.clear()
        return dict(self.ms)


def sync(device):
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _trace_events(prof) -> list:
    """The complete events of a finished profile, through its Chrome
    trace (a temporary file, removed)."""
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _device_ops(events) -> list:
    """(start, end, name) of the device's operations, in microseconds."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") in PROFILE_CATS]


def idle_gaps(events, top: int = 10) -> list:
    """The ``top`` longest gaps between the device's operations inside the
    span ``portbench:window``, each named by the innermost host operation
    running at its middle."""
    win = [e for e in events if e.get("name") == "portbench:window"
           and e.get("cat") == "user_annotation"]
    if not win:
        return []
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") in ("cpu_op", "user_annotation")
            and e is not win[0]]
    gaps, end = [], w0
    for a, b, _ in sorted(_device_ops(events)):
        if a > end and a < w1:
            gaps.append((end, a))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))

    def doing(a, b):
        mid = (a + b) / 2
        inside = [(hb - ha, name) for ha, hb, name in host if ha <= mid < hb]
        return min(inside)[1] if inside else "idle host"

    gaps = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:top]
    return [[doing(a, b)[:120], (b - a) * 1e-6] for a, b in gaps]


def profile(kind, state, device, n_steps: int, first: int) -> dict:
    """Two profiled windows after the measured one.  First ``n_steps``
    steps with the device's activity alone (the host runs at its own
    pace): the window's length on the host clock, the union of the
    device's operations, the device time of each operation by name.  Then
    one step with the host's activity too: the longest idle gaps of the
    device, named by what the host ran in them."""
    import torch
    from torch.profiler import ProfilerActivity

    if device.type != "cuda":
        return {}
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync(device)
        t = time.perf_counter()
        for i in range(n_steps):
            kind.step(state, first + i, None)
        sync(device)
        window_s = time.perf_counter() - t
    ops = _device_ops(_trace_events(prof))
    by_name = defaultdict(float)
    for a, b, name in ops:
        by_name[name] += (b - a) * 1e-6
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("portbench:window"):
            kind.step(state, first + n_steps, None)
            sync(device)
    return {"window_s": window_s,
            "busy_s": _union([(a, b) for a, b, _ in ops]) * 1e-6,
            "kernels": dict(by_name),
            "device_ops": sorted(([n[:120], s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": idle_gaps(_trace_events(prof))}


class Ranks:
    """The ranks of a run on several cards (one process each) over
    ``mesh``, or the one rank of a run on one (``mesh`` None): rank 0's
    decisions and the other ranks' readings, by collectives."""

    def __init__(self, mesh, device):
        self.mesh, self.device = mesh, device
        self.rank = 0 if mesh is None else mesh.get_local_rank()
        self.size = 1 if mesh is None else mesh.size()

    def _group(self):
        from akbx_torch.parallel import sharding as sh

        return sh._group(self.mesh)

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        if self.mesh is None:
            return flag
        import torch
        import torch.distributed as dist

        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.broadcast(t, dist.get_global_rank(self._group(), 0),
                       group=self._group())
        return bool(t.item())

    def all(self, value: float) -> list:
        """``value`` of every rank, in rank order, on every rank."""
        if self.mesh is None:
            return [value]
        import torch
        import torch.distributed as dist

        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=self.device)
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self._group())
        return [float(x) for x in out]


def run_cell(bench: Bench, cell, seed: int, seconds: float, trace: bool,
             device, t0: float, mesh=None) -> dict | None:
    """Set-up, window, profile, the import check of every rank, check:
    the run's result on rank 0, None on the other ranks of a ``mesh``.
    Raises ``LoadedJax`` on every rank where one rank loaded JAX."""
    ranks = Ranks(mesh, device)
    ctx = types.SimpleNamespace(device=device, seed=seed, config=cell.config,
                                traffic=cell.traffic, chips=cell.chips,
                                trace=trace, mesh=mesh)
    kind = cell.kind
    spans = Spans(device, trace)
    state = kind.setup(ctx, spans)
    if device.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(device)
    steps = []
    first = time.perf_counter()
    setup_s = first - t0
    while ranks.agree(time.perf_counter() - first < seconds):
        t = time.perf_counter()
        kind.step(state, len(steps), spans)
        sync(device)
        steps.append(time.perf_counter() - t)
    window_s = time.perf_counter() - first
    mem = 0
    if device.type == "cuda":
        import torch

        mem = torch.cuda.max_memory_allocated(device)
    mem = int(max(ranks.all(mem)))
    stats = kind.window(state, len(steps))
    rec = {"setup_s": setup_s, "window_s": window_s, "step_s": steps,
           "spans": spans.resolve(), **stats}
    if ranks.size > 1:
        stage = rec["spans"].get("stage")
        rec["rank_stage_ms"] = ranks.all(statistics.median(stage)
                                         if stage else 0.0)
    if trace:
        n_prof = int(cell.traffic["profile_steps"])
        prof = profile(kind, state, device, n_prof, len(steps))
        if prof:
            # the busiest card's busy share; busy and window seconds as
            # the mean over the cards
            prof["busy_share"] = max(ranks.all(prof["busy_s"]
                                               / prof["window_s"]))
            for key in ("busy_s", "window_s"):
                prof[key] = statistics.mean(ranks.all(prof[key]))
        rec["profile"] = prof
        rec["roofline"] = kind.roofline(state, n_prof)
    kind.free(state)
    # the import check of every rank, once the window has closed
    found = banned_modules()
    if found:
        say(f"portbench: rank {ranks.rank} loaded {found}")
    if max(ranks.all(len(found))) > 0:
        raise LoadedJax("a rank loaded JAX or the JAX package")
    if ranks.rank != 0:
        return None
    numbers = kind.check(state, seed)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = (stats["failed"] == 0 and set(numbers) == set(cell.limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    metrics = {}
    for m in bench.metrics(cell.name, trace):
        value = bench.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": stats["attempted"],
           "failed": stats["failed"], "metrics": metrics,
           "device": device_info(device, cell.chips, mem)}
    if trace:
        prof = rec["profile"]
        if prof.get("busy_s"):
            out["device"]["busy_s"] = prof["busy_s"]
            out["device"]["window_s"] = prof["window_s"]
            out["breakdown"] = {"device_ops": prof["device_ops"],
                                "idle_gaps": prof["idle_gaps"]}
    out["checks"] = checks
    say(f"window: {len(steps)} steps in {window_s:.3f} s; setup "
        f"{setup_s:.3f} s; launches {stats.get('launches')}")
    return out


def finite(x):
    """``x`` with every number that is not finite written as a string, so
    that the line stays JSON."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x


def device_info(device, chips: int, mem: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": mem}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": mem}


def start_ranks(script: str, args: list, chips: int, port: int) -> list:
    """Ranks 1 .. ``chips`` - 1 of a run on several cards: ``script`` with
    ``args`` in processes of their own, their standard error in files of
    ``TMPDIR``.  Returns [(process, log path)]."""
    out = []
    for rank in range(1, chips):
        fd, log = tempfile.mkstemp(prefix=f"portbench-rank{rank}-",
                                   suffix=".log")
        env = dict(os.environ, PORTBENCH_RANK=str(rank),
                   PORTBENCH_PORT=str(port), LOCAL_RANK=str(rank))
        proc = subprocess.Popen([sys.executable, script, *args], env=env,
                                stdout=subprocess.DEVNULL, stderr=fd)
        os.close(fd)
        out.append((proc, log))
    return out


def end_ranks(children, timeout: float) -> list:
    """Wait for every other rank, end any that outlives ``timeout``;
    returns the ranks that failed, with the end of their logs."""
    failed = []
    deadline = time.monotonic() + timeout
    for rank, (proc, log) in enumerate(children, start=1):
        try:
            rc = proc.wait(max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        if rc != 0:
            with open(log) as f:
                failed.append((rank, rc, f.read()[-2000:]))
        os.remove(log)
    return failed


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_mesh(backend: str, rank: int, world: int, port: int,
              device_type: str):
    """The process group of a run on several ranks, and its mesh."""
    import datetime

    import torch.distributed as dist
    from akbx_torch.parallel import sharding as sh

    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    return sh.ray_mesh(world, device_type)


def start_world(script: str, args: list, chips: int, device_type: str):
    """This process's place in a run on ``chips`` ranks, one process a
    card: rank 0 (the process without ``PORTBENCH_RANK``) starts the
    others, running ``script`` with ``args``.  Returns (rank, device,
    mesh, the other ranks' processes); on one rank (0, its device, None,
    [])."""
    import torch

    rank = int(os.environ.get("PORTBENCH_RANK", "0"))
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device(device_type))
    if device_type == "cuda":
        torch.cuda.set_device(device)
    if chips == 1:
        return rank, device, None, []
    # NCCL between the cards over NVLink, not through shared memory
    os.environ["NCCL_SHM_DISABLE"] = "1"
    children = []
    if rank == 0:
        port = free_port()
        os.environ["LOCAL_RANK"] = "0"
        children = start_ranks(script, args, chips, port)
    else:
        port = int(os.environ["PORTBENCH_PORT"])
    try:
        mesh = init_mesh("nccl" if device_type == "cuda" else "gloo", rank,
                         chips, port, device_type)
    except BaseException:
        end_ranks(children, 0.0)
        raise
    return rank, device, mesh, children


def stop_world(mesh, children) -> list:
    """Leave the process group and wait for the other ranks; returns the
    ones that failed (``end_ranks``)."""
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return end_ranks(children, 120.0)


def main(root: str, workload: str, seed: int, seconds: float, trace: bool,
         t0: float) -> int:
    bench = Bench(root)
    cell = bench.cell(workload)
    import torch

    if not torch.cuda.is_available():
        say("portbench: torch.cuda.is_available() is false; no result")
        return 2
    if torch.cuda.device_count() < cell.chips:
        say(f"portbench: {torch.cuda.device_count()} CUDA cards, the cell "
            f"asks for {cell.chips}; no result")
        return 2
    try:
        importlib.import_module("akbx_torch")
    except ImportError as e:
        say(f"portbench: the program akbx_torch is missing ({e}); no result")
        return 2
    missing = unresolved(cell.config)
    for line in missing:
        say(f"portbench: configuration {cell.config['name']}: {line}; "
            "no result")
    if missing:
        return 2
    rank, device, mesh, children = start_world(
        os.path.join(root, "portbench", "run.py"),
        ["--workload", workload, "--seed", str(seed), "--seconds",
         repr(seconds), "--trace", str(int(trace))], cell.chips, "cuda")

    def banner():
        say(f"card {torch.cuda.get_device_name(device)!r}, "
            f"{torch.cuda.device_count()} visible, the cell uses "
            f"{cell.chips}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}")
        say("nvidia-smi name, clocks.sm, power.limit: " + smi())
        say(f"cell {workload}, seed {seed}, seconds {seconds}, trace "
            f"{int(trace)}")

    return run_world(bench, cell, seed, seconds, trace, device, t0, mesh,
                     children, banner)


def run_world(bench: Bench, cell, seed: int, seconds: float, trace: bool,
              device, t0: float, mesh=None, children=(),
              banner=None) -> int:
    """``run_cell`` on this rank (after ``banner()`` on rank 0), then the
    end of the run: leave the process group and wait for ``children``,
    check this process's imports again, and on rank 0 print the result.
    Returns the exit code."""
    rank = 0 if mesh is None else mesh.get_local_rank()
    try:
        if rank == 0 and banner is not None:
            banner()
        out = run_cell(bench, cell, seed, seconds, trace, device, t0, mesh)
    except LoadedJax as e:
        say(f"portbench: {e}; no result")
        return 3
    finally:
        failed = stop_world(mesh, children)
    found = banned_modules()
    if found:
        say(f"portbench: rank {rank} loaded {found} (JAX or the JAX "
            "package); no result")
        return 3
    if rank != 0:
        return 0
    for r, rc, log in failed:
        say(f"portbench: rank {r} exited with {rc}; its log ends:\n{log}")
    if failed:
        return 4
    for name, c in out["checks"].items():
        say(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(finite(out), allow_nan=False), flush=True)
    return 0
