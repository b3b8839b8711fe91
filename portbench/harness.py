"""One run of one cell: set-up, the measured window, the traced segment,
the comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, program entry
or per-layer metric sits in a file of its own under ``portbench/``, found
by the names in ``BENCHMARK.json``:

- ``configs/<config>.json``: the deployment (case, grid, protocol, model
  constants, guarantee) and the limits of its comparison;
- ``traffic/<traffic>.json``: members a unit and the law of their η;
- ``drivers/<entry>.py``: ``build`` (the program's work a unit) and
  ``reference`` (the plain reference of the same inputs);
- ``metrics/<name>.py``: ``read(ctx)`` of a per-layer metric.

The window is a closed loop of whole units (a level, a screen) until
``seconds`` have passed on the host clock; a unit in flight when the
window closes is abandoned at its next step.  A CUDA event is recorded
after each ``step_fn`` call returns; the intervals between consecutive
events are the steps' times, so what the host does between steps (the
error collection, a level's host transfer) falls into the next step's
interval.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "na_dd_tpu")
#: steps of a unit run before the window, at its shapes
WARM_STEPS = 2
#: steps in each traced segment
TRACE_STEPS = 16


class WindowClosed(Exception):
    """Raised at a step once the window (or a warm-up's step count) is
    over: the unit in flight is abandoned."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = ROOT):
    """(benchmark, cell, configuration, traffic) of ``workload``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = load_json(root / cfg_entry["file"])
    traffic = load_json(root / "portbench" / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, cfg, traffic


def load_module(root: Path, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` under ``root``, by its file: a driver
    or a metric reader that a later change adds is found by its name."""
    path = root / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def draw_etas(traffic: dict, seed: int):
    """The members' η from the seed: the traffic's law over [low, high]
    ("loguniform", or "grid_permuted": evenly spaced values in a seed-drawn
    order)."""
    rng = np.random.default_rng(int(seed))
    law = traffic["eta"]
    if law["law"] == "loguniform":
        u = rng.random(int(traffic["members"]))
        vals = np.exp(math.log(law["low"]) + (math.log(law["high"]) - math.log(law["low"])) * u)
    elif law["law"] == "grid_permuted":
        # the same evenly spaced set for every seed, in the seed's order:
        # the work of a unit does not change with the seed
        vals = rng.permutation(np.linspace(law["low"], law["high"], int(traffic["members"])))
    else:
        raise ValueError(f"unknown law {law['law']!r}")
    return [float(v) for v in vals]


def forbidden_loaded():
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def metrics_of(entries, workload: str):
    """The metrics of ``entries`` that this cell reports: those without a
    ``workloads`` list, and those whose list names it."""
    return [m for m in entries if workload in m.get("workloads", [workload])]


class StepClock:
    """Wraps each integrator instance's ``step_fn``: raises
    :class:`WindowClosed` before a step once the deadline or the step limit
    is reached, records a CUDA event after each step returns, and drives the
    traced segment."""

    def __init__(self, torch, integrators, span, on_card: bool):
        self.torch = torch
        self.cuda = on_card
        self.span = span
        self.deadline = math.inf
        self.limit = math.inf
        self.count = 0
        self.events = []
        self.hooks = {}
        for integ in integrators:
            integ.step_fn = self._wrap(integ.step_fn)

    def _wrap(self, fn):
        def step_fn(*args, **kwargs):
            if self.count >= self.limit or time.perf_counter() >= self.deadline:
                raise WindowClosed
            if self.count in self.hooks:
                self.hooks[self.count]("before")
            with self.span("step"):
                out = fn(*args, **kwargs)
            if self.cuda:
                ev = self.torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
            self.count += 1
            if self.count - 1 in self.hooks:
                self.hooks[self.count - 1]("after")
            return out

        return step_fn

    def reset(self):
        self.count = 0
        self.events = []


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t_process: float,
             device: str = "cuda", root: Path = ROOT, overrides: dict | None = None,
             traffic_overrides: dict | None = None, fault=None, units: int | None = None) -> dict:
    """One run; returns the result line's object.  ``device="cpu"`` and
    ``overrides`` / ``traffic_overrides`` (keys of the configuration or the
    traffic, such as a smaller N) are for the tests, which also plant a
    ``fault(work, cfg, etas, driver)`` in the timed path and may give the
    window a count of whole ``units`` in place of its ``seconds``."""
    marks = {}
    t_mark = time.perf_counter()

    def mark(name):
        nonlocal t_mark
        now = time.perf_counter()
        marks[name] = now - t_mark
        t_mark = now

    bench, cell, cfg, traffic = load_cell(workload, root)
    cfg = {**cfg, **(overrides or {})}
    traffic = {**traffic, **(traffic_overrides or {})}
    import torch

    import na_dd_tpu_torch  # noqa: F401  the program under test
    from na_dd_tpu_torch.ops import kernels

    mark("imports")
    on_card = device == "cuda"
    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(f"{workload} needs {cell['chips']} CUDA device(s); "
                             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    mark("cuda_context")
    if on_card:
        kernels.build_kernels()
        built = [k for k, v in kernels.BUILD_INFO.items() if not v.get("cached")]
        log(f"[setup] kernels: {'nvcc built ' + ', '.join(built) if built else 'loaded from build/kernels'}")
    mark("kernel_load")

    etas = draw_etas(traffic, seed)
    driver = load_module(root, "drivers", cfg["entry"])
    tracer = _Tracer(torch, trace and on_card)
    work = driver.build(cfg, etas, torch.device(device), tracer.span)
    if fault is not None:
        fault(work, cfg, etas, driver)
    clock = StepClock(torch, work["integrators"], tracer.span, on_card)
    mark("build_and_lambdify")

    # warm-up: the first steps of a unit at the window's shapes
    clock.limit = WARM_STEPS
    try:
        work["unit"]()
    except WindowClosed:
        pass
    if on_card:
        torch.cuda.synchronize()
    clock.limit = math.inf
    clock.reset()
    mark("warm_steps")
    for name, sec in marks.items():
        log(f"[setup] {name}: {sec:.3f} s")
    if trace:
        tracer.arm(clock, work["steps_per_unit"])
        if on_card:
            tracer.wrap_solves(kernels)

    # the measured window
    answers = []
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    clock.deadline = t0 + seconds if units is None else math.inf
    while units is None or len(answers) < units:
        try:
            with tracer.span("unit"):
                answers.append(work["unit"]())
        except WindowClosed:
            break
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    tracer.close()
    steps = clock.count
    log(f"[window] {window_s:.3f} s, {steps} steps, {len(answers)} whole units, "
        f"{work['members']} member(s) a step")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        intervals_ms = [start.elapsed_time(clock.events[0])] + [
            a.elapsed_time(b) for a, b in zip(clock.events, clock.events[1:])]
        log(f"[window] step ms: median {statistics.median(intervals_ms):.3f}, mean "
            f"{statistics.fmean(intervals_ms):.3f}, min {min(intervals_ms):.3f}, max {max(intervals_ms):.3f}")
    else:
        intervals_ms = []

    # the reference, once the program's state is freed
    members = work["members"]
    del work, clock
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = driver.reference(cfg, etas, torch.device(device), torch.float64)
    from portbench.compare import judge

    limits = cfg["limits"]
    correct, failed, checks = judge(answers, ref, limits)
    log(f"[reference] {time.perf_counter() - t_ref:.3f} s for {len(answers)} answer(s)")

    from portbench.stats import window_metrics

    metrics = {}
    if not trace:
        units = {m["name"]: m["unit"] for m in metrics_of(bench["end_to_end"], workload)}
        values = window_metrics(intervals_ms, members, window_s) if intervals_ms else {}
        values["setup_s"] = setup_s
        for name, unit in units.items():
            if name in values:
                metrics[name] = {"value": values[name], "unit": unit}
    else:
        ctx = tracer.context(cfg, members)
        for m in metrics_of(bench["per_layer"], workload):
            reader = load_module(root, "metrics", m["name"])
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    bad = forbidden_loaded()
    if bad:
        raise SystemExit(f"forbidden modules loaded in the run's process: {', '.join(bad)}")
    result = {
        "correct": correct,
        "attempted": len(answers),
        "failed": failed,
        "metrics": metrics,
        "device": _device_record(torch, on_card, memory_peak, tracer),
    }
    if tracer.breakdown:
        result["breakdown"] = tracer.breakdown
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    for name, (v, lim) in checks.items():
        log(f"[check] {name} {v!r} limit {lim!r}")
    return result


def _device_record(torch, on_card, memory_peak, tracer):
    if not on_card:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": int(memory_peak)}
    if tracer.window_s:
        rec["busy_s"] = tracer.busy_s
        rec["window_s"] = tracer.window_s
    return rec


class _Tracer:
    """Spans, the traced segments and the solve wrappers of a ``--trace 1``
    run; inert otherwise.

    Two segments of :data:`TRACE_STEPS` steps each.  The first records the
    device alone (CUDA activity: a few microseconds a launch), around the
    end of the window's first unit; it gives the device operations, the
    busy time and the launches.  The second records the host's operators
    and the benchmark's spans as well, which slows the host two- to
    threefold, around the end of the second unit; it only names the idle
    gaps by what the host was doing."""

    def __init__(self, torch, enabled: bool):
        self.torch = torch
        self.enabled = enabled
        self.prof = None
        self.role = None
        self.t_a = None
        self.first = 0
        self.window_s = 0.0
        self.busy_s = 0.0
        self.device = []
        self.wrapper_us = []
        self.solve_iters = {}
        self.segment_steps = 0
        self.breakdown = None
        self.kernels_mod = None
        self.launches0 = {}
        self.saved = {}

    def span(self, name):
        if not self.enabled:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function("portbench." + name)

    def arm(self, clock, steps_per_unit):
        if not self.enabled:
            return
        k = TRACE_STEPS
        hooks = {}
        for role, boundary in (("device", steps_per_unit), ("host", 2 * steps_per_unit)):
            first = max(0, boundary - k // 2)
            hooks[first] = self._begin(clock, role)
            hooks[first + k - 1] = self._end(clock)
        clock.hooks = hooks

    def _begin(self, clock, role):
        torch = self.torch
        acts = [torch.profiler.ProfilerActivity.CUDA]
        if role == "host":
            acts.insert(0, torch.profiler.ProfilerActivity.CPU)

        def begin(when):
            if when != "before" or self.prof is not None:
                return
            torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.role = role
            self.launches0 = dict(self.kernels_mod.LAUNCHES) if self.kernels_mod else {}
            self.t_a = time.perf_counter()
            self.first = clock.count

        return begin

    def _end(self, clock):
        def end(when):
            if when == "after":
                self._stop(clock.count - self.first)

        return end

    def _stop(self, steps):
        if self.prof is None:
            return
        self.torch.cuda.synchronize()
        seconds = time.perf_counter() - self.t_a
        self.prof.__exit__(None, None, None)
        from portbench import kineto

        device, spans = kineto.read_events(self.prof)
        self.prof = None
        if self.role == "device":
            self.device, self.window_s, self.segment_steps = device, seconds, steps
            if self.kernels_mod is not None:
                # the program's own launch counter against the trace
                counted = sum(v - self.launches0.get(k, 0)
                              for k, v in self.kernels_mod.LAUNCHES.items())
                traced = sum(1 for n, _a, _b in device if any(k in n for k in kineto.PORT_KERNELS))
                log(f"[trace] K1-K7 launches in the device segment: {counted} counted by "
                    f"kernels.LAUNCHES, {traced} in the trace")
            self.busy_s = sum(b - a for a, b in kineto.busy_intervals(device)) / 1e9
            self.breakdown = {"device_ops": [[n, v] for n, v in kineto.top_ops(device)],
                              "idle_gaps": []}
        elif self.breakdown is not None:
            gaps = kineto.idle_gaps(kineto.busy_intervals(device), spans)
            self.breakdown["idle_gaps"] = [[n, v] for n, v in gaps]
        self.role = None

    def close(self):
        self._stop(0)
        if self.kernels_mod is not None:
            for name, fn in self.saved.items():
                setattr(self.kernels_mod, name, fn)

    def wrap_solves(self, kernels):
        """Host clock around each call of the K1/K5 wrappers outside the
        traced segments; the iterations of each call in the device
        segment."""
        self.kernels_mod = kernels
        for name in ("bicgstab_solve", "bicgstab_solve3"):
            fn = getattr(kernels, name)
            self.saved[name] = fn
            setattr(kernels, name, self._timed(name, fn))

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            with self.span("solve_wrapper"):
                t = time.perf_counter()
                x, info = fn(*args, **kwargs)
                if self.prof is None:
                    self.wrapper_us.append((time.perf_counter() - t) * 1e6)
            if self.role == "device":
                self.solve_iters.setdefault(name, []).append(info["iters"])
            return x, info

        return call

    def context(self, cfg, members):
        iters = {k: [float(v.float().mean()) for v in vs] for k, vs in self.solve_iters.items()}
        return {
            "config": cfg,
            "members": members,
            "device_ops": self.device,
            "busy_s": self.busy_s,
            "window_s": self.window_s,
            "steps": self.segment_steps,
            "wrapper_us": self.wrapper_us,
            "solve_iters": iters,
        }
