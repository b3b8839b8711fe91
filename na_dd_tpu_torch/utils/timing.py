"""Structured timing: first call vs steady calls (counterpart of
:mod:`na_dd_tpu.utils.timing`).

The reference only prints wall-clock totals (src/cvg_studies_base.py:138-217).
Each time here is the host clock around the work, closed by a sync of the
card where the work ran there (the JAX module's ``block_until_ready``), so
it counts the device's work and not only its launch.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Dict

import torch


@dataclass
class Timed:
    name: str
    seconds: float


def _sync(x) -> None:
    """Wait for the card if ``x`` (a tensor, or a tuple, list or dict of
    them) has a CUDA tensor in it."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _sync(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _sync(v)


@contextlib.contextmanager
def timed_block(record: Dict[str, float], name: str, *, sync=None):
    """Context manager adding the elapsed wall-clock to ``record[name]``.

    Pass ``sync=x`` (a tensor, or a tuple, list or dict of them) to wait for
    the card before the clock stops; a CPU tensor needs no wait.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            _sync(sync)
        record[name] = record.get(name, 0.0) + (time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU and, where a card
    is present, CUDA activities) and write it into ``log_dir`` as a Chrome
    trace (view it in chrome://tracing or Perfetto):

        with device_trace('traces'):
            trial.run_for_errors(...)
    """
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json"))


#: The JAX package's name of :func:`device_trace`.
xla_trace = device_trace


def time_compile_and_run(fn, *args, reps: int = 3):
    """Return (first_call_s, best_steady_call_s, result): the host clock
    around the first call and the best of ``reps`` further calls, each
    closed by a sync of the card where the result lies on it."""
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(out)
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        best = min(best, time.perf_counter() - t0)
    return first, best, out
