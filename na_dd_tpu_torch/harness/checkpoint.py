"""Checkpoint and resume of long simulations (counterpart of
:mod:`na_dd_tpu.harness.checkpoint`, its ``.npz`` backend).

The format is the JAX package's: one ``.npz`` with an array per State field
and a ``.meta.json`` sidecar ``{"t", "step", "fields"[, "extra"]}``, so a
checkpoint written by either package loads into the other.  The orbax pair
(``save_state_orbax``/``load_state_orbax``, sharded states) is not ported.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from na_dd_tpu_torch.config import resolve_device
from na_dd_tpu_torch.core.state import State

_META_SUFFIX = ".meta.json"


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: State, *, t: float, step: int, extra: Optional[dict] = None) -> str:
    """Save a State and ``(t, step)`` to ``path`` (``.npz`` appended if
    missing); returns the path written."""
    path = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in state._asdict().items()})
    meta = {"t": float(t), "step": int(step), "fields": list(state._fields)}
    if extra:
        meta["extra"] = extra
    with open(path + _META_SUFFIX, "w") as f:
        json.dump(meta, f)
    return path


def load_state(path: str, *, device=None):
    """Load ``(state, t, step, meta)`` saved by :func:`save_state` (of either
    package).  The arrays keep their dtype and go to ``device`` (None: the
    card)."""
    path = _npz_path(path)
    device = resolve_device(device)
    with open(path + _META_SUFFIX) as f:
        meta = json.load(f)
    with np.load(path) as data:
        state = State(**{k: torch.as_tensor(data[k], device=device) for k in meta["fields"]})
    return state, meta["t"], meta["step"], meta


def latest_checkpoint(directory: str) -> Optional[str]:
    """Path of the highest-step checkpoint in ``directory`` (None if there
    is none)."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        meta_path = os.path.join(directory, name + _META_SUFFIX)
        if not name.endswith(".npz") or not os.path.exists(meta_path):
            continue
        with open(meta_path) as f:
            step = json.load(f).get("step", -1)
        if step > best_step:
            best, best_step = os.path.join(directory, name), step
    return best


def run_checkpointed(
    step_fn: Callable[[State, object, float], State],
    state0: State,
    *,
    t0: float,
    dt: float,
    num_steps: int,
    directory: str,
    every: int = 100,
    resume: bool = True,
):
    """Drive ``num_steps`` steps of ``step_fn(state, t, dt) -> state`` with a
    checkpoint (``ckpt_<step>.npz``) at the end of every segment of ``every``
    steps, resuming from the latest checkpoint in ``directory`` when
    ``resume`` is set.  Returns ``(final_state, final_t)``.

    Each segment runs eagerly on the device; the host sees the state only at
    its end, when it is saved.  Step k runs at ``t0 + k·dt`` with k a float
    tensor on the state's device (the times :func:`simulate` gives), so a
    checkpointed run equals the straight run bit for bit.  Any integrator's
    ``step_fn`` closed over its grid and ops qualifies.
    """
    dtype, device = state0.T.dtype, state0.T.device
    state, start = state0, 0
    if resume:
        ckpt = latest_checkpoint(directory)
        if ckpt is not None:
            state, _t, start, _meta = load_state(ckpt, device=device)
    while start < num_steps:
        n = min(every, num_steps - start)
        ks = torch.arange(start, start + n, dtype=dtype, device=device)
        for k in range(n):
            state = step_fn(state, t0 + ks[k] * dt, dt)
        start += n
        save_state(os.path.join(directory, f"ckpt_{start:08d}"), state, t=t0 + start * dt,
                   step=start)
    return state, t0 + start * dt
