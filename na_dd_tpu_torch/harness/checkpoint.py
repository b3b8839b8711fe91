"""Checkpoint and resume of long simulations (counterpart of
:mod:`na_dd_tpu.harness.checkpoint`, its ``.npz`` backend).

The format is the JAX package's: one ``.npz`` with an array per State field
and a ``.meta.json`` sidecar ``{"t", "step", "fields"[, "extra"]}``, so a
checkpoint written by either package loads into the other.

The twin of the JAX package's orbax pair (``save_state_orbax`` /
``load_state_orbax``, states sharded over a mesh) is
:func:`save_state_sharded` / :func:`load_state_sharded`: a directory with
one ``.npz`` of its block for each rank that wrote it and a ``manifest.json``
holding ``t``, ``step``, each field's global shape and dtype, and each
file's offset in the global array.  Any layout reads it back, each rank
assembling its block from the files that overlap it, so a state saved by 4
ranks restores bit for bit on 2 or on 1.  (orbax imports JAX, which the
port may not.)
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


_MANIFEST = "manifest.json"


def _block_range(ops, shape):
    """(start, stop) of this rank's block along dimensions 0 and 1 of a
    global array of ``shape`` (the whole array for ``ops=None``)."""
    if ops is None:
        return (0, shape[0]), (0, shape[1])
    rows, cols = shape[0] // ops.nx, shape[1] // ops.ny
    return (ops.ix * rows, (ops.ix + 1) * rows), (ops.iy * cols, (ops.iy + 1) * cols)


def save_state_sharded(path: str, state: State, *, t: float, step: int, ops) -> str:
    """Save this rank's block of a sharded State (``ops`` the halo-exchange
    provider it lives on; every rank of the mesh calls this) into the
    directory ``path``; returns it once every rank has written."""
    import torch.distributed as dist

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    rank = ops.mesh.rank
    name = f"shard_{rank:05d}.npz"
    tmp = os.path.join(path, f".{name}.tmp.npz")
    np.savez(tmp, **{k: v.detach().cpu().numpy() for k, v in state._asdict().items()})
    os.replace(tmp, os.path.join(path, name))
    shapes = [list(v.shape) for v in state]
    # every rank's block has this rank's shape (the blocks divide evenly)
    full = {k: [s[0] * ops.nx, s[1] * ops.ny, *s[2:]] for k, s in zip(state._fields, shapes)}
    if rank == 0:
        files = []
        for r in range(ops.mesh.num_ranks):
            ix, iy = ops.block_coords(r)
            files.append({"file": f"shard_{r:05d}.npz",
                          "offset": [ix * shapes[0][0], iy * shapes[0][1]]})
        manifest = {"t": float(t), "step": int(step), "fields": list(state._fields),
                    "shapes": full, "dtypes": {k: str(v.dtype).replace("torch.", "")
                                               for k, v in zip(state._fields, state)},
                    "files": files}
        with open(os.path.join(path, _MANIFEST + ".tmp"), "w") as f:
            json.dump(manifest, f)
        os.replace(os.path.join(path, _MANIFEST + ".tmp"), os.path.join(path, _MANIFEST))
    dist.barrier()
    return path


def load_state_sharded(path: str, *, ops=None, device=None):
    """Read a checkpoint of :func:`save_state_sharded` back as ``(state, t,
    step)``: this rank's block under ``ops`` (a halo-exchange provider of
    any layout, which needs no process group), or the whole State for
    ``ops=None``.  The arrays keep their dtype, bit for bit, and go to
    ``device`` (None: the card)."""
    path = os.path.abspath(path)
    device = resolve_device(device)
    with open(os.path.join(path, _MANIFEST)) as f:
        meta = json.load(f)
    shape0 = meta["shapes"][meta["fields"][0]]
    (r0, r1), (c0, c1) = _block_range(ops, shape0)
    out = {k: None for k in meta["fields"]}
    for entry in meta["files"]:
        with np.load(os.path.join(path, entry["file"])) as data:
            for k in meta["fields"]:
                a = data[k]
                if out[k] is None:
                    out[k] = np.empty((r1 - r0, c1 - c0, *a.shape[2:]), dtype=a.dtype)
                o0, o1 = entry["offset"]
                lo0, hi0 = max(r0, o0), min(r1, o0 + a.shape[0])
                lo1, hi1 = max(c0, o1), min(c1, o1 + a.shape[1])
                if lo0 < hi0 and lo1 < hi1:
                    out[k][lo0 - r0:hi0 - r0, lo1 - c0:hi1 - c0] = a[lo0 - o0:hi0 - o0,
                                                                     lo1 - o1:hi1 - o1]
    state = State(**{k: torch.as_tensor(v, device=device) for k, v in out.items()})
    return state, meta["t"], meta["step"]
