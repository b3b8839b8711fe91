"""Run one function on ``world`` ranks of a ``torch.distributed`` process
group: one SPMD process per block, the counterpart of a ``shard_map`` body.

:func:`run_ranks` spawns the processes (``spawn``: CUDA cannot be forked),
joins them into a process group through a ``file://`` store in a temporary
directory (no TCP port to collide with another run on the same host), calls
``fn(rank, device, *args)`` on each and returns every rank's result in rank
order.  The backend is the caller's: ``"nccl"`` puts rank r on ``cuda:r``
and refuses a world larger than the visible cards (NCCL takes no two ranks
on one device); ``"gloo"`` takes CPU tensors, or CUDA tensors with rank r on
``cuda:(r mod cards)`` (so every rank shares one card where there is one).
Nothing chooses another backend or device on its own: the device is the
card unless the caller asks for the CPU.

A rank that raises makes :func:`run_ranks` raise with that rank's
traceback; a world that outlives ``timeout_s`` is terminated and raises
:class:`TimeoutError`.  The process group gets the same timeout, so a
collective that waits on a dead rank fails inside the rank too.  CPU ranks
run one thread each.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


def _to_host(obj):
    """``obj`` with every tensor moved to the CPU (results cross the process
    boundary as plain pickled bytes, copies that outlive the rank: a CUDA
    tensor would go by CUDA IPC, a CPU one by a shared-memory handle)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_device(rank: int, backend: str, device: str) -> torch.device:
    if device == "cpu":
        return torch.device("cpu")
    index = rank if backend == "nccl" else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def _rank_main(fn, rank, world, backend, device, store_path, timeout_s, args, results):
    try:
        dev = _rank_device(rank, backend, device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{store_path}", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s),
        )
        try:
            out = fn(rank, dev, *args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            results.put((rank, True, pickle.dumps(_to_host(out))))
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def _check(world: int, backend: str, device: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}; got {backend!r}")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda'; got {device!r}")
    if world < 1:
        raise ValueError(f"world must be >= 1; got {world}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("the nccl backend takes CUDA tensors only; use gloo on the CPU")
        if world > torch.cuda.device_count():
            raise ValueError(
                f"nccl puts one rank on each card: {world} ranks need {world} cards, "
                f"{torch.cuda.device_count()} are visible"
            )


def _failures(results, rank, trace, grace_s: float = 5.0) -> str:
    """The report of a failed world: the first failure and every other one
    that arrives within ``grace_s`` (a rank that raises breaks its peers'
    collectives, so the first to arrive need not be the cause)."""
    failed = {rank: trace}
    end = time.monotonic() + grace_s
    while time.monotonic() < end:
        try:
            r, ok, value = results.get(timeout=max(end - time.monotonic(), 0.01))
        except queue.Empty:
            break
        if not ok:
            failed[r] = value
    return f"run_ranks: ranks {sorted(failed)} raised:\n" + "\n".join(
        f"--- rank {r} ---\n{failed[r]}" for r in sorted(failed))


def run_ranks(fn, world: int, *, backend: str, device: str = "cuda", args=(),
              timeout_s: float = 600.0):
    """``[fn(rank, device, *args) for rank in range(world)]``, each call in
    its own process of one process group; tensors in the results come back
    on the CPU.  ``fn`` and ``args`` must pickle (a module-level function).

    On CUDA the kernels are built here, once, before the ranks start: four
    ranks building ``build/kernels/`` on first use would race.
    """
    _check(world, backend, device)
    if device == "cuda":
        from na_dd_tpu_torch.ops import kernels

        kernels.build_kernels()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="run_ranks_")
    store = os.path.join(tmp, "store")
    procs = [
        ctx.Process(target=_rank_main, daemon=True,
                    args=(fn, r, world, backend, device, store, timeout_s, tuple(args), results))
        for r in range(world)
    ]
    try:
        for p in procs:
            p.start()
        out = {}
        deadline = time.monotonic() + timeout_s
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: {world - len(out)} of {world} ranks still running after "
                    f"{timeout_s} s (ranks done: {sorted(out)})"
                )
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"run_ranks: rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                        "and no result"
                    ) from None
                continue
            if not ok:
                raise RuntimeError(_failures(results, rank, value))
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
