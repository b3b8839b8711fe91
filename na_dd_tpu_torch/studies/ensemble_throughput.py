"""Ensemble (parameter-screening) throughput on the card, the serving story
(counterpart of ``studies/ensemble_throughput.py``).

    python -m na_dd_tpu_torch.studies.ensemble_throughput                  # f64, B=1,8,32,128
    python -m na_dd_tpu_torch.studies.ensemble_throughput --dtype float32
    python -m na_dd_tpu_torch.studies.ensemble_throughput --dp 2           # 2 gloo ranks
    python -m na_dd_tpu_torch.studies.ensemble_throughput --device cpu --batches 1,4 --n 16

B independent simulations, a regularization-factor screen η =
linspace(20, 200, B) of the study's RegHCs integration (pol, N=64, Tf=0.01,
dt=5e-4 by default), run as one stack (``harness/ensemble.py``: each Newton
solve one launch of the batched K1 for up to ``kernels.MAX_BATCH`` members).
For each B: the first run, the min of 5 steady runs, simulations a second,
the time a simulation and the efficiency against B=1.  Besides the JAX
study's keys the JSON holds each member's H-norm² of each of its five final
fields (``final_norms``, in ``State`` order) and the ``device``, so that a run
can be held to the JAX package's CPU-x64 record.

``--dp`` splits each batch over that many ranks (``run_ranks``, ``--backend``
gloo by default: every rank on the one card, as ``chip_smoke.py --only
parallel`` runs it; nccl puts rank r on card r); a batch that does not divide
runs whole on every rank, as the JAX study leaves it unsharded.

Runs on the CUDA card unless ``--device cpu`` (``--cpu``); with no card and no
device it raises.  ``--dtype float32`` is the JAX study's ``NA_DD_TPU_X64=0``
and tags the file ``_f32``.  The result is archived as
``ensemble_throughput[_f32].json`` under ``studies/results_torch/`` (or
``--results-dir``, or ``--out``), never under ``studies/results/``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from na_dd_tpu_torch import config
from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.harness.ensemble import build_ensemble
from na_dd_tpu_torch.ops.halo import gather_ranks
from na_dd_tpu_torch.ops.inner_products import inner_H
from na_dd_tpu_torch.ops.shifts import BATCHED_OPS
from na_dd_tpu_torch.studies import RESULTS_DIR, checked_output, device_label

DTYPES = {"float64": torch.float64, "float32": torch.float32}
STEADY_RUNS = 5


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--study", default="pol")
    ap.add_argument("--n", type=int, default=64, help="grid N (NxN)")
    ap.add_argument("--tf", type=float, default=0.01)
    ap.add_argument("--dt", type=float, default=5e-4)
    ap.add_argument("--batches", default="1,8,32,128", help="comma-separated ensemble sizes")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (= --device cpu)")
    ap.add_argument("--dp", type=int, default=0,
                    help="split the ensemble batch over this many ranks (data-parallel "
                         "serving; 0 = one process)")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default="gloo",
                    help="the ranks' process-group backend with --dp")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float64",
                    help="float32 is the JAX study's NA_DD_TPU_X64=0")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card by default, 'cpu' only when asked")
    ap.add_argument("--results-dir", default=str(RESULTS_DIR),
                    help="where the JSON goes (default: studies/results_torch/)")
    ap.add_argument("--out", default=None, help="the JSON's path (overrides --results-dir)")
    return ap


def final_norms(grid, state) -> list:
    """Each member's H-norm² of each of its five final fields, (B, 5)."""
    norms = torch.stack([inner_H(BATCHED_OPS, grid, v, v).reshape(-1) for v in state], dim=1)
    return norms.to(torch.float64).cpu().tolist()


def timed_batches(batches, build_kw, device, dtype, mesh=None) -> dict:
    """``{B: (first_s, steady_s, final_norms, num_steps, Krylov budget,
    adjusted dt)}``, each run
    closed by a sync of the device.  With ``mesh`` (1-D, over the process
    group) each rank runs its B/dp members, the final states are gathered
    into every rank, and a batch that does not divide runs whole on every
    rank."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {}
    for B in batches:
        # an eta screen around the study's production value (50): distinct
        # parameters a member, one build
        etas = np.linspace(20.0, 200.0, B).tolist()
        split = mesh is not None and B % mesh.num_ranks == 0
        if split:
            per = B // mesh.num_ranks
            etas = etas[mesh.rank * per:(mesh.rank + 1) * per]
        build = build_ensemble(etas, dtype=dtype, device=device, **build_kw)

        def run():
            if mesh is not None:
                dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            s, _iters = build["run"]()
            if split:
                s = State(*(torch.cat(gather_ranks(v, group=mesh.group)) for v in s))
            sync()
            return s, time.perf_counter() - t0

        s, first = run()
        if not all(bool(v.isfinite().all()) for v in s):
            raise FloatingPointError(f"B={B}: non-finite state")
        steady = min(run()[1] for _ in range(STEADY_RUNS))
        out[B] = (first, steady, final_norms(build["grid"], s), build["num_steps"],
                  build["budget"], build["dt"])
    return out


def _dp_rank(rank, device, dp, batches, build_kw, dtype_name):
    """One rank of ``--dp``: the timed batches over a (dp,) mesh."""
    from na_dd_tpu_torch.parallel import make_mesh

    out = timed_batches(batches, build_kw, torch.device(device), DTYPES[dtype_name],
                        mesh=make_mesh((dp,), ("b",)))
    return out if rank == 0 else None


def main(argv=None) -> int:
    """Parse ``argv`` (the command line when None), time every batch size,
    archive the result and return 0."""
    args = parser().parse_args(argv)
    device = config.resolve_device("cpu" if args.cpu else args.device)
    dtype = DTYPES[args.dtype]
    tag = "" if dtype == torch.float64 else "_f32"
    out_path = checked_output(args.out or checked_output(args.results_dir)
                              / f"ensemble_throughput{tag}.json")
    label = device_label(device)
    print("device:", label, flush=True)
    batches = [int(b) for b in args.batches.split(",")]
    build_kw = dict(study=args.study, N=args.n, Tf=args.tf, dt=args.dt)
    if args.dp:
        from na_dd_tpu_torch.parallel import run_ranks

        print(f"data-parallel over {args.dp} {args.backend} ranks", flush=True)
        timed = run_ranks(_dp_rank, args.dp, backend=args.backend, device=device.type,
                          args=(args.dp, batches, build_kw, args.dtype))[0]
    else:
        timed = timed_batches(batches, build_kw, device, dtype)

    results = {}
    base_per_sim = None
    for B, (first, steady, norms, num_steps, budget, dt) in timed.items():
        per_sim = steady / B
        if base_per_sim is None:
            base_per_sim = per_sim
        results[B] = dict(batch_s=steady, first_s=first, sims_per_s=B / steady,
                          per_sim_s=per_sim, efficiency_vs_B1=base_per_sim / per_sim,
                          final_norms=norms)
        print(f"[ensemble {args.study} N={args.n} steps={num_steps}] B={B:4d} "
              f"steady={steady:.4f}s  {B / steady:8.1f} sims/s  per-sim {per_sim * 1e3:7.2f} ms  "
              f"eff x{base_per_sim / per_sim:.1f} vs B=1", flush=True)

    payload = dict(
        study=args.study, N=args.n, Tf=args.tf, dt=dt, num_steps=num_steps,
        x64=dtype == torch.float64, backend=device.type, dp=args.dp, krylov_unroll=budget,
        batches={str(b): r for b, r in results.items()},
        timestamp=time.strftime("%Y-%m-%d %H:%M:%S"), device=label,
    )
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(payload, indent=1))
    print("archived:", out_path, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
