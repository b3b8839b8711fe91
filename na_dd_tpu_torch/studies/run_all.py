"""The six reference convergence-study notebooks reproduced on the card
(counterpart of ``studies/run_all_tpu.py``).

    python -m na_dd_tpu_torch.studies.run_all                  # fast mode, all 18 runs
    python -m na_dd_tpu_torch.studies.run_all --f64 --only pol # full f64, one study
    python -m na_dd_tpu_torch.studies.run_all --only pol eta --cpu

Runs every study (spatial, temporal and η sweep: 18 runs) one after another
and writes each run's JSON, ``<study>_<kind>.json``, as soon as it finishes,
then renders ``REPRODUCTION.md`` from every archived JSON; both go to
``studies/results_torch/`` (or ``--results-dir``), never to
``studies/results/`` or the root ``REPRODUCTION.md``.  ``--only <study>
[<kind>]`` re-runs a subset, merging into the same archive.

Two modes, as in the JAX script.  The default is fast: ``precision="mixed"``
(float32 Krylov under float64 refinement), each spatial ladder as one batch
of levels, and the finest level of each ladder re-run in full float64 (the
``f64_spotcheck``).  ``--f64`` runs full float64, one run per level.

A run whose worst level deviates from the notebook by more than
``PARITY_GATE`` is adjudicated: each over-gate level is held at the same gate
to the JAX package's CPU-x64 value of that level, from the committed record
(``reference_values.CPU_X64_ERRORS``).  Levels with no value (their CPU run
is over the 5e7 node-step budget) are listed ``skipped_over_budget``.
Nothing is spawned and nothing of JAX is imported.  A failed gate, or a run
that raises, is printed and makes the process exit non-zero at the end.

Runs on the CUDA card unless ``--device cpu`` (``--cpu``); with no card and
no device it raises.  Not carried over from the JAX script: its
``TEMPORAL_F64_PIN`` (a workaround of the TPU's emulated float64) and
``NA_DD_SHARED_COMPILE`` (XLA's compile sharing).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
import traceback

from na_dd_tpu_torch import config
from na_dd_tpu_torch.harness.batched_ladder import run_spatial_ladder_batched
from na_dd_tpu_torch.harness.studies import (
    STUDIES,
    _make_trial,
    _study_unroll,
    run_eta_study_batched,
    run_spatial_study,
    run_temporal_study,
    study_consts,
)
from na_dd_tpu_torch.ops import kernels
from na_dd_tpu_torch.studies import RESULTS_DIR, checked_output, device_label
from na_dd_tpu_torch.studies.reference_values import (
    CPU_X64_BUDGET,
    CPU_X64_ERRORS,
    CPU_X64_RECORD,
    PARITY_GATE,
    REFERENCE_ERRORS,
)
from na_dd_tpu_torch.studies.write_reproduction import write_report

# The JAX script's order: the cheap, headline studies first, the Tf=1
# spatial ladders in the middle, the long peaks temporal ladder last.
PLAN = [
    ("pol", "spatial", dict(levels=8)),
    ("pol", "temporal", {}),
    ("pol", "eta", {}),
    ("expsin", "spatial", dict(levels=8)),
    ("expsin", "temporal", {}),
    ("expsin", "eta", {}),
    ("nfsp_cpcsH2_TclcdH3", "spatial", dict(levels=8)),
    ("nfsp_cpcsH2_TclcdH3", "temporal", {}),
    ("nfsp_cpcsH2_TclcdH3", "eta", {}),
    ("nfsp_cpcsH2_TclcdH2", "spatial", dict(levels=8)),
    ("nfsp_cpcsH2_TclcdH2", "temporal", {}),
    ("nfsp_cpcsH2_TclcdH2", "eta", {}),
    ("nfsp_cpcsH1_TclcdH2", "spatial", dict(levels=8)),
    ("nfsp_cpcsH1_TclcdH2", "temporal", {}),
    ("nfsp_cpcsH1_TclcdH2", "eta", {}),
    ("peaks_fast1e1", "spatial", dict(levels=8)),
    ("peaks_fast1e1", "eta", {}),
    ("peaks_fast1e1", "temporal", {}),
]


def rel_dev(a: float, b: float) -> float:
    """|a − b| / |b|; 0 where both are 0, inf where only b is."""
    if b == 0.0:
        return 0.0 if a == 0.0 else math.inf
    return abs(a - b) / abs(b)


def max_rel_dev(ours, ref) -> float:
    """Max per-level relative deviation vs the reference list."""
    devs = [rel_dev(a, b) for a, b in zip(ours, ref)]
    return max(devs) if devs else float("nan")


def adjudicate(res: dict, ref_errors, cpu_x64=None) -> dict:
    """Hold every level over the gate to its CPU-x64 value.

    ``cpu_x64`` maps a level to the JAX package's CPU-x64 error (default:
    the committed record of the run).  The record has the JAX script's keys:
    ``status`` ("ok", or "skipped_over_budget" when no over-gate level has a
    value), and for "ok" ``level`` (the gated level furthest from its CPU-x64
    value), ``cpu_error`` (that value), ``reference`` (the notebook's),
    ``cpu_rel_dev`` (the port's relative deviation from ``cpu_error``) and
    ``passed`` (every gated level within the gate); besides, ``gated_levels``
    (each level's error, CPU-x64 value, deviation and verdict) and
    ``skipped_over_budget_levels``."""
    kind = res["kind"].replace("eta_batched", "eta")
    if cpu_x64 is None:
        cpu_x64 = CPU_X64_ERRORS.get((res["study"], kind), {})
    over = [k for k, (a, b) in enumerate(zip(res["errors"], ref_errors))
            if rel_dev(a, b) > PARITY_GATE]
    gated = [k for k in over if k in cpu_x64]
    skipped = [k for k in over if k not in cpu_x64]
    if not gated:
        return {
            "status": "skipped_over_budget",
            "over_gate_levels": over,
            "budget_node_steps": CPU_X64_BUDGET,
        }
    rows = []
    for k in gated:
        dev = rel_dev(res["errors"][k], cpu_x64[k])
        rows.append(dict(level=k, error=res["errors"][k], cpu_error=cpu_x64[k],
                         rel_dev=dev, passed=dev <= PARITY_GATE))
    worst = max(rows, key=lambda row: row["rel_dev"])
    return dict(
        status="ok",
        level=worst["level"],
        cpu_error=worst["cpu_error"],
        reference=ref_errors[worst["level"]],
        cpu_rel_dev=worst["rel_dev"],
        passed=all(row["passed"] for row in rows),
        gate=PARITY_GATE,
        record=CPU_X64_RECORD,
        gated_levels=rows,
        skipped_over_budget_levels=skipped,
    )


def f64_spotcheck(study: str, kind: str, level: int, mixed_error: float, device) -> dict:
    """Fast-mode guard: re-run ONE level in full float64 and compare it
    with the mixed-mode value."""
    cfg = STUDIES[study]
    mc = study_consts(study)
    if kind == "spatial":
        N = 2 * 2**level
        dt = (1.0 / N) ** 1.5
        Tf = cfg["spatial_Tf"]
    else:
        tcfg = cfg["temporal"]
        dt = tcfg["base_dt"] / 2**level
        n_of_dt = tcfg.get("N_of_dt")
        N = n_of_dt(dt) if n_of_dt is not None else tcfg["N"]
        Tf = tcfg["Tf"]
    t0 = time.time()
    trial = _make_trial(
        cfg["case_cls"], N, 50.0, mc=mc,
        krylov_unroll=_study_unroll(cfg, N, dt, mc), precision="full", device=device,
    )
    e64 = float(trial.run_for_errors(Tf=Tf, dt=dt).overall_combined_error)
    rel = abs(e64 - mixed_error) / max(abs(e64), 1e-300)
    return dict(
        level=level, N=N, f64_error=e64, mixed_error=mixed_error,
        mixed_vs_f64_rel=rel, wallclock_s=round(time.time() - t0, 1),
    )


def run_one(study: str, kind: str, kwargs: dict, *, fast: bool, device) -> dict:
    """One run of the PLAN, as the JAX script makes it."""
    precision = "mixed" if fast else "full"
    if kind == "spatial":
        if fast:
            res = run_spatial_ladder_batched(study, measure_steady=True, precision=precision,
                                             device=device, **kwargs)
            res["kind"] = "spatial"  # same protocol, one batch
            res["batched"] = True
        else:
            res = run_spatial_study(study, measure_steady=True, device=device, **kwargs)
    elif kind == "temporal":
        res = run_temporal_study(study, measure_steady=True, precision=precision,
                                 device=device, **kwargs)
    else:
        # all eta values as one batch (the reference loops them)
        res = run_eta_study_batched(study, precision=precision, device=device, **kwargs)
    return res


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--f64", action="store_true",
                   help="full float64, one run per level (default: the fast mixed mode)")
    p.add_argument("--only", nargs="+", metavar="STUDY [KIND]",
                   help="re-run one study (and optionally one kind); results merge")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card by default, 'cpu' only when asked")
    p.add_argument("--cpu", action="store_true", help="the JAX script's spelling of --device cpu")
    p.add_argument("--results-dir", default=str(RESULTS_DIR),
                   help="where the JSONs and REPRODUCTION.md go (default: studies/results_torch/)")
    return p


def main(argv=None) -> int:
    """Run the PLAN (or ``--only`` of it); return 0, or 1 if a gate failed
    or a run raised."""
    args = parser().parse_args(argv)
    device = config.resolve_device("cpu" if args.cpu else args.device)
    results_dir = checked_output(args.results_dir)
    only_study = only_kind = None
    if args.only:
        if len(args.only) > 2:
            raise SystemExit("--only takes a study name and optionally a kind")
        only_study = args.only[0]
        only_kind = args.only[1] if len(args.only) == 2 else None
        if not any(s == only_study and (only_kind is None or k == only_kind)
                   for s, k, _ in PLAN):
            known = sorted({s for s, _, _ in PLAN})
            raise SystemExit(
                f"--only {only_study}{' ' + only_kind if only_kind else ''} "
                f"matches nothing in the PLAN; studies: {known}"
            )
    fast = not args.f64
    label = device_label(device)
    print(f"device: {label}", flush=True)
    if fast:
        print("mode: FAST (precision=mixed, batched spatial ladders; "
              "--f64 for the full-f64 per-level mode)", flush=True)

    t_start = time.time()
    failed = []
    for study, kind, kwargs in PLAN:
        if only_study and (study != only_study or (only_kind and kind != only_kind)):
            continue
        print(f"\n########## {study} / {kind} ##########", flush=True)
        t0 = time.time()
        kernels.reset_launch_counts()
        try:
            res = run_one(study, kind, kwargs, fast=fast, device=device)
        except Exception:
            traceback.print_exc()
            failed.append((study, kind, "raised"))
            continue
        res["kernel_launches"] = dict(kernels.LAUNCHES)
        res["total_wallclock_s"] = time.time() - t0
        res["precision"] = "mixed" if fast else "full"
        res["device"] = label
        if fast and kind in ("spatial", "temporal"):
            try:
                res["f64_spotcheck"] = f64_spotcheck(
                    study, kind, len(res["errors"]) - 1, res["errors"][-1], device
                )
                print(f"  [f64 spot-check] {res['f64_spotcheck']}", flush=True)
            except Exception:
                traceback.print_exc()
                failed.append((study, kind, "f64 spot-check raised"))

        ref_errors = REFERENCE_ERRORS.get((study, kind))
        if ref_errors:
            res["reference_errors"] = ref_errors
            res["max_rel_dev_vs_reference"] = max_rel_dev(res["errors"], ref_errors)
            if res["max_rel_dev_vs_reference"] > PARITY_GATE:
                v = res["adjudication"] = adjudicate(res, ref_errors)
                if v["status"] == "ok":
                    print(
                        f"  [adjudicate] level {v['level']}: port {res['errors'][v['level']]:.6e}"
                        f" vs CPU x64 {v['cpu_error']:.6e} (rel {v['cpu_rel_dev']:.2e}; "
                        f"ref {v['reference']:.3e}) -> {'PASS' if v['passed'] else 'FAIL'}",
                        flush=True,
                    )
                    for row in v["gated_levels"]:
                        if not row["passed"]:
                            print(f"  [adjudicate] FAIL level {row['level']}: {row}", flush=True)
                            failed.append((study, kind, f"level {row['level']}"))
                else:
                    print(f"  [adjudicate] {v}", flush=True)
        results_dir.mkdir(parents=True, exist_ok=True)
        path = results_dir / f"{res['study']}_{res['kind']}.json"
        path.write_text(json.dumps(res, indent=2))
        print(
            f"########## done {study}/{kind} in {res['total_wallclock_s']:.1f}s "
            f"max_rel_dev={res.get('max_rel_dev_vs_reference', float('nan')):.2e}",
            flush=True,
        )

    path = write_report(device=label, total_s=time.time() - t_start, results_dir=results_dir)
    print(f"\nwrote {path}", flush=True)
    if failed:
        print(f"FAILED: {failed}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
