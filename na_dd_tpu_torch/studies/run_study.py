"""The port's study CLI: the six reference notebooks' convergence studies
on the card (counterpart of ``studies/run_study.py``).

    python -m na_dd_tpu_torch.studies.run_study --study expsin --kind spatial --levels 6
    python -m na_dd_tpu_torch.studies.run_study --study pol --kind temporal
    python -m na_dd_tpu_torch.studies.run_study --study pol --kind eta
    python -m na_dd_tpu_torch.studies.run_study --all --levels 8
    python -m na_dd_tpu_torch.studies.run_study --study pol --levels 3 --device cpu

Runs on the CUDA card unless ``--device cpu``; with no card and no
``--device`` it raises.  Results are printed and archived as
``<study>_<kind>_<unix time>.json`` under ``studies/results_torch/`` (or
``--results-dir``), never under ``studies/results/``.

The JAX CLI's environment switches are flags here: ``NA_DD_TPU_PRECISION``
is ``--precision`` (``full``, ``mixed`` or ``df``), ``NA_DD_TPU_MIXED_DF=1``
is ``--mixed-df``, ``NA_DD_TPU_X64=0`` is ``--dtype float32`` and
``NA_DD_TPU_COUPLING`` is ``--coupling-source``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from na_dd_tpu_torch import config
from na_dd_tpu_torch.harness.batched_ladder import run_spatial_ladder_batched
from na_dd_tpu_torch.harness.rates import report_on_rates
from na_dd_tpu_torch.harness.studies import (
    STUDIES,
    run_eta_study,
    run_eta_study_batched,
    run_spatial_study,
    run_temporal_study,
)
from na_dd_tpu_torch.ops import kernels
from na_dd_tpu_torch.studies import RESULTS_DIR, checked_output, device_label

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def save_result(result: dict, results_dir) -> Path:
    """Write ``result`` to ``<results_dir>/<study>_<kind>_<unix time>.json``."""
    results_dir = checked_output(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    path = results_dir / f"{result['study']}_{result['kind']}_{int(time.time())}.json"
    path.write_text(json.dumps(result, indent=2))
    print(f"saved -> {path}")
    return path


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="The JAX CLI's --shared-compile (XLA's traced-dt mode: one compile "
        "per grid size) is left out: the port's eager loop compiles nothing.",
    )
    p.add_argument("--study", choices=sorted(STUDIES), default="expsin")
    p.add_argument("--kind", choices=["spatial", "temporal", "eta"], default="spatial")
    p.add_argument("--levels", type=int, default=None, help="ladder depth override")
    p.add_argument("--all", action="store_true", help="run all six studies, all kinds")
    p.add_argument("--expected-rate", type=float, default=2.0)
    p.add_argument("--serial-eta", action="store_true",
                   help="run the eta sweep one eta at a time instead of as one batch")
    p.add_argument("--batched", action="store_true",
                   help="spatial ladders: every level padded to the finest and run "
                        "as one batch (harness/batched_ladder.py)")
    p.add_argument("--measure-steady", action="store_true",
                   help="re-run each level for a second, warm time")
    p.add_argument("--precision", choices=["full", "mixed", "df"], default="full",
                   help="mixed: float32 Krylov under float64 refinement; df: the "
                        "double-float step around the float32 kernels (the JAX CLI's "
                        "NA_DD_TPU_PRECISION)")
    p.add_argument("--mixed-df", action="store_true",
                   help="with --precision mixed: the refinement's residuals in "
                        "double-float (the JAX CLI's NA_DD_TPU_MIXED_DF=1)")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="float64",
                   help="float32 is the JAX CLI's NA_DD_TPU_X64=0")
    p.add_argument("--coupling-source", choices=["jvp", "analytic"], default="jvp",
                   help="analytic: closed-form couplings, each Newton sweep one fused "
                        "triple solve (the JAX CLI's NA_DD_TPU_COUPLING)")
    p.add_argument("--device", default=None,
                   help="torch device; the CUDA card by default, 'cpu' only when asked")
    p.add_argument("--results-dir", default=str(RESULTS_DIR),
                   help="where the JSON results go (default: studies/results_torch/)")
    return p


def run_one(args, study: str, kind: str, levels, device) -> dict:
    """One study of one kind, as the JAX CLI's ``run_one`` runs it."""
    print(f"\n===== {study} / {kind} =====")
    kernels.reset_launch_counts()
    route = dict(precision=args.precision, coupling_source=args.coupling_source,
                 mixed_df=args.mixed_df, dtype=DTYPES[args.dtype], device=device)
    if kind == "spatial":
        runner = run_spatial_ladder_batched if args.batched else run_spatial_study
        res = runner(study, levels=levels or 8, measure_steady=args.measure_steady, **route)
    elif kind == "temporal":
        res = run_temporal_study(study, levels=levels, measure_steady=args.measure_steady,
                                 **route)
    else:
        # the batched sweep runs all seven eta values as one batch;
        # --serial-eta keeps the reference's one-run-per-eta loop
        runner = run_eta_study if args.serial_eta else run_eta_study_batched
        res = runner(study, **route)
    # where the run went: the hand-written kernels' launches (none on the CPU)
    res["kernel_launches"] = dict(kernels.LAUNCHES)
    res["device"] = device_label(device)
    if kind in ("spatial", "temporal") and len(res["errors"]) >= 3:
        report_on_rates(
            res["errors"],
            expected_rate=args.expected_rate,
            tolerance=0.3,
            title=f"{study} {kind} rates",
        )
    save_result(res, args.results_dir)
    return res


def main(argv=None) -> list:
    """Parse ``argv`` (the command line when None), run, and return the
    result dicts in the order they ran."""
    args = parser().parse_args(argv)
    device = config.resolve_device(args.device)
    checked_output(args.results_dir)
    if args.all:
        return [run_one(args, study, kind, args.levels, device)
                for study in STUDIES for kind in ("spatial", "temporal", "eta")]
    return [run_one(args, args.study, args.kind, args.levels, device)]


if __name__ == "__main__":
    main()
