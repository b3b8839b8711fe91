"""Render the port's reproduction report from its archived results
(counterpart of ``studies/write_reproduction.py``).

    python -m na_dd_tpu_torch.studies.write_reproduction [--results-dir DIR]

Reads ``<results_dir>/<study>_<kind>.json`` (the JSONs that
:mod:`na_dd_tpu_torch.studies.run_all` writes) and writes
``<results_dir>/REPRODUCTION.md``: the JAX report's columns and ``MISSING``
rows, with the device's name (on the card, its name and power limit as
``nvidia-smi`` prints them) in the header.  The wall-clock columns divide the
card's steady time into the reference notebook's CPU time.  It never writes
the root ``REPRODUCTION.md``.
"""

from __future__ import annotations

import argparse
import json
import os

from na_dd_tpu_torch.studies import RESULTS_DIR, checked_output
from na_dd_tpu_torch.studies.reference_values import (
    CPU_X64_RECORD,
    PARITY_GATE,
    REFERENCE_ERRORS,
    REFERENCE_FINAL_RATE,
    REFERENCE_FINEST_WALLCLOCK,
)

# Presentation order (run_all.PLAN grouped by study).
ORDER = [
    (study, kind)
    for study in [
        "pol",
        "expsin",
        "nfsp_cpcsH2_TclcdH3",
        "nfsp_cpcsH2_TclcdH2",
        "nfsp_cpcsH1_TclcdH2",
        "peaks_fast1e1",
    ]
    for kind in ["spatial", "temporal", "eta"]
]


def load_result(study: str, kind: str, results_dir=RESULTS_DIR):
    """The archived run of ``study``/``kind``, or None (an η sweep may be
    archived as ``*_eta_batched.json`` or ``*_eta.json``)."""
    for suffix in ([kind] if kind != "eta" else ["eta_batched", "eta"]):
        path = os.path.join(results_dir, f"{study}_{suffix}.json")
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    return None


def adjudication_cell(adj) -> str:
    if adj is None:
        return "—"
    if adj.get("status") == "ok":
        return (
            f"L{adj['level']} cpu-x64 {adj['cpu_rel_dev']:.1e} "
            f"{'PASS' if adj['passed'] else '**FAIL**'}"
        )
    return adj.get("status", "?")


def write_report(
    device: str = "",
    total_s: float | None = None,
    results_dir=RESULTS_DIR,
    out_path=None,
) -> str:
    """Write the report of the runs archived in ``results_dir`` to
    ``out_path`` (default ``<results_dir>/REPRODUCTION.md``) and return its
    path."""
    out_path = checked_output(out_path or os.path.join(results_dir, "REPRODUCTION.md"))
    runs = {key: load_result(*key, results_dir) for key in ORDER}
    if not device:  # re-rendered: the devices the archived runs name
        device = "; ".join(sorted({r["device"] for r in runs.values() if r and r.get("device")}))
    lines = [
        "# REPRODUCTION — the six reference convergence studies on the PyTorch/CUDA port",
        "",
        (f"Device: {device}; " if device else "") + "PC-RegHCsTriple, eta=50 (eta",
        "studies sweep 10..1000); protocols and per-notebook model constants",
        "identical to the reference notebooks (see",
        "na_dd_tpu_torch/studies/reference_values.py for the extracted ground",
        "truth).  'max rel dev' is the worst per-level relative deviation of the",
        "port's error vs the notebook's saved output across the WHOLE ladder, not",
        "just the finest level.  'steady' is the wall-clock of a second run of",
        "the finest level (a spatial ladder run as one batch: of the whole batch),",
        "set against the reference notebook's serial CPU time; first-run times are",
        "archived in the JSONs.",
        "",
        f"'adjudicated': when max rel dev exceeds the {PARITY_GATE:g} gate, every",
        "over-gate level is held at the same gate to the JAX package's CPU-x64",
        f"value of that level ({CPU_X64_RECORD}, exact f64",
        "arithmetic); the cell names the level furthest from its CPU-x64 value and",
        "that deviation.  Levels whose CPU-x64 run is over the 5e7 node-step",
        "budget have no value and are listed 'skipped_over_budget' in the JSON",
        "(the whole cell when no over-gate level has one); '—' means the run was",
        "within the gate and needed no adjudication.",
        "",
        "'mode': the arithmetic that produced the row — 'f64' (per-level",
        "float64 runs) or 'mixed' (float64 iterative refinement around float32",
        "Krylov, the fast default; where present, the 'f64 spot' sub-value is",
        "the measured relative gap between the mixed and full-f64 result of the",
        "finest level, re-run in f64 as part of the same run).",
        "",
        "| study | kind | mode | levels | final error (ours) | final error (ref) | "
        "max rel dev | adjudicated | final rate (ours/ref) | finest steady vs ref | speedup |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    missing, skipped = [], []
    for study, kind in ORDER:
        res = runs[(study, kind)]
        if res is None:
            missing.append((study, kind))
            lines.append(f"| {study} | {kind} | MISSING | | | | | | | | |")
            continue
        ref_errors = REFERENCE_ERRORS.get((study, kind), [])
        ref_rate = REFERENCE_FINAL_RATE.get((study, kind))
        ref_t = REFERENCE_FINEST_WALLCLOCK.get((study, kind))
        final_err = res["errors"][-1]
        final_rate = res["rates"][-1] if res.get("rates") else float("nan")
        steady = (res.get("steady_s") or res["wallclock_s"])[-1]
        dev = res.get("max_rel_dev_vs_reference", float("nan"))
        adj = res.get("adjudication")
        if adj and adj.get("status") == "ok" and adj.get("skipped_over_budget_levels"):
            skipped.append((study, kind, adj["skipped_over_budget_levels"]))
        mode_cell = res.get("precision", "f64").replace("full", "f64")
        if res.get("batched"):
            mode_cell += " batched"
        spot = res.get("f64_spotcheck")
        if spot:
            mode_cell += f", f64 spot {spot['mixed_vs_f64_rel']:.0e}"
        lines.append(
            f"| {study} | {kind} | {mode_cell} | {len(res['errors'])} | {final_err:.3e} | "
            f"{(f'{ref_errors[-1]:.3e}' if ref_errors else '—')} | "
            f"{dev:.1e} | {adjudication_cell(adj)} | "
            f"{final_rate:.3f} / {(f'{ref_rate:.3f}' if ref_rate else '—')} | "
            f"{steady:.2f}s vs {(f'{ref_t:.0f}s' if ref_t else '—')} | "
            f"{(f'{ref_t / steady:.0f}x' if ref_t and steady > 0 else '—')} |"
        )

    lines += [
        "",
        "## Per-level detail",
        "",
        "Full per-level errors, reference values, first-run and steady",
        f"wall-clocks are archived beside this report in `{_shown(results_dir)}/*.json`",
        "(`errors` / `reference_errors` / `wallclock_s` / `steady_s`; the",
        "adjudication's `gated_levels`; `kernel_launches`, the hand-written",
        "kernels' launches during the run).",
        "",
        "## Notes",
        "",
        "- Eta sweeps run all seven regularization factors as one batch (each",
        "  Newton solve one batched kernel launch for all seven; the reference",
        "  loops them serially); the sweep's wall-clock column is the whole batch.",
        "- The peaks temporal ladder reproduces the reference protocol exactly,",
        "  including its quirk: the notebook recomputes N = ceil(1/(2 dt)) per",
        "  level (FIXED_GRID_SIZE=200 is dead code in cell 11) and its first",
        "  two levels use an N=1 all-boundary grid whose error is identically",
        "  0.0 (every node is pinned to the boundary value and the manufactured",
        "  solution vanishes there).",
        "- Temporal ladders whose rates are nan/negative reproduce the",
        "  reference's own behavior (errors sitting on the spatial floor).",
    ]
    for study, kind, levels in skipped:
        lines.append(f"- {study} {kind}: over-gate levels {levels} have no CPU-x64 value "
                     "(skipped_over_budget).")
    if total_s is not None:
        lines.append("- Wall-clock of the invocation that last refreshed this report:")
        lines.append(f"  {total_s:.0f}s (partial --only reruns refresh only their own rows).")
    if missing:
        lines.append(f"- Missing runs: {missing} (rerun "
                     "`python -m na_dd_tpu_torch.studies.run_all`).")
    text = "\n".join(lines) + "\n"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(text)
    return str(out_path)


def _shown(results_dir) -> str:
    """``results_dir`` relative to the repo root where it lies inside it."""
    root = RESULTS_DIR.parents[1]
    path = os.path.abspath(results_dir)
    return os.path.relpath(path, root) if path.startswith(str(root) + os.sep) else path


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--results-dir", default=str(RESULTS_DIR))
    path = write_report(results_dir=p.parse_args(argv).results_dir)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
