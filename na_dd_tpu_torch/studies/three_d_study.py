"""The 3-D model convergence study and step-time probe on the card
(counterpart of ``studies/three_d_study.py``).

    python -m na_dd_tpu_torch.studies.three_d_study                  # spatial ladder N=4..32
    python -m na_dd_tpu_torch.studies.three_d_study --levels 5 --variant cs
    python -m na_dd_tpu_torch.studies.three_d_study --temporal --self-reference --n0 16 --levels 5
    python -m na_dd_tpu_torch.studies.three_d_study --batched --levels 5
    python -m na_dd_tpu_torch.studies.three_d_study --eta-sweep
    python -m na_dd_tpu_torch.studies.three_d_study --levels 2 --device cpu

The full five-field 3-D system on MMSCaseExpSin3 with the study's constants:
a spatial ladder (N = n0·2^k, dt = dt0/2^k, so both error components contract
at order 2), a temporal ladder on a fixed grid (``--temporal``; with
``--self-reference`` each level is also measured against a run at
dt0/2^(levels+1) on the same grid), the ladder as one batch of levels
(``--batched``) or the η sweep η = 10..1000 as one batch (``--eta-sweep``).
Each level reports its combined error, its first (cold) run and the min of 3
warm runs; the pairwise rates are gated at 2 ± 0.35 on the last two pairs.

Every level with a value in the JAX package's CPU-x64 record
(``reference_values``, from ``studies/results/drivers_cpu_x64.json``) is held
to it at ``PARITY_GATE`` (1e-2 in float32); a level without one is listed
``skipped_no_record``.  Nothing is spawned and nothing of JAX is imported.
A failed rate, convergence or record gate makes ``main`` return 1.

Runs on the CUDA card unless ``--device cpu`` (``--cpu``); with no card and no
device it raises.  The JAX script's environment switches are flags here:
``NA_DD_TPU_PRECISION`` is ``--precision``, ``NA_DD_TPU_X64=0`` is ``--dtype
float32``.  The result is archived as JSON under ``studies/results_torch/``
(or ``--results-dir``, or ``--out``), never under ``studies/results/``.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from na_dd_tpu_torch import config
from na_dd_tpu_torch.integrators.pc_trapezoidal import HCsCorrectorPositivityError
from na_dd_tpu_torch.models.coefficients import Model02
from na_dd_tpu_torch.models.consts import default_model_consts
from na_dd_tpu_torch.studies import RESULTS_DIR, checked_output, device_label
from na_dd_tpu_torch.studies.reference_values import (
    DRIVERS_CPU_X64_RECORD,
    ETA3_SWEEPS_CPU_X64,
    PARITY_GATE,
    THREE_D_BATCHED_CPU_X64,
    THREE_D_CONSTS,
    THREE_D_ETA,
    THREE_D_LEVELS_CPU_X64,
    THREE_D_SELF_REF_CPU_X64,
    THREE_D_TF,
)
from na_dd_tpu_torch.studies.run_all import rel_dev
from na_dd_tpu_torch.three_d.batched_ladder import run_spatial_ladder3_batched
from na_dd_tpu_torch.three_d.harness import build_runner3, make_setup3, run_eta_sweep3
from na_dd_tpu_torch.three_d.inner_products import inner_H3
from na_dd_tpu_torch.three_d.mms import MMSCaseExpSin3
from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

DTYPES = {"float64": torch.float64, "float32": torch.float32}
#: the record gate in float32: the float32 ladders sit ~1e-3..1e-2 above f64
F32_GATE = 1e-2
RATE_TOL = 0.35


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (= --device cpu)")
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--n0", type=int, default=4, help="coarsest N (doubles per level)")
    ap.add_argument("--variant", default="reghcs", choices=["cs", "hcs", "reghcs"])
    ap.add_argument("--batched", action="store_true",
                    help="run the whole ladder as one batch of levels, padded to the "
                         "finest (RegHCs only)")
    ap.add_argument("--eta-sweep", action="store_true",
                    help="regularization sweep eta=10..1000 (7 values) at N=--n0, "
                         "dt=--dt0, as one batch (RegHCs)")
    ap.add_argument("--temporal", action="store_true",
                    help="temporal ladder: fixed grid N=--n0, dt = --dt0 / 2^k")
    ap.add_argument("--tf", type=float, default=THREE_D_TF)
    ap.add_argument("--dt0", type=float, default=1e-2, help="dt at the coarsest level")
    ap.add_argument("--self-reference", action="store_true",
                    help="temporal ladders only: also measure each level's final state "
                         "against a run at dt0/2^(levels+1) on the same grid, so the "
                         "grid's spatial error cancels; the rate gate then runs on "
                         "these errors")
    ap.add_argument("--eta", type=float, default=THREE_D_ETA)
    ap.add_argument("--precision", choices=["full", "mixed", "df"], default="full",
                    help="mixed: float32 Krylov under float64 refinement; df: the "
                         "double-float step around the float32 K5 (the JAX script's "
                         "NA_DD_TPU_PRECISION)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float64",
                    help="float32 is the JAX script's NA_DD_TPU_X64=0")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card by default, 'cpu' only when asked")
    ap.add_argument("--results-dir", default=str(RESULTS_DIR),
                    help="where the JSON goes (default: studies/results_torch/)")
    ap.add_argument("--out", default=None, help="the JSON's path (overrides --results-dir)")
    return ap


def model3():
    return Model02(default_model_consts._replace(**THREE_D_CONSTS))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _write(path, payload) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=1))


def _pairwise(errors):
    return [float(np.log2(errors[i] / errors[i + 1])) for i in range(len(errors) - 1)]


def adjudicate(rows, tol) -> dict:
    """Hold each value to its CPU-x64 record.

    ``rows`` are dicts with the ``value`` and its ``cpu_error`` (None where
    the record has none) and whatever names the entry (level, N, dt, ...).
    Returns the JAX adjudicator's keys for the entry furthest from its record
    (``passed`` = every gated entry within ``tol``, ``cpu_error``,
    ``rel_dev``, ``tol``), plus ``gated_levels`` (each gated entry with its
    deviation and verdict) and ``skipped_no_record`` (the others); ``passed``
    is None when nothing had a record."""
    gated, skipped = [], []
    for row in rows:
        row = dict(row)
        ref = row.pop("cpu_error")
        if ref is None:
            skipped.append(row)
            continue
        dev = rel_dev(row["value"], ref)
        gated.append(dict(row, cpu_error=ref, rel_dev=dev, passed=dev <= tol))
    out = dict(tol=tol, record=DRIVERS_CPU_X64_RECORD, backend="cpu-x64",
               gated_levels=gated, skipped_no_record=skipped)
    if not gated:
        return dict(out, passed=None, cpu_error=None, rel_dev=None)
    worst = max(gated, key=lambda r: r["rel_dev"])
    return dict(out, passed=all(r["passed"] for r in gated), cpu_error=worst["cpu_error"],
                rel_dev=worst["rel_dev"])


def _print_adjudication(adj) -> None:
    def name(row):
        eta = f" eta={row['eta']:.2f}" if "eta" in row else ""
        return f"{row['quantity']} N={row['N']} dt={row['dt']:.3e}{eta}"

    for row in adj["gated_levels"]:
        print(f"  [adjudicate] {name(row)}: {row['value']!r} against CPU-x64 "
              f"{row['cpu_error']!r}, rel {row['rel_dev']:.3e} "
              f"{'PASS' if row['passed'] else 'FAIL'} (tol {adj['tol']:g})")
    for row in adj["skipped_no_record"]:
        print(f"  [adjudicate] {name(row)}: skipped_no_record")
    print("adjudication (CPU x64 record):",
          json.dumps({k: adj[k] for k in ("passed", "cpu_error", "rel_dev", "tol")}), flush=True)


def _on_record(args) -> bool:
    """The record holds the study's default Tf and eta only."""
    return (args.tf, args.eta) == (THREE_D_TF, THREE_D_ETA)


def run_eta_sweep(args, device, dtype, tol, _out_path):
    etas = [float(x) for x in np.logspace(1, 3, 7)]
    t0 = time.perf_counter()
    res = run_eta_sweep3(MMSCaseExpSin3, model=model3(), N=args.n0, Tf=args.tf, dt=args.dt0,
                         etas=etas, dtype=dtype, device=device)
    wall = time.perf_counter() - t0
    for eta, err, conv in zip(res["etas"], res["errors"], res["converged"]):
        print(f"eta={eta:8.2f} err={err:.6e} conv={conv}", flush=True)
    ok = all(res["converged"]) and all(np.isfinite(res["errors"]))
    print(f"whole sweep in one batch: {wall:.1f}s")
    print("[OK]" if ok else "[CONVERGENCE CHECK FAILED]")
    record = ETA3_SWEEPS_CPU_X64.get((args.n0, args.dt0)) if _on_record(args) else None
    res["adjudication"] = adjudicate(
        [dict(quantity="error", level=i, N=args.n0, dt=args.dt0, eta=eta, value=err,
              cpu_error=None if record is None else record[i])
         for i, (eta, err) in enumerate(zip(res["etas"], res["errors"]))], tol)
    res.update(backend=device.type, x64=dtype == torch.float64, N=args.n0, Tf=args.tf,
               dt=args.dt0, wallclock_s=wall, timestamp=time.strftime("%Y-%m-%d %H:%M:%S"))
    return res, ok


def run_batched(args, device, dtype, tol, _out_path):
    res = run_spatial_ladder3_batched(
        MMSCaseExpSin3, model=model3(), levels=args.levels, base_N=args.n0, dt0=args.dt0,
        Tf=args.tf, eta=args.eta, measure_steady=True,
        precision=None if args.precision == "full" else args.precision, dtype=dtype,
        device=device,
    )
    # the pairwise log2 rates (levels-1 of them), as the serial path gates:
    # the 3-point res["rates"] would leave a 3-level run ungated
    pairwise = _pairwise(res["errors"])
    print("observed rates (pairwise):", [f"{r:.3f}" for r in pairwise])
    ok = all(abs(r - 2.0) < RATE_TOL for r in pairwise[-2:]) and all(res["converged"])
    print("[OK]" if ok else "[RATE/CONVERGENCE CHECK FAILED]")
    rows = []
    for k, (N, err) in enumerate(zip(res["Ns"], res["errors"])):
        dt = args.dt0 / 2**k
        ref = THREE_D_BATCHED_CPU_X64.get((N, dt)) if _on_record(args) else None
        rows.append(dict(quantity="error", level=k, N=N, dt=dt, value=err, cpu_error=ref))
    res["adjudication"] = adjudicate(rows, tol)
    res.update(backend=device.type, x64=dtype == torch.float64,
               timestamp=time.strftime("%Y-%m-%d %H:%M:%S"))
    return res, ok


def _host_level(run, s0, device):
    """One run of a level: (final state, worst err², converged, hcs_ok) with
    the scalars read in one host transfer."""
    s_fin, worst, conv, hcs_ok, _per = run(s0)
    packed = torch.stack([v.to(torch.float64) for v in (worst, conv, hcs_ok)]).cpu()
    return s_fin, float(packed[0]), bool(packed[1] > 0.5), bool(packed[2] > 0.5)


def run_ladder(args, device, dtype, tol, out_path):
    """The serial spatial or temporal ladder, each level dumped as it ends."""
    model = model3()
    integrator_params = dict(num_newton_steps=2)
    if args.precision != "full":
        integrator_params["precision"] = args.precision
    kind = "temporal" if args.temporal else "spatial"
    header = dict(backend=device.type, x64=dtype == torch.float64, variant=args.variant,
                  kind=kind, precision=args.precision, Tf=args.tf, eta=args.eta)
    levels, final_states = [], []
    for k in range(args.levels):
        # spatial: N doubles and dt halves a level; temporal: fixed N, dt halves
        N = args.n0 if args.temporal else args.n0 * 2**k
        dt = args.dt0 / 2**k
        g, case, _field, integ = make_setup3(MMSCaseExpSin3, N=N, model=model,
                                             variant=args.variant, eta=args.eta,
                                             integrator_params=integrator_params,
                                             dtype=dtype, device=device)
        run, s0 = build_runner3(g, case, integ, Tf=args.tf, dt=dt)
        t0 = time.perf_counter()
        s_fin, worst, conv, hcs_ok = _host_level(run, s0, device)
        t_cold = time.perf_counter() - t0
        if args.self_reference:
            final_states.append(s_fin)
            self_ref_parts = (g, case, integ)
        # steady = min over 3 warm calls of the same runner
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(s0)
            _sync(device)
            warm.append(time.perf_counter() - t0)
        t_warm = min(warm)
        if not hcs_ok:
            raise HCsCorrectorPositivityError(
                f"level N={N}: HCs corrector denominator lost positivity")
        num_steps = max(1, int(np.ceil(args.tf / dt)))
        lv = dict(N=N, dt=dt, nodes=(N + 1) ** 3, error=math.sqrt(worst), converged=conv,
                  cold_s=t_cold, warm_s=t_warm, warm_per_step_s=t_warm / num_steps)
        levels.append(lv)
        print(f"[L{k}] N={N:4d} ({lv['nodes']:>9,} nodes) dt={dt:.2e} err={lv['error']:.6e} "
              f"conv={lv['converged']} cold={t_cold:.1f}s warm={t_warm:.3f}s "
              f"({lv['warm_per_step_s'] * 1e3:.1f} ms/step)", flush=True)
        # incremental dump: a run cut at a later level keeps every level done
        _write(out_path, dict(header, levels=levels, partial=True,
                              timestamp=time.strftime("%Y-%m-%d %H:%M:%S")))

    errs = [lv["error"] for lv in levels]
    rates = _pairwise(errs)
    print("observed rates:", [f"{r:.3f}" for r in rates])

    self_rates, dt_ref = None, None
    if args.self_reference:
        # the reference run: same grid, case and integrator, dt two halvings
        # below the finest level's, so its temporal error is 16x smaller
        g, case, integ = self_ref_parts
        dt_ref = args.dt0 / 2 ** (args.levels + 1)
        run_ref, s0_ref = build_runner3(g, case, integ, Tf=args.tf, dt=dt_ref)
        t0 = time.perf_counter()
        s_ref, _w, conv_ref, _h = _host_level(run_ref, s0_ref, device)
        print(f"[ref] dt={dt_ref:.2e} ({int(np.ceil(args.tf / dt_ref))} steps) "
              f"cold={time.perf_counter() - t0:.1f}s conv={conv_ref}", flush=True)

        def diff_norm_sq(sa, sb):
            tot = 0.0
            for a, b in zip(sa, sb):
                e = a - b
                tot = tot + inner_H3(LOCAL_OPS3, g, e, e)
            return tot

        self_errs = torch.stack([diff_norm_sq(s_k, s_ref) for s_k in final_states]).to(
            torch.float64).sqrt().cpu().tolist()
        self_rates = _pairwise(self_errs)
        for lv, se in zip(levels, self_errs):
            lv["self_ref_error"] = se
        print("self-reference errors:", [f"{e:.3e}" for e in self_errs])
        print("self-reference rates:", [f"{r:.3f}" for r in self_rates])

    # the last two pairwise rates, gated only once there are two
    if args.temporal and args.self_reference:
        rate_ok = len(self_rates) < 2 or all(abs(r - 2.0) < RATE_TOL for r in self_rates[-2:])
    elif args.temporal:
        # a temporal ladder may stall on the fixed grid's spatial floor: a
        # level passes on a rate ~2 or on an error that stopped moving
        floor = [abs(errs[i] - errs[i + 1]) < 0.05 * errs[i] for i in range(len(errs) - 1)]
        rate_ok = len(rates) < 2 or all(
            abs(r - 2.0) < RATE_TOL or f for r, f in zip(rates[-2:], floor[-2:]))
    else:
        rate_ok = len(rates) < 2 or all(abs(r - 2.0) < RATE_TOL for r in rates[-2:])
    ok = rate_ok and all(lv["converged"] for lv in levels)
    print("[OK]" if ok else "[RATE/CONVERGENCE CHECK FAILED]")

    rows = []
    for k, lv in enumerate(levels):
        key = (args.variant, lv["N"], lv["dt"])
        rows.append(dict(quantity="error", level=k, N=lv["N"], dt=lv["dt"], value=lv["error"],
                         cpu_error=THREE_D_LEVELS_CPU_X64.get(key) if _on_record(args) else None))
        if args.self_reference:
            key = (args.variant, lv["N"], lv["dt"], dt_ref)
            rows.append(dict(quantity="self_ref_error", level=k, N=lv["N"], dt=lv["dt"],
                             value=lv["self_ref_error"],
                             cpu_error=THREE_D_SELF_REF_CPU_X64.get(key)
                             if _on_record(args) else None))
    adjudication = adjudicate(rows, tol)
    res = dict(header, levels=levels, rates=rates, self_reference_rates=self_rates,
               adjudication=adjudication, timestamp=time.strftime("%Y-%m-%d %H:%M:%S"))
    return res, ok


def main(argv=None) -> int:
    """Parse ``argv`` (the command line when None), run, archive the result
    and return the exit code: 0, or 1 if a rate, convergence or record gate
    failed."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.batched and args.variant != "reghcs":
        ap.error("--batched supports the reghcs variant only")
    if args.eta_sweep and args.precision != "full":
        ap.error("--eta-sweep runs in full precision only")
    if args.self_reference and not args.temporal:
        ap.error("--self-reference requires --temporal")
    device = config.resolve_device("cpu" if args.cpu else args.device)
    dtype = DTYPES[args.dtype]
    tol = PARITY_GATE if dtype == torch.float64 else F32_GATE
    results_dir = checked_output(args.results_dir)
    label = device_label(device)
    print("device:", label, flush=True)

    if args.eta_sweep:
        name, runner = "three_d_eta_sweep.json", run_eta_sweep
    elif args.batched:
        name, runner = "three_d_study_batched.json", run_batched
    else:
        name, runner = "three_d_study.json", run_ladder
    out_path = checked_output(args.out or results_dir / name)
    res, ok = runner(args, device, dtype, tol, out_path)
    _print_adjudication(res["adjudication"])
    if res["adjudication"]["passed"] is False:
        ok = False
        print("[ADJUDICATION FAILED: a level deviates from its CPU-x64 record beyond tolerance]")
    res["device"] = label
    _write(out_path, res)
    print("archived:", out_path)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
