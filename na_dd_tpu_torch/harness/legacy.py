"""The reference's older all-in-one convergence-study runner
(``run_convergence_studies``; counterpart of
:mod:`na_dd_tpu.harness.legacy`): one call runs a spatial ladder (N doubling
at a fixed dt) and a temporal ladder (dt halving at a fixed N) for each
configured case and returns a dict-of-dicts report, on the port's
:class:`MMSTrial` and :mod:`rates`.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

from na_dd_tpu_torch.harness.rates import calculate_observed_rates
from na_dd_tpu_torch.harness.trial import MMSTrial
from na_dd_tpu_torch.ops.grid import make_uniform_grid

# (field_cls, mms_case_cls, forcing_terms_cls, integrator_cls, label)
StudyConfig = Tuple[type, type, type, type, str]
FullCvgReport = Dict[str, Dict[str, list]]


def run_convergence_studies(
    study_configs: List[StudyConfig], study_params: Dict[str, Any], *, dtype=None, device=None
) -> Dict[str, FullCvgReport]:
    """Spatial and temporal ladders for each study config.

    ``study_params`` keys (the reference's): Tf, model, N_base_spatial,
    num_spatial_refinements, dt_fixed_spatial, N_fixed_temporal,
    dt_base_temporal, num_temporal_refinements; optional variable_names,
    integral_vars, num_pc_steps, num_newton_steps, forcing_terms_params,
    field_params, integrator_params.  The grids are made with ``dtype`` on
    ``device`` (None: float64 on the card).  Rates are reported for a
    ladder of three levels or more.
    """
    variable_names = study_params.get("variable_names")
    integral_vars = study_params.get("integral_vars")
    Tf = study_params["Tf"]
    model = study_params["model"]
    refinement_factor = 2

    def make_trial(N, field_cls, mms_case_cls, forcing_terms_cls, integrator_cls):
        return MMSTrial(
            make_uniform_grid(N, N, dtype=dtype, device=device), model, mms_case_cls, field_cls,
            forcing_terms_cls, integrator_cls, variable_names=variable_names,
            integral_vars=integral_vars,
            forcing_terms_params=study_params.get("forcing_terms_params", {}),
            field_params=study_params.get("field_params", {}),
            integrator_params=dict(
                num_pc_steps=study_params.get("num_pc_steps", 1),
                num_newton_steps=study_params.get("num_newton_steps", 1),
                **study_params.get("integrator_params", {}),
            ),
        )

    all_results: Dict[str, FullCvgReport] = {}
    for field_cls, mms_case_cls, forcing_terms_cls, integrator_cls, label in study_configs:
        classes = (field_cls, mms_case_cls, forcing_terms_cls, integrator_cls)
        report: FullCvgReport = {
            kind: {"errors": [], "rates": [], "statuses": []} for kind in ("spatial", "temporal")
        }

        N_base = study_params["N_base_spatial"]
        dt_fixed = study_params["dt_fixed_spatial"]
        for k in range(study_params["num_spatial_refinements"]):
            N = N_base * refinement_factor**k
            t0 = time.perf_counter()
            err = make_trial(N, *classes).run_for_errors(Tf=Tf, dt=dt_fixed).overall_combined_error
            print(f"  [{label}] spatial N={N}: err={err:.4e} ({time.perf_counter() - t0:.2f}s)")
            report["spatial"]["errors"].append(err)

        trial = make_trial(study_params["N_fixed_temporal"], *classes)
        dt_base = study_params["dt_base_temporal"]
        for k in range(study_params["num_temporal_refinements"]):
            dt = dt_base / refinement_factor**k
            t0 = time.perf_counter()
            err = trial.run_for_errors(Tf=Tf, dt=dt).overall_combined_error
            print(f"  [{label}] temporal dt={dt:.3e}: err={err:.4e} ({time.perf_counter() - t0:.2f}s)")
            report["temporal"]["errors"].append(err)

        for kind in ("spatial", "temporal"):
            errs = report[kind]["errors"]
            if len(errs) >= 3:
                pairs = calculate_observed_rates(errs, refinement_factor)
                report[kind]["rates"] = [r for r, _ in pairs]
                report[kind]["statuses"] = [s for _, s in pairs]
        all_results[label] = report
    return all_results
