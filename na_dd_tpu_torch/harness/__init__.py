"""harness (port of na_dd_tpu.harness): MMS trials, error norms and
convergence rates; the spatial ladder as one batch of levels; the
production entry points (simulate, adaptive steps, checkpoints) and adjoint
gradients with calibration."""

from na_dd_tpu_torch.harness.rates import (
    RateStatus,
    calculate_observed_rates,
    observed_rates_report,
    report_on_rates,
)
from na_dd_tpu_torch.harness.trial import (
    ErrorTimeSeries,
    MMSTrial,
    NumericalErrorSummary,
    calculate_combined_error_norm,
    run_simulation_collect_data,
)
from na_dd_tpu_torch.harness.batched_ladder import pad_grid, pad_state, run_spatial_ladder_batched
from na_dd_tpu_torch.harness.simulate import (
    dissolved_drug_fraction,
    make_integrator,
    released_drug_fraction,
    simulate,
    simulate_adaptive,
)
from na_dd_tpu_torch.harness.gradients import build_simulator, fit_parameters

__all__ = [
    "ErrorTimeSeries",
    "run_simulation_collect_data",
    "calculate_combined_error_norm",
    "NumericalErrorSummary",
    "MMSTrial",
    "pad_grid",
    "pad_state",
    "run_spatial_ladder_batched",
    "RateStatus",
    "calculate_observed_rates",
    "observed_rates_report",
    "report_on_rates",
    "make_integrator",
    "dissolved_drug_fraction",
    "released_drug_fraction",
    "simulate",
    "simulate_adaptive",
    "build_simulator",
    "fit_parameters",
]
