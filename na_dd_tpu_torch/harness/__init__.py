"""harness (port of na_dd_tpu.harness): MMS trials, error norms and
convergence rates."""

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

__all__ = [
    "ErrorTimeSeries",
    "run_simulation_collect_data",
    "calculate_combined_error_norm",
    "NumericalErrorSummary",
    "MMSTrial",
    "RateStatus",
    "calculate_observed_rates",
    "observed_rates_report",
    "report_on_rates",
]
