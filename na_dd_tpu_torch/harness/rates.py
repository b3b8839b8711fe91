"""Observed convergence-rate calculation and reporting (counterpart of
:mod:`na_dd_tpu.harness.rates`, copied so that the port depends on nothing
of the JAX package).

3-point rate formula over refinement ladders with the reference's status
taxonomy.  Pure host-side NumPy — these run on a handful of scalars after
the device work is done.
"""

from __future__ import annotations

import math
from typing import List, Literal, NamedTuple, Tuple

import numpy as np


class _RateStatus(NamedTuple):
    OK: str = "OK"
    INSUFFICIENT_DATA: str = "Insufficient Data"
    ZERO_DENOMINATOR_ZERO_NUMERATOR: str = "Differences near zero (converged/stalled?)"
    ZERO_DENOMINATOR_NONZERO_NUMERATOR: str = "Unstable rate (denominator near zero)"
    NON_POSITIVE_RATIO: str = "Non-positive ratio (convergence issue?)"
    ERROR_INCREASING: str = "Error increasing significantly"


RateStatus = _RateStatus()


def calculate_observed_rates(
    errors: List[float], refinement_factor: float = 2.0
) -> List[Tuple[float, str]]:
    """Observed rates log_r((E_k - E_{k+1}) / (E_{k+1} - E_{k+2})) with status."""
    num_errors = len(errors)
    assert num_errors >= 3, "At least 3 error values are required for rate calculation."
    assert refinement_factor > 1.0, "Refinement factor must be > 1.0"
    assert all(e >= 0 for e in errors), "All error values must be non-negative."

    log_r = math.log(refinement_factor)
    near_zero_tol = float(np.finfo(float).eps)
    results = []
    for k in range(num_errors - 2):
        numerator = errors[k] - errors[k + 1]
        denominator = errors[k + 1] - errors[k + 2]
        rate = float("nan")
        status = RateStatus.OK
        if denominator < 0:
            status = RateStatus.ERROR_INCREASING
        elif numerator <= 0:
            status = RateStatus.NON_POSITIVE_RATIO
        else:
            if abs(denominator) < near_zero_tol:
                if abs(numerator) < near_zero_tol:
                    status = RateStatus.ZERO_DENOMINATOR_ZERO_NUMERATOR
                else:
                    status = RateStatus.ZERO_DENOMINATOR_NONZERO_NUMERATOR
            if denominator > 0:
                rate = math.log(numerator / denominator) / log_r
        results.append((rate, status))
    return results


def observed_rates_report(
    errors: List[float],
    *,
    expected_rate: float = 2.0,
    tolerance: float = 0.1,
    cmp_type: str = "least",
    halt_print: bool = False,
) -> List[float]:
    """Rates + assertions.

    cmp_type 'least' asserts final rate >= expected - tolerance; 'equal'
    asserts |final - expected| <= tolerance.  Exactly-zero error ladders with a
    non-finite final rate pass without failing.
    """
    effectively_zero_tol = 1e-15
    too_small = 1e-16
    if cmp_type not in ("equal", "least"):
        raise ValueError(f"cmp_type must be 'equal' or 'least', not {cmp_type}")

    def cond_print(*args):
        if not halt_print:
            print(*args)

    observed_rates: List[float] = []
    cond_print("\nObserved Rates (3-point formula):")
    for k in range(len(errors) - 2):
        numerator = errors[k] - errors[k + 1]
        denominator = errors[k + 1] - errors[k + 2]
        rate = float("nan")
        if denominator > too_small and numerator > too_small:
            rate = math.log2(numerator / denominator)
        elif abs(denominator) <= too_small:
            if abs(numerator) <= too_small:
                cond_print(f"    Note: Differences zero: levels {k},{k+1},{k+2}.")
            else:
                cond_print(
                    f"    Warning: Denom near zero ({denominator:.2e}): levels {k},{k+1},{k+2}."
                )
        else:
            cond_print(
                f"    Warning: Numerator non-positive ({numerator:.2e}): levels {k},{k+1},{k+2}."
            )
        observed_rates.append(rate)
        cond_print(
            f"    Levels {k},{k+1},{k+2}: log2({numerator:.3e} / {denominator:.3e}) = {rate:.3f}"
        )

    assert len(observed_rates) > 0, "Not enough refinement levels."
    final_rate = observed_rates[-1]

    has_zero_errors = any(abs(e) < effectively_zero_tol for e in errors)
    if has_zero_errors and not np.isfinite(final_rate):
        cond_print("Non-finite final rate with an effectively-zero error. Not failing.")
        return observed_rates
    assert np.isfinite(final_rate), f"Final rate is not finite ({final_rate})."
    cond_print(f"  Final observed rate (3-point): {final_rate:.3f}")

    if cmp_type == "least":
        assert final_rate >= expected_rate - tolerance, (
            f"Observed rate {final_rate:.3f} not at least {expected_rate:.1f}"
        )
    else:
        assert np.isclose(final_rate, expected_rate, atol=tolerance), (
            f"Observed rate {final_rate:.3f} not close to expected {expected_rate:.1f}"
        )
    return observed_rates


def report_on_rates(
    errors: List[float],
    *,
    expected_rate: float = 2.0,
    tolerance: float = 0.1,
    cmp_type: str = "least",
    title: str = "Observed Rates",
):
    """Non-asserting wrapper.

    Returns (rates, success)."""
    print(f"\n{title}:")
    print("-" * len(title))
    try:
        rates = observed_rates_report(
            errors=errors,
            expected_rate=expected_rate,
            tolerance=tolerance,
            cmp_type=cmp_type,
            halt_print=False,
        )
    except Exception as exc:  # noqa: BLE001 - reporting wrapper
        print(f"[FAIL] rate calculation: {exc}")
        return [], False
    print(f"Final rate: {rates[-1]:.3f}")
    print(f"[OK] matches expected rate {expected_rate:.1f} (tol ±{tolerance:.1f})")
    return rates, True


def deliverable_from_test_calculate_observed_rates(
    *,
    name: str,
    errors: List[float],
    with_asserts: bool = True,
    target_order: float = 2.0,
    order_abs_tol: float = 0.1,
    cmp_type: Literal["least", "equal"] = "least",
) -> None:
    """Assert-wrapper used by rate tests."""

    def assert_if_on(condition, message):
        if with_asserts:
            assert condition, message

    valid = [e for e in errors if e is not None and np.isfinite(e) and e >= 0]
    assert_if_on(len(valid) >= 3, f"Insufficient valid {name} error points ({len(valid)}).")
    rates_with_status = calculate_observed_rates(valid, refinement_factor=2.0)
    assert_if_on(bool(rates_with_status), f"Rate calculation for {name} failed.")
    final_rate, final_status = rates_with_status[-1]
    print(f"  Rates({name}): {rates_with_status}")
    assert_if_on(final_status == RateStatus.OK, f"Rate status for {name}: {final_status}")
    if cmp_type == "equal":
        assert_if_on(
            abs(final_rate - target_order) <= order_abs_tol,
            f"Expected order {target_order} for {name}, got {final_rate}",
        )
    else:
        assert_if_on(
            final_rate >= target_order - order_abs_tol,
            f"Expected order at least {target_order} for {name}, got {final_rate:.3f}",
        )
