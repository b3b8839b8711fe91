"""MMS trial harness: whole-simulation execution and error summaries
(counterpart of :mod:`na_dd_tpu.harness.trial`).

The JAX package runs every step inside one ``lax.scan``.  Here the time loop
is a Python loop over eager device work; the per-step error norms and solver
diagnostics stay in device tensors and reach the host in ONE transfer after
the last step — no ``.item()``, ``bool()`` or ``float()`` inside the loop.
The error functional (combined max-integral norm with trapezoidal time
integration) is the reference's.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, NamedTuple, Optional, Type

import numpy as np
import torch

from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.integrators.pc_trapezoidal import HCsCorrectorPositivityError
from na_dd_tpu_torch.mms.engine import state_from_mms_when
from na_dd_tpu_torch.models.consts import STUDY_MODEL_CONSTS, ModelConsts
from na_dd_tpu_torch.ops import inner_products, stencils
from na_dd_tpu_torch.ops.grid import Grid
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS, Ops

ALL_VARIABLES = ("cp", "T", "cl", "cd", "cs")
DEFAULT_INTEGRAL_VARS = ("T", "cl", "cd")


class ErrorTimeSeries(NamedTuple):
    t: np.ndarray  # (K+1,)
    h_norm_sq_errors: Dict[str, np.ndarray]  # var -> (K+1,)
    grad_h_norm_p_sq_errors: Dict[str, np.ndarray]  # var -> (K+1,)
    krylov_iters: np.ndarray  # (K,) BiCGStab iterations per step
    krylov_converged: np.ndarray  # (K,) every solve of the step converged


def choose_krylov_unroll(N: int, dt: float, mc: ModelConsts = STUDY_MODEL_CONSTS) -> int:
    """BiCGStab iteration budget from the stiffness number s = 4 dt D_max / h²
    of J = 2I - dt·L (the tiers of ``na_dd_tpu.harness.studies``)."""
    h = 1.0 / N
    d_max = max(mc.DT, mc.Dl_max, mc.Dd_max)
    s = 4.0 * dt * d_max / (h * h)
    if s <= 0.25:
        return 8
    if s <= 1.0:
        return 16
    if s <= 8.0:
        return 32
    if s <= 64.0:
        return 48
    if s <= 256.0:
        return 96
    return 160


def _error_norms(g: Grid, ops: Ops, s: State, exact: State, variable_names, integral_vars):
    """Squared error norms of ``s`` against ``exact``, as 0-d tensors."""
    h_sq = {}
    grad_sq = {}
    for var in variable_names:
        err = getattr(s, var) - getattr(exact, var)
        h_sq[var] = inner_products.inner_H(ops, g, err, err)
        if var in integral_vars:
            gx_n, gy_n = stencils.grad_H(ops, g, getattr(s, var))
            gx_e, gy_e = stencils.grad_H(ops, g, getattr(exact, var))
            ex, ey = gx_n - gx_e, gy_n - gy_e
            grad_sq[var] = inner_products.inner_p(ops, g, ex, ey, ex, ey)
        else:
            grad_sq[var] = torch.zeros((), dtype=err.dtype, device=err.device)
    return h_sq, grad_sq


def _collect_errors(g: Grid, ops: Ops, mms_case, s: State, t, variable_names, integral_vars):
    """Per-step squared error norms against the exact MMS solution at t."""
    exact = state_from_mms_when(mms_case=mms_case, t=t, grid=g)
    return _error_norms(g, ops, s, exact, variable_names, integral_vars)


def _step_with_diagnostics(integrator, g: Grid, ops: Ops, s: State, t, dt):
    """One step as ``(State, [hcs_ok, converged, resnorm_sq, iters])`` with
    every diagnostic a device tensor.  An integrator whose ``step_fn``
    returns a bare State (forward Euler) makes no solve: its step is
    positive, converged, with residual 0 and 0 Krylov iterations."""
    out = integrator.step_fn(g, ops, s, t, dt)
    if isinstance(out, State):
        ok = torch.ones((), dtype=torch.bool, device=g.device)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        return out, [ok, ok, zero, zero]
    s1, diag = out
    return s1, [
        diag.hcs_denominator_ok,
        diag.krylov_converged,
        diag.krylov_resnorm_sq,
        diag.krylov_iters,
    ]


def run_simulation_collect_data(
    *,
    grid: Grid,
    integrator,
    exact_sol_pack,
    initial_state: State,
    Tf: float,
    dt: float,
    t0: float = 0.0,
    variable_names: List[str],
    integral_vars: List[str],
    ops: Ops = LOCAL_OPS,
):
    """Run from t0 to Tf collecting per-step error norms.

    Returns (ErrorTimeSeries, dt_adjusted); dt is adjusted so that
    num_steps·dt == Tf − t0 exactly.
    """
    num_steps = math.ceil((Tf - t0) / dt)
    dt_adj = (Tf - t0) / num_steps
    variable_names = tuple(variable_names)
    integral_vars = tuple(integral_vars)
    dtype, device = grid.dtype, grid.device
    ks = torch.arange(num_steps, dtype=dtype, device=device)

    def norms_row(s, t):
        h_sq, grad_sq = _collect_errors(
            grid, ops, exact_sol_pack, s, t, variable_names, integral_vars
        )
        return [h_sq[v] for v in variable_names] + [grad_sq[v] for v in variable_names]

    rows = [norms_row(initial_state, torch.as_tensor(t0, dtype=dtype, device=device))]
    small = []
    s = initial_state
    for k in range(num_steps):
        t_k = t0 + ks[k] * dt_adj
        s, diag = _step_with_diagnostics(integrator, grid, ops, s, t_k, dt_adj)
        rows.append(norms_row(s, t_k + dt_adj))
        small.append(diag)

    # the run's only host transfer
    norms = torch.stack([torch.stack(r) for r in rows], dim=1).to(torch.float64)
    diags = torch.stack(
        [torch.stack([v.to(torch.float64) for v in r]) for r in small], dim=1
    )
    packed = torch.cat([norms.reshape(-1), diags.reshape(-1)]).cpu().numpy()
    nv = len(variable_names)
    mats = packed[: norms.numel()].reshape(2 * nv, num_steps + 1)
    hcs_ok, converged, resnorm_sq, iters = packed[norms.numel():].reshape(4, num_steps)

    if not bool(np.all(hcs_ok > 0.5)):
        raise HCsCorrectorPositivityError(
            "Denominator 2 - dt Kd (Sd - Cd1) (1 + Cl1) below positiveness threshold."
        )
    n_unconverged = int(np.sum(converged < 0.5))
    if n_unconverged:
        warnings.warn(
            f"{n_unconverged}/{num_steps} steps had a Krylov solve that missed "
            f"its tolerance (worst resnorm_sq {float(np.max(resnorm_sq)):.3e}); "
            "increase krylov_unroll.",
            stacklevel=2,
        )

    ts = t0 + dt_adj * np.arange(num_steps + 1)
    series = ErrorTimeSeries(
        t=ts,
        h_norm_sq_errors={v: mats[i] for i, v in enumerate(variable_names)},
        grad_h_norm_p_sq_errors={v: mats[nv + i] for i, v in enumerate(variable_names)},
        krylov_iters=iters.astype(np.int64),
        krylov_converged=converged > 0.5,
    )
    return series, dt_adj


def calculate_combined_error_norm(
    series: ErrorTimeSeries,
    dt: float,
    integral_vars: List[str],
    all_variables: Optional[List[str]] = None,
) -> float:
    """Combined max-integral error norm:

        max_k sqrt( Σ_v ||e_v(t_k)||_H² + ∫₀^{t_k} Σ_{v∈integral} ||∇e_v||_p² dτ )

    with trapezoidal time integration of the gradient terms.
    """
    if all_variables is not None:
        assert all(v in all_variables for v in integral_vars), (
            "integral_vars must be a subset of all_variables."
        )
        h_vars = list(all_variables)
    else:
        h_vars = list(series.h_norm_sq_errors.keys())

    integrand = sum(
        np.asarray(series.grad_h_norm_p_sq_errors[v]) for v in integral_vars
    ) if integral_vars else np.zeros_like(series.t)
    spatial = sum(np.asarray(series.h_norm_sq_errors[v]) for v in h_vars)

    running = np.concatenate(
        [[0.0], np.cumsum(0.5 * dt * (integrand[:-1] + integrand[1:]))]
    )
    return float(np.sqrt(np.max(spatial + running)))


class NumericalErrorSummary:
    """Overall and per-variable combined error norms."""

    def __init__(
        self,
        dt_used: float,
        time_series_data: ErrorTimeSeries,
        variable_names: List[str],
        integral_vars: List[str],
    ):
        self.dt_used = dt_used
        self.variable_names = list(variable_names)
        self.integral_vars = list(integral_vars)
        self.series = time_series_data
        self.overall_combined_error: float = calculate_combined_error_norm(
            time_series_data, dt_used, self.integral_vars
        )
        self.per_variable_sup_errors: Dict[str, float] = {}
        for var in self.variable_names:
            ivars = [var] if var in self.integral_vars else []
            self.per_variable_sup_errors[var] = calculate_combined_error_norm(
                time_series_data, dt_used, integral_vars=ivars, all_variables=[var]
            )

    def __repr__(self):
        per_var = {k: f"{v:.4e}" for k, v in self.per_variable_sup_errors.items()}
        return (
            f"NumericalErrorSummary(dt={self.dt_used:.2e}, "
            f"OverallCombinedError={self.overall_combined_error:.4e}, "
            f"PerVariableSupErrors={per_var})"
        )


class MMSTrial:
    """One-call assembly of grid + model + MMS case + forcing + field +
    integrator.  The grid fixes the device and dtype of the whole trial."""

    def __init__(
        self,
        grid: Grid,
        model,
        mms_case_cls: Type,
        field_cls: Type,
        forcing_terms_cls: Type,
        integrator_cls: Type,
        mms_case_params: Optional[Dict] = None,
        integrator_params: Optional[Dict] = None,
        forcing_terms_params: Optional[Dict] = None,
        field_params: Optional[Dict] = None,
        variable_names: Optional[List[str]] = None,
        integral_vars: Optional[List[str]] = None,
        ops: Ops = LOCAL_OPS,
    ):
        self.grid = grid
        self.model = model
        self.ops = ops
        self.variable_names = list(variable_names or ALL_VARIABLES)
        self.integral_vars = list(integral_vars or DEFAULT_INTEGRAL_VARS)

        self.mms_case = mms_case_cls(grid=grid, model=model, **(mms_case_params or {}))
        self.forcing_terms = forcing_terms_cls(
            mms_case=self.mms_case, model=model, **(forcing_terms_params or {})
        )
        self.field = field_cls(
            grid=grid, model=model, forcing=self.forcing_terms, **(field_params or {})
        )
        self.integrator = integrator_cls(
            semi_discrete_field=self.field, **(integrator_params or {})
        )
        self.initial_state = state_from_mms_when(mms_case=self.mms_case, t=0.0, grid=grid)

    def run_for_errors(self, Tf: float, dt: float, t0: float = 0.0) -> NumericalErrorSummary:
        series, dt_adj = run_simulation_collect_data(
            grid=self.grid,
            integrator=self.integrator,
            exact_sol_pack=self.mms_case,
            initial_state=self.initial_state,
            Tf=Tf,
            dt=dt,
            t0=t0,
            variable_names=self.variable_names,
            integral_vars=self.integral_vars,
            ops=self.ops,
        )
        return NumericalErrorSummary(
            dt_used=dt_adj,
            time_series_data=series,
            variable_names=self.variable_names,
            integral_vars=self.integral_vars,
        )
