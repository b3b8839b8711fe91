"""MMS trial harness: whole-simulation execution and error summaries
(counterpart of :mod:`na_dd_tpu.harness.trial`).

The JAX package runs every step inside one ``lax.scan``.  Here the time loop
is a Python loop over eager device work; the per-step error norms and solver
diagnostics stay in device tensors and reach the host in ONE transfer after
the last step — no ``.item()``, ``bool()`` or ``float()`` inside the loop.
The error functional (combined max-integral norm with trapezoidal time
integration) is the reference's.

Two production options of the JAX package's harness:

* ``collect_precompute`` (time tables): the exact MMS state and the five
  state-independent forcing terms are evaluated once at every grid time
  ``t0 + j·dt`` (:func:`build_time_tables`) and the loop only reads them;
  the tables are kept on the integrator per (grid, case, ops, steps, t0,
  dt) so that a later run of the same level builds nothing;
* ``collect_tail="f32"``: the per-step error norms downcast the f64 error
  ``s − exact`` and run their products, gradient and weights in float32,
  the sums accumulated back in float64.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import warnings
from typing import Dict, List, NamedTuple, Optional, Type

import numpy as np
import torch

from na_dd_tpu_torch.core.forcing import ForcingFromTimeGrid
from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.integrators.pc_trapezoidal import HCsCorrectorPositivityError
from na_dd_tpu_torch.mms.engine import state_from_mms_when
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


#: byte budget of the time tables (exact states and forcing, ``collect_precompute``)
TIME_TABLES_BUDGET = 4_000_000_000


def __getattr__(name):
    # choose_krylov_unroll lives in harness.studies, which imports this module
    if name == "choose_krylov_unroll":
        from na_dd_tpu_torch.harness.studies import choose_krylov_unroll

        return choose_krylov_unroll
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _error_norms(
    g: Grid, ops: Ops, s: State, exact: State, variable_names, integral_vars,
    tail_grid: Optional[Grid] = None,
):
    """Squared error norms of ``s`` against ``exact``, as 0-d tensors (on a
    batch of states with a batched ops provider, one each a system, (B, 1, 1)).

    ``tail_grid``: a downcast copy of ``g`` (:func:`_tail_grid`).  With it
    the error ``s − exact`` is still formed in the working dtype (a
    cancellation of O(1) values), then downcast; the products, the gradient
    of the error, grad(err), and the weights run in the tail's dtype, and
    each sum is taken back in the working dtype.  Without it the gradient
    term is grad(s) − grad(exact), as the reference computes it."""
    h_sq = {}
    grad_sq = {}
    for var in variable_names:
        err = getattr(s, var) - getattr(exact, var)
        if tail_grid is not None:
            gt = tail_grid
            e = err.to(gt.w_H.dtype)
            h_sq[var] = ops.asum((e * e * gt.w_H).to(err.dtype))
            if var in integral_vars:
                ex, ey = stencils.grad_H(ops, gt, e)
                grad_sq[var] = ops.asum((ex * ex * gt.w_pk).to(err.dtype)) + ops.asum(
                    (ey * ey * gt.w_hp).to(err.dtype)
                )
            else:
                grad_sq[var] = torch.zeros_like(h_sq[var])
            continue
        h_sq[var] = inner_products.inner_H(ops, g, err, err)
        if var in integral_vars:
            gx_n, gy_n = stencils.grad_H(ops, g, getattr(s, var))
            gx_e, gy_e = stencils.grad_H(ops, g, getattr(exact, var))
            ex, ey = gx_n - gx_e, gy_n - gy_e
            grad_sq[var] = inner_products.inner_p(ops, g, ex, ey, ex, ey)
        else:
            grad_sq[var] = torch.zeros_like(h_sq[var])
    return h_sq, grad_sq


def _collect_errors(
    g: Grid, ops: Ops, mms_case, s: State, t, variable_names, integral_vars,
    tail_grid: Optional[Grid] = None,
):
    """Per-step squared error norms against the exact MMS solution at t."""
    exact = state_from_mms_when(mms_case=mms_case, t=t, grid=g)
    return _error_norms(g, ops, s, exact, variable_names, integral_vars, tail_grid=tail_grid)


def _tail_grid(g: Grid, dtype) -> Grid:
    """``g`` with every floating tensor downcast to ``dtype`` (geometry
    unchanged)."""
    return dataclasses.replace(g, **{
        f.name: getattr(g, f.name).to(dtype)
        for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), torch.Tensor) and getattr(g, f.name).is_floating_point()
    })


def build_time_tables(*, grid: Grid, forcing, exact_sol_pack, ops: Ops, t0: float, dt: float,
                      num: int):
    """The time tables of a run of ``num`` steps from ``t0``: a bound
    :class:`ForcingFromTimeGrid` of ``forcing``, and the exact MMS state at
    the ``num + 1`` grid times ``t0 + j·dt`` as a State of (num+1, *plane)
    tensors.  Each time is one evaluation, run once."""
    ts = t0 + dt * torch.arange(num + 1, dtype=grid.dtype, device=grid.device)
    exact = [state_from_mms_when(mms_case=exact_sol_pack, t=ts[j], grid=grid)
             for j in range(num + 1)]
    tabled = ForcingFromTimeGrid(forcing, t0=t0, dt=dt, num=num)
    tabled.bind(tabled.build_tables(grid, ops))
    return tabled, State(*(torch.stack(v) for v in zip(*exact)))


def _with_forcing(integrator, forcing):
    """A shallow copy of ``integrator`` whose field (a shallow copy too)
    has ``forcing``."""
    field = copy.copy(integrator.semi_discrete_field)
    field.forcing = forcing
    integrator = copy.copy(integrator)
    integrator.semi_discrete_field = field
    return integrator


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


def _tabled_run(*, grid, integrator, exact_sol_pack, ops, t0, dt, num_steps):
    """``(integrator copy with the tabled forcing, exact-state stack)`` of a
    run, the tables from the integrator's cache or built into it; ``(the
    integrator, None)`` when the tables, 2 × 5 fields × (num_steps+1)
    planes, would exceed :data:`TIME_TABLES_BUDGET` bytes."""
    est_bytes = 2 * (num_steps + 1) * 5 * grid.xx.numel() * grid.xx.element_size()
    if est_bytes > TIME_TABLES_BUDGET:
        return integrator, None
    cache = getattr(integrator, "_sim_cache", None)
    if cache is None:
        cache = integrator._sim_cache = {}
    key = (id(grid), id(exact_sol_pack), id(ops), num_steps, float(t0), float(dt))
    entry = cache.get(key)
    if entry is None:
        # the objects are kept with the tables, so their ids stay theirs
        entry = cache[key] = (grid, exact_sol_pack, ops) + build_time_tables(
            grid=grid, forcing=integrator.semi_discrete_field.forcing,
            exact_sol_pack=exact_sol_pack, ops=ops, t0=t0, dt=dt, num=num_steps,
        )
    return _with_forcing(integrator, entry[3]), entry[4]


def _simulate(*, grid, integrator, exact_sol_pack, exact_stack, initial_state, t0, dt,
              num_steps, variable_names, integral_vars, ops, tail_grid, nsys=1):
    """The time loop of :func:`run_simulation_collect_data`, on the device:
    ``num_steps`` steps from ``initial_state`` with the error norms after
    each (against ``exact_stack[k]`` where the time tables are given, else
    the MMS case at t_k), packed into one float64 tensor — the squared H
    and gradient norms, (2·vars, num_steps+1, nsys), then the diagnostics
    [hcs_ok, converged, resnorm_sq, iters], (4, num_steps, nsys), one column
    a system of a batch (``nsys`` systems: a batched state, ops provider
    and ``dt``; see :mod:`na_dd_tpu_torch.harness.batched_ladder`).  Never
    synchronises with the host."""
    dtype, device = grid.dtype, grid.device
    ks = torch.arange(num_steps, dtype=dtype, device=device)

    def column(v):
        """A value of one system, or one a system, as (nsys,)."""
        return v.reshape(-1).expand(nsys)

    def norms_row(s, t, k):
        """Error norms of the state after k steps, at time t."""
        if exact_stack is not None:
            exact = State(*(a[k] for a in exact_stack))
            h_sq, grad_sq = _error_norms(
                grid, ops, s, exact, variable_names, integral_vars, tail_grid=tail_grid
            )
        else:
            h_sq, grad_sq = _collect_errors(
                grid, ops, exact_sol_pack, s, t, variable_names, integral_vars,
                tail_grid=tail_grid,
            )
        return [h_sq[v] for v in variable_names] + [grad_sq[v] for v in variable_names]

    # a fill, not a copy from the host (which would synchronise)
    rows = [norms_row(initial_state, torch.full((), t0, dtype=dtype, device=device), 0)]
    small = []
    s = initial_state
    for k in range(num_steps):
        t_k = t0 + ks[k] * dt
        s, diag = _step_with_diagnostics(integrator, grid, ops, s, t_k, dt)
        rows.append(norms_row(s, t_k + dt, k + 1))
        small.append(diag)
    norms = torch.stack(
        [torch.stack([column(v) for v in r]) for r in rows], dim=1
    ).to(torch.float64)
    diags = torch.stack(
        [torch.stack([column(v.to(torch.float64)) for v in r]) for r in small], dim=1
    )
    return torch.cat([norms.reshape(-1), diags.reshape(-1)])


def _unpack(packed: np.ndarray, nv: int, num_steps: int, nsys: int = 1):
    """(norms (2·nv, num_steps+1, nsys), diagnostics (4, num_steps, nsys))
    of a :func:`_simulate` result on the host."""
    n_norms = 2 * nv * (num_steps + 1) * nsys
    return (
        packed[:n_norms].reshape(2 * nv, num_steps + 1, nsys),
        packed[n_norms:].reshape(4, num_steps, nsys),
    )


def _concat_packed(packs, nv: int, num_steps: int, sizes) -> np.ndarray:
    """One :func:`_simulate` result for the systems of consecutive parts of
    a batch, from each part's packed result on the host (``sizes`` the
    parts' system counts): the parts' columns side by side, in order."""
    if len(packs) == 1:
        return packs[0]
    parts = [_unpack(p, nv, num_steps, n) for p, n in zip(packs, sizes)]
    norms = np.concatenate([m for m, _ in parts], axis=-1)
    diags = np.concatenate([d for _, d in parts], axis=-1)
    return np.concatenate([norms.reshape(-1), diags.reshape(-1)])


def _error_series(mats, diags, variable_names, t0: float, dt: float) -> ErrorTimeSeries:
    """One system's :class:`ErrorTimeSeries` from its norms (2·nv, K+1) and
    diagnostics (4, K); raises :class:`HCsCorrectorPositivityError` if a
    step lost the HCs corrector's positivity, and warns if a Krylov solve
    missed its tolerance."""
    nv = len(variable_names)
    num_steps = diags.shape[1]
    hcs_ok, converged, resnorm_sq, iters = diags
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
            stacklevel=3,
        )
    return ErrorTimeSeries(
        t=t0 + dt * np.arange(num_steps + 1),
        h_norm_sq_errors={v: mats[i] for i, v in enumerate(variable_names)},
        grad_h_norm_p_sq_errors={v: mats[nv + i] for i, v in enumerate(variable_names)},
        krylov_iters=iters.astype(np.int64),
        krylov_converged=converged > 0.5,
    )


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
    collect_tail: Optional[str] = None,
    collect_precompute: bool = False,
):
    """Run from t0 to Tf collecting per-step error norms.

    Returns (ErrorTimeSeries, dt_adjusted); dt is adjusted so that
    num_steps·dt == Tf − t0 exactly.

    collect_tail: None, or "f32" (also "float32") for the float32 norm tail
    of :func:`_error_norms`; a no-op on a float32 grid.
    collect_precompute: read the exact states and the forcing from time
    tables (:func:`build_time_tables`) instead of evaluating them each step;
    taken only while the tables' bytes, 2 × 5 fields × (num_steps+1)
    planes, stay within :data:`TIME_TABLES_BUDGET`.  The tables are cached on the
    integrator (``_sim_cache``), keyed by the grid, case, ops, step count,
    t0 and dt of the run.
    """
    if collect_tail is not None and collect_tail not in ("f32", "float32"):
        raise ValueError(f"collect_tail must be None or 'f32'; got {collect_tail!r}")
    if collect_tail and grid.dtype == torch.float32:
        collect_tail = None  # nothing narrower to downcast to
    num_steps = math.ceil((Tf - t0) / dt)
    dt_adj = (Tf - t0) / num_steps
    variable_names = tuple(variable_names)
    integral_vars = tuple(integral_vars)
    integrator_run, exact_stack = _tabled_run(
        grid=grid, integrator=integrator, exact_sol_pack=exact_sol_pack, ops=ops, t0=t0,
        dt=dt_adj, num_steps=num_steps,
    ) if collect_precompute else (integrator, None)
    # the run's only host transfer
    packed = _simulate(
        grid=grid, integrator=integrator_run, exact_sol_pack=exact_sol_pack,
        exact_stack=exact_stack, initial_state=initial_state, t0=t0, dt=dt_adj,
        num_steps=num_steps, variable_names=variable_names, integral_vars=integral_vars,
        ops=ops, tail_grid=_tail_grid(grid, torch.float32) if collect_tail else None,
    ).cpu().numpy()
    mats, diags = _unpack(packed, len(variable_names), num_steps)
    return _error_series(mats[..., 0], diags[..., 0], variable_names, t0, dt_adj), dt_adj


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

    def run_for_errors(
        self,
        Tf: float,
        dt: float,
        t0: float = 0.0,
        *,
        collect_tail: Optional[str] = None,
        collect_precompute: bool = False,
    ) -> NumericalErrorSummary:
        """The run's combined error summary; ``collect_tail`` and
        ``collect_precompute`` as in :func:`run_simulation_collect_data`."""
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
            collect_tail=collect_tail,
            collect_precompute=collect_precompute,
        )
        return NumericalErrorSummary(
            dt_used=dt_adj,
            time_series_data=series,
            variable_names=self.variable_names,
            integral_vars=self.integral_vars,
        )
