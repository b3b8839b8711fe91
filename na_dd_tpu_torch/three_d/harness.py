"""3-D MMS trial harness (counterpart of :mod:`na_dd_tpu.three_d.harness`):
the Cs, HCs and RegHCs variants (``make_setup3(..., variant=...)``) and the
forcing-free integrator of :func:`make_integrator3`.

The JAX package runs the whole simulation as one ``lax.scan``.  Here the
time loop is a Python loop over eager device work that carries the same
accumulators as the scan body — the running worst combined error, the
trapezoidal gradient integral and the previous step's gradient term — in
device tensors; :func:`run_trial3` moves the scalars to the host in ONE
transfer after the last step.  The error is the reference's combined
max-integral norm

    max_k sqrt( Σ_v ||e_v(t_k)||_H² + ∫₀^{t_k} Σ_{v∈integral} ||∇e_v||_p² dτ )

with the gradient taken of the error e_v itself, as the JAX 3-D harness
does (not the 2-D harness's difference of gradients).

:func:`run_eta_sweep3` runs every η of a sweep in one batch: the state is
the stack of the runs', η an (E, 1, 1, 1) tensor, the reductions per run
(:data:`~na_dd_tpu_torch.three_d.shifts.BATCHED_OPS3`), and each Newton
solve one launch of the batched kernel.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.integrators.pc_trapezoidal import HCsCorrectorPositivityError
from na_dd_tpu_torch.three_d.fields import FieldCsTriple3, FieldHCsTriple3, FieldRegHCsTriple3
from na_dd_tpu_torch.three_d.forcing import (
    MMSForcingCsTriple3,
    MMSForcingHCsTriple3,
    MMSForcingRegHCsTriple3,
    NoForcing3,
)
from na_dd_tpu_torch.three_d.grid import Grid3, make_uniform_grid3
from na_dd_tpu_torch.three_d.inner_products import inner_H3, inner_p3
from na_dd_tpu_torch.three_d.integrator import (
    PCTrapezoidalCsTriple3,
    PCTrapezoidalHCsTriple3,
    PCTrapezoidalRegHCsTriple3,
)
from na_dd_tpu_torch.three_d.mms import state_from_mms_when3
from na_dd_tpu_torch.three_d.shifts import BATCHED_OPS3, LOCAL_OPS3, Ops3
from na_dd_tpu_torch.three_d.stencils import grad_H3

#: BiCGStab iteration budget per 3-D solve (masked early exit), the budget of
#: the JAX package's ``make_integrator3`` and ``run_eta_sweep3``
KRYLOV_BUDGET3 = 24


_VARIANTS = {
    "cs": (FieldCsTriple3, MMSForcingCsTriple3, PCTrapezoidalCsTriple3),
    "hcs": (FieldHCsTriple3, MMSForcingHCsTriple3, PCTrapezoidalHCsTriple3),
    "reghcs": (FieldRegHCsTriple3, MMSForcingRegHCsTriple3, PCTrapezoidalRegHCsTriple3),
}


def make_setup3(
    case_cls,
    *,
    model,
    N: int | None = None,
    variant: str = "reghcs",
    eta: float = 50.0,
    grid: Grid3 | None = None,
    case_params: Dict | None = None,
    integrator_params: Dict | None = None,
    dtype=None,
    device=None,
):
    """Assemble (grid, case, field, integrator) for a 3-D MMS trial of the
    ``variant`` "cs", "hcs" or "reghcs" (``eta`` is the regularization factor
    of the last).

    Exactly one of ``N`` (uniform N³ grid in ``dtype`` on ``device``) or
    ``grid`` must be given.  The integrator takes ``integrator_params`` and
    nothing else, as in the JAX package: with none, the integrator's defaults
    (the while form, residual tracking on); the studies pass
    ``krylov_unroll=KRYLOV_BUDGET3, track_residuals=False``.
    """
    if (N is None) == (grid is None):
        raise ValueError("pass exactly one of N (uniform grid) or grid")
    field_cls, forcing_cls, integ_cls = _VARIANTS[variant]
    g = grid if grid is not None else make_uniform_grid3(N, N, N, dtype=dtype, device=device)
    case = case_cls(g, model, **(case_params or {}))
    reg = dict(regularization_factor=eta) if variant == "reghcs" else {}
    forcing = forcing_cls(mms_case=case, model=model, **reg)
    field = field_cls(grid=g, model=model, forcing=forcing, **reg)
    integ = integ_cls(field, **reg, **(integrator_params or {}))
    return g, case, field, integ


def make_integrator3(
    grid: Grid3,
    model,
    *,
    variant: str = "reghcs",
    regularization_factor: float = 50.0,
    forcing=None,
    **integrator_params,
):
    """Field and 3-D PC integrator of ``variant`` with a physical forcing
    (none by default), a Krylov budget of :data:`KRYLOV_BUDGET3` and no
    residual tracking."""
    field_cls, _forcing_cls, integ_cls = _VARIANTS[variant]
    field_kwargs = dict(grid=grid, model=model, forcing=forcing if forcing is not None else NoForcing3())
    integ_kwargs = dict(krylov_unroll=KRYLOV_BUDGET3)
    integ_kwargs.update(integrator_params)
    if variant == "reghcs":
        field_kwargs["regularization_factor"] = regularization_factor
        integ_kwargs["regularization_factor"] = regularization_factor
    return integ_cls(field_cls(**field_kwargs), track_residuals=False, **integ_kwargs)


def err_sq3(ops: Ops3, g: Grid3, case, s: State, t, integral_vars=("T", "cl", "cd")):
    """(Σ_v ||e_v||_H², Σ_{v∈integral} ||∇e_v||_p², per-var H²) of ``s``
    against the exact solution at ``t``; one value a system with a batched
    ops provider."""
    ex = state_from_mms_when3(mms_case=case, t=t, grid=g)
    total = 0.0
    grad_total = 0.0
    per_var = {}
    for v in State._fields:
        e = getattr(s, v) - getattr(ex, v)
        sq = inner_H3(ops, g, e, e)
        per_var[v] = sq
        total = total + sq
        if v in integral_vars:
            gx, gy, gz = grad_H3(ops, g, e)
            grad_total = grad_total + inner_p3(ops, g, gx, gy, gz, gx, gy, gz)
    return total, grad_total, per_var


def build_runner3(
    g: Grid3,
    case,
    integ,
    *,
    Tf: float,
    dt: float,
    ops: Ops3 = LOCAL_OPS3,
    t0: float = 0.0,
    integral_vars=("T", "cl", "cd"),
):
    """Build the whole-simulation runner.

    Returns ``(run, s0)``: ``run(s0)`` steps from ``s0`` at ``t0`` to the
    absolute final time ``Tf`` in equal steps and returns ``(final State,
    worst combined err², all-solves-converged flag, HCs-positivity flag,
    {var: final H err²})``, every value a device tensor (one a run, with a
    batched state and ops provider).  ``run`` may be called again for warm
    timings.
    """
    num_steps = max(1, int(math.ceil((Tf - t0) / dt)))
    dt_adj = (Tf - t0) / num_steps
    s0 = state_from_mms_when3(mms_case=case, t=t0, grid=g)

    def err_sq(s: State, t):
        return err_sq3(ops, g, case, s, t, integral_vars)

    def run(s):
        ks = torch.arange(num_steps, dtype=g.dtype, device=g.device)
        # the initial state is the exact solution: both terms start at 0
        worst, prev_grad, _ = err_sq(s, t0)
        integral = torch.zeros_like(worst)
        ok = torch.ones((), dtype=torch.bool, device=g.device)
        hcs_ok = torch.ones((), dtype=torch.bool, device=g.device)
        for k in range(num_steps):
            t_k = t0 + ks[k] * dt_adj
            s, diag = integ.step_fn(g, ops, s, t_k, dt_adj)
            tot, grad_sq, _ = err_sq(s, t_k + dt_adj)
            # trapezoidal ∫||∇e||² (reference mms_trial_utils.py:40-49)
            integral = integral + 0.5 * dt_adj * (prev_grad + grad_sq)
            worst = torch.maximum(worst, tot + integral)
            ok = ok & diag.krylov_converged
            hcs_ok = hcs_ok & diag.hcs_denominator_ok
            prev_grad = grad_sq
        _, _, per_var = err_sq(s, Tf)
        return s, worst, ok, hcs_ok, per_var

    return run, s0


def run_trial3(
    g: Grid3,
    case,
    integ,
    *,
    Tf: float,
    dt: float,
    ops: Ops3 = LOCAL_OPS3,
    t0: float = 0.0,
    integral_vars=("T", "cl", "cd"),
):
    """Run the whole simulation and return ``{"error": the combined
    max-integral norm, "errors_final": per-var final H errors, "state": the
    final State, "krylov_converged": all-solves flag}``.  Raises
    :class:`HCsCorrectorPositivityError` if the corrector lost positivity."""
    run, s0 = build_runner3(
        g, case, integ, Tf=Tf, dt=dt, ops=ops, t0=t0, integral_vars=integral_vars
    )
    s_fin, worst, ok, hcs_ok, per_var = run(s0)
    # the run's only host transfer
    packed = torch.stack(
        [t.to(torch.float64) for t in (worst, ok, hcs_ok, *per_var.values())]
    ).cpu()
    worst_h, ok_h, hcs_h = (float(v) for v in packed[:3])
    if hcs_h < 0.5:
        raise HCsCorrectorPositivityError(
            "Denominator 2 - dt Kd (Sd - Cd1) (1 + Cl1) below positiveness threshold."
        )
    return {
        "error": math.sqrt(worst_h),
        "errors_final": {
            v: math.sqrt(float(sq)) for v, sq in zip(per_var, packed[3:])
        },
        "state": s_fin,
        "krylov_converged": ok_h > 0.5,
    }


def run_eta_sweep3(
    case_cls,
    *,
    model,
    N: int,
    Tf: float,
    dt: float,
    etas,
    krylov_unroll: int = KRYLOV_BUDGET3,
    dtype=None,
    device=None,
):
    """The regularization-factor sweep of the 3-D study with every η in one
    batch (the 2-D twin is ``run_eta_study_batched``): the RegHCs trial of
    ``case_cls`` on the uniform N³ grid from 0 to ``Tf`` in steps of ``dt``,
    η an (E, 1, 1, 1) tensor through field, forcing and corrector.  Raises
    :class:`HCsCorrectorPositivityError` naming each η whose corrector lost
    positivity.  Returns ``{"etas", "errors", "converged"}``.  More than
    :data:`~na_dd_tpu_torch.ops.kernels.MAX_BATCH` η run as consecutive
    batches of at most that many (the kernels' limit a launch).  On the card
    unless ``device="cpu"``.  The JAX function's ``krylov_scanned`` (an XLA
    compile-time option) has no counterpart here."""
    from na_dd_tpu_torch.ops import kernels

    g = make_uniform_grid3(N, N, N, dtype=dtype, device=device)
    case = case_cls(g, model)
    etas = [float(e) for e in etas]

    def run_part(members):
        eta = torch.tensor(members, dtype=g.dtype, device=g.device).reshape(-1, 1, 1, 1)
        forcing = MMSForcingRegHCsTriple3(mms_case=case, model=model, regularization_factor=eta)
        field = FieldRegHCsTriple3(grid=g, model=model, forcing=forcing,
                                   regularization_factor=eta)
        integ = PCTrapezoidalRegHCsTriple3(
            field, regularization_factor=eta, track_residuals=False, krylov_unroll=krylov_unroll
        )
        run, s0 = build_runner3(g, case, integ, Tf=Tf, dt=dt, ops=BATCHED_OPS3)
        _s, worst, ok, hcs_ok, _per_var = run(
            State(*(v.expand(len(members), *v.shape).contiguous() for v in s0))
        )
        # the part's only host transfer
        return torch.stack(
            [v.to(torch.float64).reshape(-1).expand(len(members)) for v in (worst, ok, hcs_ok)]
        ).cpu()

    step = kernels.MAX_BATCH
    packed = torch.cat([run_part(etas[i:i + step]) for i in range(0, len(etas), step)], dim=1)
    bad = [e for e, h in zip(etas, packed[2].tolist()) if h < 0.5]
    if bad:
        raise HCsCorrectorPositivityError(
            f"HCs corrector denominator lost positivity for eta in {bad}"
        )
    return {
        "etas": etas,
        "errors": [math.sqrt(w) for w in packed[0].tolist()],
        "converged": [o > 0.5 for o in packed[1].tolist()],
    }


def mms_error3(
    case_cls,
    *,
    N: int,
    model,
    Tf: float,
    dt: float,
    variant: str = "reghcs",
    eta: float = 50.0,
    case_params: Dict | None = None,
    integrator_params: Dict | None = None,
    dtype=None,
    device=None,
) -> float:
    """Build the setup and return the combined error of one trial."""
    g, case, _field, integ = make_setup3(
        case_cls,
        N=N,
        model=model,
        variant=variant,
        eta=eta,
        case_params=case_params,
        integrator_params=integrator_params,
        dtype=dtype,
        device=device,
    )
    return run_trial3(g, case, integ, Tf=Tf, dt=dt)["error"]
