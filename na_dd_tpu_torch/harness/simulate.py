"""Production simulation: the physical model from real initial
conditions, with no manufactured solution (counterpart of
:mod:`na_dd_tpu.harness.simulate`).

* :func:`make_integrator` — field and PC integrator of a reaction variant
  with no forcing (or a forcing of the caller's);
* :func:`simulate` — ``num_steps`` steps, every ``snapshot_every``-th state
  stacked on the device;
* :func:`simulate_adaptive` — accept/reject step control to ``Tf``;
* :func:`released_drug_fraction`, :func:`dissolved_drug_fraction` — the
  drug-delivery observables.

The JAX package runs each loop inside one ``lax.scan`` or ``while_loop``
program.  Here the loop is a Python loop over eager device work: the states
stay on the device, and :func:`simulate` makes no host transfer at all.
Every function takes the device of the grid and the state it is given
(``make_uniform_grid(N, N)`` is on the card; ``device="cpu"`` for the CPU).
The loops are dimension-agnostic: a 3-D integrator
(:func:`na_dd_tpu_torch.three_d.harness.make_integrator3`) runs through them
unchanged, with its own ops provider by default.
"""

from __future__ import annotations

from typing import Optional

import torch

from na_dd_tpu_torch.core.fields import FieldCsTriple, FieldHCsTriple, FieldRegHCsTriple
from na_dd_tpu_torch.core.forcing import NoForcing
from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.integrators.pc_trapezoidal import (
    PCTrapezoidalCsTriple,
    PCTrapezoidalHCsTriple,
    PCTrapezoidalRegHCsTriple,
)
from na_dd_tpu_torch.ops.grid import Grid
from na_dd_tpu_torch.ops.inner_products import inner_H, norm_H
from na_dd_tpu_torch.ops.shifts import Ops

_VARIANTS = {
    "cstriple": (FieldCsTriple, PCTrapezoidalCsTriple),
    "hcstriple": (FieldHCsTriple, PCTrapezoidalHCsTriple),
    "reghcstriple": (FieldRegHCsTriple, PCTrapezoidalRegHCsTriple),
}


def make_integrator(
    grid: Grid,
    model,
    *,
    variant: str = "reghcstriple",
    regularization_factor=50.0,
    forcing=None,
    **integrator_params,
):
    """Field and PC integrator of ``variant`` with a physical forcing (none
    by default: the homogeneous model), a Krylov budget of 24 unless
    ``integrator_params`` says otherwise, and no residual tracking.
    ``regularization_factor`` may be a tensor (it reaches the field and the
    corrector as given)."""
    field_cls, integ_cls = _VARIANTS[variant]
    field_kwargs = dict(grid=grid, model=model, forcing=forcing if forcing is not None else NoForcing())
    integ_kwargs = dict(krylov_unroll=24)
    integ_kwargs.update(integrator_params)
    if variant == "reghcstriple":
        field_kwargs["regularization_factor"] = regularization_factor
        integ_kwargs["regularization_factor"] = regularization_factor
    return integ_cls(field_cls(**field_kwargs), track_residuals=False, **integ_kwargs)


def _state_of(out) -> State:
    """The state of a ``step_fn`` result: ``(State, diagnostics)``, or a
    bare State (forward Euler)."""
    return out if isinstance(out, State) else out[0]


def simulate(
    integrator,
    grid,
    state0: State,
    *,
    t0: float = 0.0,
    dt: float,
    num_steps: int,
    snapshot_every: Optional[int] = None,
    ops: Optional[Ops] = None,
):
    """Integrate ``num_steps`` steps from ``state0``; returns ``(final_state,
    times, snapshots)``.

    ``snapshots`` (None without ``snapshot_every``) is a State of tensors
    with a leading time axis holding every ``snapshot_every``-th state, and
    ``times`` their times ``t0 + dt·k``.  Step k runs at ``t0 + k·dt``, k a
    float tensor on the device, as in the JAX package's scan.  ``ops``
    defaults to the integrator's own provider (2-D or 3-D).  No host
    synchronisation inside the loop.
    """
    if snapshot_every is not None and num_steps % snapshot_every != 0:
        raise ValueError("num_steps must be divisible by snapshot_every")
    ops = integrator._local_ops if ops is None else ops
    dtype, device = state0.T.dtype, state0.T.device
    ks = torch.arange(num_steps, dtype=dtype, device=device)
    s, snaps = state0, []
    for k in range(num_steps):
        s = _state_of(integrator.step_fn(grid, ops, s, t0 + ks[k] * dt, dt))
        if snapshot_every is not None and (k + 1) % snapshot_every == 0:
            snaps.append(s)
    if snapshot_every is None:
        return s, None, None
    n_snaps = num_steps // snapshot_every
    times = t0 + dt * (torch.arange(1, n_snaps + 1, dtype=dtype, device=device) * snapshot_every)
    return s, times, State(*(torch.stack(v) for v in zip(*snaps)))


def simulate_adaptive(
    integrator,
    grid,
    state0: State,
    *,
    t0: float = 0.0,
    Tf: float,
    dt0: float,
    tol: float = 1e-6,
    safety: float = 0.9,
    growth_min: float = 0.2,
    growth_max: float = 5.0,
    dt_min: float = 1e-12,
    max_steps: int = 100_000,
    ops: Optional[Ops] = None,
):
    """Integrate to ``Tf`` with adaptive steps; returns ``(final_state,
    info)`` with ``info = dict(steps, rejected, t, dt)``.

    The error estimate is the forward-Euler embedded solution ``u0 +
    dt·F(u0, t)``: ``est = Σ_v ‖u_PC − u_FE‖_H / (1 + ‖u_PC‖_H)`` measures
    the Euler local error ~C·dt², and ``dt ← dt·clip(safety·(tol/est)^½,
    growth_min, growth_max)`` after every attempt; a step with ``est > tol``
    is redone (unless ``dt`` is at ``dt_min``).  t and dt stay 0-d device
    tensors.  The JAX package runs the loop as one ``while_loop``; here it is
    a Python loop whose only host synchronisation is one boolean a step,
    accepted or rejected: whether to go on (not yet at ``Tf`` and fewer than
    ``max_steps`` accepted steps).  With fused analytic couplings the triple
    solve kernel also takes ``dt`` as a host scalar, one more read a step.
    """
    ops = integrator._local_ops if ops is None else ops
    field = integrator.semi_discrete_field
    g = grid
    dtype, device = state0.T.dtype, state0.T.device
    s = state0
    t = torch.full((), t0, dtype=dtype, device=device)
    dt = torch.full((), dt0, dtype=dtype, device=device)
    k = torch.zeros((), dtype=torch.int64, device=device)
    rej = torch.zeros((), dtype=torch.int64, device=device)
    go = not Tf <= t0
    while go:
        dt_try = torch.minimum(dt, Tf - t)
        s1, _diag = integrator.step_fn(g, ops, s, t, dt_try)
        fe = State(*(u + dt_try * f * g.interior_mask
                     for u, f in zip(s, field.all_fields(g, ops, s, t))))
        est = sum(norm_H(ops, g, u_pc - u_fe) / (1.0 + norm_H(ops, g, u_pc))
                  for u_pc, u_fe in zip(s1, fe))
        factor = torch.clamp(
            safety * torch.sqrt(tol / torch.clamp_min(est, 1e-300)), growth_min, growth_max
        )
        dt = torch.clamp_min(dt_try * factor, dt_min)
        # at the floor a step is accepted: dt cannot shrink further
        accept = (est <= tol) | (dt_try <= dt_min)
        s = State(*(torch.where(accept, a, b) for a, b in zip(s1, s)))
        t = torch.where(accept, t + dt_try, t)
        k = k + accept.to(k.dtype)
        rej = rej + (~accept).to(rej.dtype)
        go = bool((t < Tf - 1e-15) & (k < max_steps))  # the loop's one host read
    return s, dict(steps=int(k), rejected=int(rej), t=float(t), dt=float(dt))


def released_drug_fraction(ops: Ops, g, state: State, initial: State):
    """Cumulative released drug, ``1 − (∫cs + ∫cd)/(∫cs0 + ∫cd0)`` in the
    discrete H-measure.  The Kd reaction only moves mass between cs and cd,
    so this observable is blind to Kd (up to the small Dd outflux): to fit
    Kd, use :func:`dissolved_drug_fraction`."""
    one = torch.ones_like(state.cs)

    def mass(u):
        return inner_H(ops, g, u, one)

    return 1.0 - (mass(state.cs) + mass(state.cd)) / (mass(initial.cs) + mass(initial.cd))


def dissolved_drug_fraction(ops: Ops, g, state: State):
    """Dissolved fraction ``∫cd / (∫cd + ∫cs)`` in the discrete H-measure,
    O(1)-sensitive to Kd: the observable for calibrating it."""
    one = torch.ones_like(state.cs)
    cd, cs = inner_H(ops, g, state.cd, one), inner_H(ops, g, state.cs, one)
    return cd / (cd + cs)
