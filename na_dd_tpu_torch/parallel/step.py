"""Sharded whole steps and whole simulations (counterpart of
:mod:`na_dd_tpu.parallel.step`).

The physics (fields, integrators, Krylov solves, error norms) is written
against the shift/sum ops protocol, so sharding it is a matter of running it
on every rank of a process group with :class:`HaloOps` in place of the local
ops: the halos travel between neighbour ranks and every reduction (the
Krylov dot products, the verdicts, the error norms) becomes an all-reduce.
The Krylov solves become the all-reduced BiCGStab whose matvec is K2 on the
halo-padded block; ``linear_solver="direct"`` runs replicated (gather, solve
the full grid on every rank, slice).  No algorithmic change: the sharded
step equals the local one up to the order of the sums.

Each ``build_*`` returns a callable that every rank calls with its own block
(:func:`na_dd_tpu_torch.parallel.sharding.shard_grid_and_state`); every
scalar it returns is built from the ops' all-reduced reductions, so all
ranks hold the same value and take the same branches.
"""

from __future__ import annotations

import torch

from na_dd_tpu_torch.parallel.halo import HaloOps


def _small(diag):
    """The step's scalar diagnostics, as the JAX package's ``_scan_step``
    names them."""
    return {
        "hcs_ok": diag[0],
        "krylov_converged": diag[1],
        "krylov_resnorm_sq": diag[2],
        "krylov_iters": diag[3],
    }


def build_sharded_step(integrator, mesh, *, axis_x="x", axis_y=None):
    """``step(grid_block, state_block, t, dt) -> (state_block', small)``
    with ``small`` the scalar diagnostics (``hcs_ok``, ``krylov_iters``,
    ``krylov_resnorm_sq``, ``krylov_converged``), equal on every rank.  The
    ops provider is ``step.ops`` (its ``stats`` count the traffic)."""
    from na_dd_tpu_torch.harness.trial import _step_with_diagnostics

    hops = HaloOps(mesh, axis_x=axis_x, axis_y=axis_y)

    def step(g, s, t, dt):
        t = torch.as_tensor(t, dtype=g.dtype, device=g.device)
        s1, diag = _step_with_diagnostics(integrator, g, hops, s, t, dt)
        return s1, _small(diag)

    step.ops = hops
    return step


def simulate_with_errors(integrator, g, ops, s0, *, mms_case, num_steps: int, t0: float,
                         dt: float, variable_names=("cp", "T", "cl", "cd", "cs"),
                         integral_vars=("T", "cl", "cd")):
    """``num_steps`` steps of ``integrator`` from ``s0`` at ``t0`` on the
    grid ``g`` (a block with a halo-exchange ``ops``, or a whole grid with
    the local ops) with the per-step error norms of the JAX package's
    ``_collect_errors`` after each: ``(final state, (h0, g0, (h_sq,
    grad_sq, small)))``, ``h0``/``g0`` {var: 0-d tensor} of the initial
    state, ``h_sq``/``grad_sq`` {var: (num_steps,)} and ``small`` {name:
    (num_steps,)}.  Nothing reads a device value on the host."""
    from na_dd_tpu_torch.harness.trial import _collect_errors, _step_with_diagnostics

    variable_names, integral_vars = tuple(variable_names), tuple(integral_vars)
    ks = torch.arange(num_steps, dtype=g.dtype, device=g.device)
    h0, g0 = _collect_errors(
        g, ops, mms_case, s0, torch.full((), t0, dtype=g.dtype, device=g.device),
        variable_names, integral_vars,
    )
    rows_h, rows_g, rows_small = [], [], []
    s = s0
    for k in range(num_steps):
        t_k = t0 + ks[k] * dt
        s, diag = _step_with_diagnostics(integrator, g, ops, s, t_k, dt)
        h_sq, grad_sq = _collect_errors(g, ops, mms_case, s, t_k + dt, variable_names,
                                        integral_vars)
        rows_h.append(h_sq)
        rows_g.append(grad_sq)
        rows_small.append(_small(diag))

    def stack(rows):
        return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}

    return s, (h0, g0, (stack(rows_h), stack(rows_g), stack(rows_small)))


def build_sharded_simulation(
    integrator,
    mesh,
    *,
    mms_case,
    num_steps: int,
    t0: float,
    dt: float,
    variable_names=("cp", "T", "cl", "cd", "cs"),
    integral_vars=("T", "cl", "cd"),
    axis_x="x",
    axis_y=None,
):
    """``sim(grid_block, state0_block) -> (state_block_final, (h0, g0, (h_sq,
    grad_sq, small)))``: :func:`simulate_with_errors` on this rank's block,
    every returned error and diagnostic equal on every rank, as the JAX
    function returns them.  The ops provider is ``sim.ops``."""
    hops = HaloOps(mesh, axis_x=axis_x, axis_y=axis_y)

    def sim(g, s0):
        return simulate_with_errors(
            integrator, g, hops, s0, mms_case=mms_case, num_steps=num_steps, t0=t0, dt=dt,
            variable_names=variable_names, integral_vars=integral_vars,
        )

    sim.ops = hops
    return sim
