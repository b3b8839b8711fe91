"""Batched 3-D spatial ladders: every level padded to the finest level's
volume and run as one batch (counterpart of
:mod:`na_dd_tpu.three_d.batched_ladder`; the 2-D twin is
:mod:`na_dd_tpu_torch.harness.batched_ladder`, with the same padding
argument).

The L levels' grids and states, zero-padded to (N_max+1)³, are stacked into
(L, N_max+1, N_max+1, N_max+1) tensors; dt rides as an (L, 1, 1, 1) tensor;
the reductions go through :data:`~na_dd_tpu_torch.three_d.shifts.BATCHED_OPS3`
(one value a level); every Newton solve of every level is ONE launch of the
batched 7-point BiCGStab kernel.  The loop runs the ladder's longest step
count, and each level's rows past its own step count are dropped on the
host after the run's one transfer.  The 0-sentinel reciprocal metrics, the
masks and the weights (the gradient weights w_gx/w_gy/w_gz among them) are
0 at dead nodes, so the padding adds exactly 0 to every stencil, reduction
and error norm.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List

import numpy as np
import torch

from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.harness.batched_ladder import _pad, stack_grids, stack_states
from na_dd_tpu_torch.harness.rates import calculate_observed_rates
from na_dd_tpu_torch.integrators.pc_trapezoidal import HCsCorrectorPositivityError
from na_dd_tpu_torch.three_d.fields import FieldRegHCsTriple3
from na_dd_tpu_torch.three_d.forcing import MMSForcingRegHCsTriple3
from na_dd_tpu_torch.three_d.grid import Grid3, colourings3, make_uniform_grid3
from na_dd_tpu_torch.three_d.harness import err_sq3
from na_dd_tpu_torch.three_d.integrator import PCTrapezoidalRegHCsTriple3
from na_dd_tpu_torch.three_d.mms import state_from_mms_when3
from na_dd_tpu_torch.three_d.shifts import BATCHED_OPS3


def pad_grid3(g: Grid3, N_max: int, M_max: int, P_max: int) -> Grid3:
    """Zero-pad every grid volume to (N_max+1, M_max+1, P_max+1), with the
    dead-node invariants of the 2-D ``pad_grid``; ``red_mask``/``color7``
    are made anew from the padded (i, j, k), as the JAX package makes them."""
    shape = (N_max + 1, M_max + 1, P_max + 1)
    changes = {
        f.name: _pad(getattr(g, f.name), shape)
        for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), torch.Tensor) and f.name not in ("red_mask", "color7")
    }
    red_mask, color7 = colourings3(N_max, M_max, P_max)
    changes["red_mask"] = torch.as_tensor(red_mask, dtype=g.dtype, device=g.device)
    changes["color7"] = torch.as_tensor(color7, device=g.device)
    return dataclasses.replace(g, N=N_max, M=M_max, P=P_max, **changes)


def pad_state3(s: State, N_max: int, M_max: int, P_max: int) -> State:
    """Zero-pad every state field to the padded grid's shape."""
    return State(*(_pad(v, (N_max + 1, M_max + 1, P_max + 1)) for v in s))


def build_spatial_ladder3_batched(
    case_cls,
    *,
    model,
    levels: int = 4,
    base_N: int = 4,
    dt0: float = 1e-2,
    Tf: float = 0.02,
    eta: float = 50.0,
    krylov_unroll: int = 24,
    num_newton_steps: int = 2,
    precision: str | None = None,
    integral_vars=("T", "cl", "cd"),
    dtype=None,
    device=None,
) -> dict:
    """Everything the batched 3-D ladder runs, built once: ``Ns``, ``dts``,
    ``nsteps``, the stacked padded ``grid`` and ``state``, ``dt`` as an
    (L, 1, 1, 1) tensor, the ``case`` and ``integrator``, and ``run()``,
    which runs the whole ladder and returns, after its one host transfer,
    ((tot, grad) each (P+1, L), (converged, hcs) each (P, L)) as numpy
    arrays: each step's Σ H² error and gradient term and flags, per level.
    ``run`` may be called again."""
    Ns: List[int] = [base_N * 2**k for k in range(levels)]
    N_max = Ns[-1]
    dts: List[float] = []
    nsteps: List[int] = []
    for k in range(levels):
        n = max(1, math.ceil(Tf / (dt0 / 2**k)))
        dts.append(Tf / n)
        nsteps.append(n)
    P_steps = max(nsteps)

    # one case/forcing/field/integrator serves every level (every method is
    # an explicit function of (grid, ops, state, t); padded grids are data)
    grid_max = make_uniform_grid3(N_max, N_max, N_max, dtype=dtype, device=device)
    case = case_cls(grid_max, model)
    forcing = MMSForcingRegHCsTriple3(mms_case=case, model=model, regularization_factor=eta)
    field = FieldRegHCsTriple3(
        grid=grid_max, model=model, forcing=forcing, regularization_factor=eta
    )
    integ = PCTrapezoidalRegHCsTriple3(
        field,
        regularization_factor=eta,
        track_residuals=False,
        krylov_unroll=krylov_unroll,
        num_newton_steps=num_newton_steps,
        precision=precision or "full",
    )

    padded_grids, padded_states = [], []
    for N in Ns:
        g = make_uniform_grid3(N, N, N, dtype=dtype, device=device)
        s0 = state_from_mms_when3(mms_case=case, t=0.0, grid=g)
        padded_grids.append(pad_grid3(g, N_max, N_max, N_max))
        padded_states.append(pad_state3(s0, N_max, N_max, N_max))
    grid = stack_grids(padded_grids)
    s0 = stack_states(padded_states)
    dt_batch = torch.tensor(dts, dtype=grid.dtype, device=grid.device).reshape(levels, 1, 1, 1)
    ops = BATCHED_OPS3

    def column(v):
        return v.to(torch.float64).reshape(-1).expand(levels)

    def run():
        ks = torch.arange(P_steps, dtype=grid.dtype, device=grid.device)
        tot0, grad0, _ = err_sq3(ops, grid, case, s0, torch.zeros_like(dt_batch), integral_vars)
        rows, flags = [(column(tot0), column(grad0))], []
        s = s0
        for k in range(P_steps):
            t_k = ks[k] * dt_batch
            s, diag = integ.step_fn(grid, ops, s, t_k, dt_batch)
            tot, grad, _ = err_sq3(ops, grid, case, s, t_k + dt_batch, integral_vars)
            rows.append((column(tot), column(grad)))
            flags.append((column(diag.krylov_converged), column(diag.hcs_denominator_ok)))
        errs = torch.stack([torch.stack(r) for r in rows], dim=1)  # (2, P+1, L)
        diags = torch.stack([torch.stack(f) for f in flags], dim=1)  # (2, P, L)
        # the run's only host transfer
        packed = torch.cat([errs.reshape(-1), diags.reshape(-1)]).cpu().numpy()
        n_errs = 2 * (P_steps + 1) * levels
        return (
            packed[:n_errs].reshape(2, P_steps + 1, levels),
            packed[n_errs:].reshape(2, P_steps, levels),
        )

    return dict(Ns=Ns, dts=dts, nsteps=nsteps, grid=grid, state=s0, dt=dt_batch, case=case,
                integrator=integ, run=run)


def run_spatial_ladder3_batched(
    case_cls,
    *,
    model,
    levels: int = 4,
    base_N: int = 4,
    dt0: float = 1e-2,
    Tf: float = 0.02,
    eta: float = 50.0,
    krylov_unroll: int = 24,
    num_newton_steps: int = 2,
    precision: str | None = None,
    integral_vars=("T", "cl", "cd"),
    verbose: bool = True,
    measure_steady: bool = False,
    dtype=None,
    device=None,
) -> dict:
    """The 3-D study ladder (N = base_N·2^k, dt = dt0/2^k) as one batch of
    levels; each level's error is the combined max-integral norm of
    :func:`na_dd_tpu_torch.three_d.harness.run_trial3`.  Returns the JAX
    package's result dict (``compile_plus_run_s`` the first run's
    wall-clock).  On the card unless ``device="cpu"``.

    ``precision="mixed"`` runs every solve as float32 batched K5 launches
    under per-level float64 refinement (residuals by the batched K6); None
    and ``"full"`` solve in the grid's dtype.  The JAX function's
    ``krylov_scanned`` (an XLA compile-time option) has no counterpart here.
    """
    ladder = build_spatial_ladder3_batched(
        case_cls, model=model, levels=levels, base_N=base_N, dt0=dt0, Tf=Tf, eta=eta,
        krylov_unroll=krylov_unroll, num_newton_steps=num_newton_steps, precision=precision,
        integral_vars=integral_vars, dtype=dtype, device=device,
    )
    Ns, dts, nsteps, run = ladder["Ns"], ladder["dts"], ladder["nsteps"], ladder["run"]

    t_start = time.perf_counter()
    (tot_all, grad_all), (conv_all, hcs_all) = run()
    first_run = time.perf_counter() - t_start
    steady = None
    if measure_steady:
        t_start = time.perf_counter()
        run()
        steady = time.perf_counter() - t_start
    if verbose:
        print(
            f"  [3-D spatial-batched] {levels} levels in one batch: "
            f"first run {first_run:.2f}s"
            + (f", steady {steady:.2f}s" if steady is not None else ""),
            flush=True,
        )

    errors: List[float] = []
    converged: List[bool] = []
    for i, N in enumerate(Ns):
        k = nsteps[i]
        # only the level's own steps gate its flags (overrun rows dropped)
        if not bool(np.all(hcs_all[:k, i] > 0.5)):
            raise HCsCorrectorPositivityError(
                f"level N={N}: denominator 2 - dt Kd (Sd - Cd1) (1 + Cl1) "
                "below positiveness threshold."
            )
        converged.append(bool(np.all(conv_all[:k, i] > 0.5)))
        tot = tot_all[: k + 1, i]
        grad = grad_all[: k + 1, i]
        running = np.concatenate(
            [[0.0], np.cumsum(0.5 * dts[i] * (grad[:-1] + grad[1:]))]
        )
        errors.append(float(np.sqrt(np.max(tot + running))))
        if verbose:
            print(
                f"  [3-D spatial-batched] N={N:4d} dt={dts[i]:.3e} "
                f"err={errors[-1]:.6e} conv={converged[-1]}"
            )

    rates = calculate_observed_rates(errors) if len(errors) >= 3 else []
    return dict(
        kind="three_d_spatial_batched",
        Ns=Ns,
        Tf=Tf,
        eta=eta,
        errors=errors,
        converged=converged,
        compile_plus_run_s=first_run,
        steady_s=steady,
        krylov_unroll=krylov_unroll,
        rates=[r for r, _ in rates],
        statuses=[s for _, s in rates],
    )
