"""Batched spatial ladders: every level padded to the finest level's shape
and run as one batch (counterpart of :mod:`na_dd_tpu.harness.batched_ladder`).

The JAX package runs the notebook's spatial ladder (cell 9: N = 2·2^k,
dt = h^1.5) as one ``jax.vmap``-ed program over (grid, state, dt).  Here the
vmap is a leading batch dimension written out: the L levels' grids and
states, zero-padded to (N_max+1, N_max+1), are stacked into (L, N_max+1,
N_max+1) tensors, dt rides as an (L, 1, 1) tensor, the reductions go through
:data:`~na_dd_tpu_torch.ops.shifts.BATCHED_OPS` (one value a level), and
every Newton solve of every level is ONE launch of the batched BiCGStab
kernel (with ``coupling_source="analytic"``, every Newton sweep one launch of
the batched triple solve).  The time loop runs the ladder's longest step count; a coarse level
integrates past Tf and its rows past its own step count are dropped on the
host after the run's one transfer.  So the ladder costs the launches of its
finest level, not the sum of all levels'.

Zero padding is inert (:func:`pad_grid`): the reciprocal metrics, the masks
and the inner-product weights are 0 at dead nodes, so dead nodes add exactly
0 to every stencil, reduction and error norm.  The Krylov budget is the
ladder's largest; the masked early exit makes a larger budget give the same
answer.  The only deviation from the serial ladder is rounding: the padded
zeros and the batched kernel's per-level block shares change the order of
the sums.  The JAX package's ``krylov_scanned`` option (a scanned solver
body for XLA's compile time) has no counterpart in an eager loop.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List

import torch
import torch.nn.functional as F

from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.harness.rates import calculate_observed_rates
from na_dd_tpu_torch.harness.trial import (
    ALL_VARIABLES,
    DEFAULT_INTEGRAL_VARS,
    NumericalErrorSummary,
    _error_series,
    _simulate,
    _unpack,
)
from na_dd_tpu_torch.mms.engine import state_from_mms_when
from na_dd_tpu_torch.ops.grid import Grid, colourings, make_uniform_grid
from na_dd_tpu_torch.ops.shifts import BATCHED_OPS


def _pad(a: torch.Tensor, shape) -> torch.Tensor:
    """Zero-pad the trailing dimensions of ``a`` at their ends to ``shape``."""
    widths = []
    for have, want in zip(reversed(a.shape), reversed(shape)):
        widths += [0, want - have]
    return F.pad(a, widths)


def pad_grid(g: Grid, N_max: int, M_max: int) -> Grid:
    """Zero-pad every grid plane to (N_max+1, M_max+1).

    Dead-node invariants that make zero padding inert:

    * ``interior_mask``, ``mask_x1/y1`` and the weight planes (``w_H``,
      ``w_pk``, ``w_hp``) are 0 at dead nodes, so dead nodes add 0 to every
      reduction and every Newton-plane coefficient;
    * the reciprocal metrics (``inv_hh`` ...) are 0 at dead nodes, so a
      stencil difference across the real/dead seam vanishes exactly, as at
      the real boundary rows;
    * the coordinates pad with 0, so a forcing or exact-solution evaluation
      at a dead node sees the x=0 / y=0 boundary: finite, and multiplied by
      zero weights and masks wherever it could matter.

    ``red_mask``/``color5`` are made anew from the padded (i, j), as the
    JAX package's ``pad_grid`` makes them.
    """
    shape = (N_max + 1, M_max + 1)
    changes = {
        f.name: _pad(getattr(g, f.name), shape)
        for f in dataclasses.fields(g)
        if isinstance(getattr(g, f.name), torch.Tensor) and f.name not in ("red_mask", "color5")
    }
    red_mask, color5 = colourings(N_max, M_max)
    changes["red_mask"] = torch.as_tensor(red_mask, dtype=g.dtype, device=g.device)
    changes["color5"] = torch.as_tensor(color5, device=g.device)
    return dataclasses.replace(g, N=N_max, M=M_max, **changes)


def pad_state(s: State, N_max: int, M_max: int) -> State:
    """Zero-pad every state field to the padded grid's shape."""
    return State(*(_pad(v, (N_max + 1, M_max + 1)) for v in s))


def stack_grids(grids):
    """One grid whose every tensor is the stack of the given grids' (all of
    one shape and N, M), the batch of a batched run."""
    first = grids[0]
    return dataclasses.replace(first, **{
        f.name: torch.stack([getattr(g, f.name) for g in grids])
        for f in dataclasses.fields(first)
        if isinstance(getattr(first, f.name), torch.Tensor)
    })


def stack_states(states) -> State:
    """The stack of the given states (the batch of a batched run)."""
    return State(*(torch.stack(vs) for vs in zip(*states)))


def build_spatial_ladder_batched(
    study: str,
    *,
    levels: int = 8,
    base_N: int = 2,
    eta: float = 50.0,
    precision: str | None = None,
    coupling_source: str | None = None,
    mixed_df: bool = False,
    dtype=None,
    device=None,
) -> dict:
    """Everything the batched ladder runs, built once: the levels' ``Ns``,
    ``dts`` and ``nsteps``, the Krylov ``budget``, the stacked padded
    ``grid`` and initial ``state``, ``dt`` as an (L, 1, 1) tensor, the
    ``case`` and ``integrator``, and ``run()``, which runs the whole ladder
    and returns its norms and diagnostics on the host (:func:`_simulate`'s
    packing) after the run's one transfer.  ``run`` may be called again."""
    from na_dd_tpu_torch.core.fields import FieldRegHCsTriple
    from na_dd_tpu_torch.core.forcing import MMSForcingRegHCsTriple
    from na_dd_tpu_torch.harness.studies import STUDIES, _study_unroll, study_consts
    from na_dd_tpu_torch.integrators.pc_trapezoidal import PCTrapezoidalRegHCsTriple
    from na_dd_tpu_torch.models.coefficients import Model02

    cfg = STUDIES[study]
    mc = study_consts(study)
    Tf = cfg["spatial_Tf"]

    Ns: List[int] = [base_N * 2**k for k in range(levels)]
    N_max = Ns[-1]
    dts: List[float] = []
    nsteps: List[int] = []
    budget = 0
    for N in Ns:
        dt = (1.0 / N) ** 1.5
        n = math.ceil(Tf / dt)
        dts.append(Tf / n)  # dt adjusted to divide Tf exactly, as each serial level does
        nsteps.append(n)
        budget = max(budget, _study_unroll(cfg, N, dt, mc))
    P = max(nsteps)

    model = Model02(mc)
    # one case/forcing/field/integrator serves every level: every evaluation
    # is an explicit function of (grid, ops, state, t), and the padded grids
    # are data
    grid_max = make_uniform_grid(N_max, N_max, dtype=dtype, device=device)
    case = cfg["case_cls"](grid=grid_max, model=model)
    forcing = MMSForcingRegHCsTriple(mms_case=case, model=model, regularization_factor=eta)
    field = FieldRegHCsTriple(
        grid=grid_max, model=model, forcing=forcing, regularization_factor=eta
    )
    integ = PCTrapezoidalRegHCsTriple(
        field, regularization_factor=eta, track_residuals=False, krylov_unroll=budget,
        precision=precision or "full", coupling_source=coupling_source or "jvp",
        mixed_df=mixed_df,
    )

    padded_grids, padded_states = [], []
    for N in Ns:
        g = make_uniform_grid(N, N, dtype=dtype, device=device)
        s0 = state_from_mms_when(mms_case=case, t=0.0, grid=g)
        padded_grids.append(pad_grid(g, N_max, N_max))
        padded_states.append(pad_state(s0, N_max, N_max))
    grid = stack_grids(padded_grids)
    s0 = stack_states(padded_states)
    dt_batch = torch.tensor(dts, dtype=grid.dtype, device=grid.device).reshape(levels, 1, 1)

    def run():
        # the run's only host transfer
        return _simulate(
            grid=grid, integrator=integ, exact_sol_pack=case, exact_stack=None,
            initial_state=s0, t0=0.0, dt=dt_batch, num_steps=P,
            variable_names=ALL_VARIABLES, integral_vars=DEFAULT_INTEGRAL_VARS,
            ops=BATCHED_OPS, tail_grid=None, nsys=levels,
        ).cpu().numpy()

    return dict(Ns=Ns, dts=dts, nsteps=nsteps, budget=budget, Tf=Tf, grid=grid, state=s0,
                dt=dt_batch, case=case, integrator=integ, run=run)


def run_spatial_ladder_batched(
    study: str,
    *,
    levels: int = 8,
    base_N: int = 2,
    eta: float = 50.0,
    precision: str | None = None,
    coupling_source: str | None = None,
    mixed_df: bool = False,
    verbose: bool = True,
    measure_steady: bool = False,
    dtype=None,
    device=None,
) -> dict:
    """Notebook cell 9's ladder as one batch of levels.

    Same protocol as :func:`na_dd_tpu_torch.harness.studies.run_spatial_study`
    (N = base_N·2^k, dt = h^1.5, PC-RegHCs at the study's η and constants)
    and the same error functional per level; returns the JAX package's
    result dict (``compile_plus_run_s`` is the first run's wall-clock, the
    kernels' build included where it happens).  Runs on the card unless
    ``device="cpu"``.  ``precision="mixed"`` runs every solve as float32
    batched kernel launches under per-level float64 refinement (with
    ``mixed_df`` its residuals in double-float), ``"df"`` the double-float
    step of every level around the same float32 launches; None or "full"
    solves in the grid's dtype.  ``coupling_source="analytic"`` takes
    the cross couplings as closed-form planes and runs each Newton sweep of
    every level as ONE launch of the batched triple solve (K4, each level
    with its own dt; in ``precision="mixed"`` the float32 K4 under per-level
    block refinement); None or "jvp" the ``torch.func.jvp`` couplings and
    three batched solves.  The JAX function reads these from
    ``NA_DD_TPU_PRECISION`` and ``NA_DD_TPU_COUPLING``; the port reads no
    environment.
    """
    ladder = build_spatial_ladder_batched(
        study, levels=levels, base_N=base_N, eta=eta, precision=precision,
        coupling_source=coupling_source, mixed_df=mixed_df, dtype=dtype, device=device,
    )
    Ns, dts, nsteps = ladder["Ns"], ladder["dts"], ladder["nsteps"]

    t_start = time.perf_counter()
    packed = ladder["run"]()
    first_run = time.perf_counter() - t_start
    steady = None
    if measure_steady:
        t_start = time.perf_counter()
        ladder["run"]()
        steady = time.perf_counter() - t_start
    if verbose:
        print(
            f"  [spatial-batched {study}] {levels} levels in one batch: "
            f"first run {first_run:.2f}s"
            + (f", steady {steady:.2f}s" if steady is not None else ""),
            flush=True,
        )

    mats, diags = _unpack(packed, len(ALL_VARIABLES), max(nsteps), levels)
    errors: List[float] = []
    for i, N in enumerate(Ns):
        k = nsteps[i]  # the level's own steps; the overrun rows are dropped
        series = _error_series(
            mats[:, : k + 1, i], diags[:, :k, i], ALL_VARIABLES, 0.0, dts[i]
        )
        summary = NumericalErrorSummary(
            dts[i], series, list(ALL_VARIABLES), list(DEFAULT_INTEGRAL_VARS)
        )
        errors.append(summary.overall_combined_error)
        if verbose:
            print(
                f"  [spatial-batched {study}] N={N:4d} dt={dts[i]:.3e} "
                f"err={errors[-1]:.6e}"
            )

    rates = calculate_observed_rates(errors) if len(errors) >= 3 else []
    return dict(
        study=study,
        kind="spatial_batched",
        Ns=Ns,
        Tf=ladder["Tf"],
        eta=eta,
        errors=errors,
        wallclock_s=[first_run],
        steady_s=[steady] if steady is not None else None,
        compile_plus_run_s=first_run,
        krylov_unroll=ladder["budget"],
        rates=[r for r, _ in rates],
        statuses=[s for _, s in rates],
    )
