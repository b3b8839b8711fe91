"""The multi-rank dry run (counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``): each of its checks, on the port's
ranks.

On ``n_ranks`` ranks of one process group, on tiny shapes: the sharded step
on a 1-D mesh (the HCs verdict holds), a 2-step sharded simulation (finite),
``precision="mixed"`` and ``linear_solver="direct"`` sharded steps against
their local steps (≤1e-12), with an even ``n_ranks`` of 4 to 8 the 3-D step
on a 2-D mesh against its local step (≤1e-12, converged), and the
data-parallel ensemble against the unsharded one (≤1e-13, the same Krylov
iterations).  Every rank computes the local references itself and checks
its own block; a miss raises, and :func:`run_ranks` raises with it.
"""

from __future__ import annotations

import numpy as np
import torch

from na_dd_tpu_torch.parallel.launch import run_ranks


class DryRunMismatch(AssertionError):
    """A sharded result off its local counterpart."""


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise DryRunMismatch(what)


def _build(N: int, device, eta: float = 50.0, **integrator_kw):
    """Grid, MMS case, RegHCs integrator and exact initial state of the pol
    case with the default model constants, as the JAX dry run builds them."""
    from na_dd_tpu_torch.core.fields import FieldRegHCsTriple
    from na_dd_tpu_torch.core.forcing import MMSForcingRegHCsTriple
    from na_dd_tpu_torch.integrators.pc_trapezoidal import PCTrapezoidalRegHCsTriple
    from na_dd_tpu_torch.mms.cases import MMSCasePol
    from na_dd_tpu_torch.mms.engine import state_from_mms_when
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.ops.grid import make_grid

    grid = make_grid(np.linspace(0, 1, N + 1), np.linspace(0, 1, N + 1), device=device)
    model = Model02(default_model_consts)
    mms = MMSCasePol(grid, model=model)
    forcing = MMSForcingRegHCsTriple(mms_case=mms, model=model, regularization_factor=eta)
    field = FieldRegHCsTriple(grid=grid, model=model, forcing=forcing, regularization_factor=eta)
    integ = PCTrapezoidalRegHCsTriple(field, regularization_factor=eta, **integrator_kw)
    return grid, mms, integ, state_from_mms_when(mms_case=mms, t=0.0, grid=grid)


def _max_block_diff(ops, block_state, full_state) -> float:
    return max(float((b - ops.local_slice(f)).abs().max()) for b, f in zip(block_state, full_state))


def _dryrun_rank(rank, device, n):
    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.harness.ensemble import simulate_ensemble
    from na_dd_tpu_torch.integrators.pc_trapezoidal import PCTrapezoidalRegHCsTriple
    from na_dd_tpu_torch.ops.shifts import LOCAL_OPS
    from na_dd_tpu_torch.parallel.sharding import make_mesh, shard_grid_and_state
    from na_dd_tpu_torch.parallel.step import build_sharded_simulation, build_sharded_step

    # (N+1) rows must divide over the mesh; the shapes stay tiny
    grid, mms, integ, s0 = _build(4 * n - 1, device)
    mesh = make_mesh((n,), ("x",))
    gs, ss = shard_grid_and_state(mesh, grid, s0)
    t0 = torch.zeros((), dtype=grid.dtype, device=device)

    step = build_sharded_step(integ, mesh)
    s1, small = step(gs, ss, 0.0, 1e-3)
    _check(bool(small["hcs_ok"]), "sharded step: the HCs corrector lost positivity")

    sim = build_sharded_simulation(integ, mesh, mms_case=mms, num_steps=2, t0=0.0, dt=1e-3)
    s_final, _errors = sim(gs, ss)
    _check(all(bool(v.isfinite().all()) for v in s_final), "sharded simulation: non-finite state")

    # mixed precision and the replicated direct solve against their local steps
    for label, kw in (("mixed", dict(precision="mixed")), ("direct", dict(linear_solver="direct"))):
        integ_k = PCTrapezoidalRegHCsTriple(integ.semi_discrete_field, regularization_factor=50.0,
                                            **kw)
        local, _ = integ_k.step_fn(grid, LOCAL_OPS, s0, t0, 1e-3)
        step_k = build_sharded_step(integ_k, mesh)
        sharded, _ = step_k(gs, ss, 0.0, 1e-3)
        d = _max_block_diff(step_k.ops, sharded, local)
        _check(d < 1e-12, f"sharded {label} step diverges from local: {d}")

    # the 3-D step on a 2-D mesh
    n3y = n // 2 if n < 8 else 4
    if n >= 4 and 2 * n3y == n:
        from na_dd_tpu_torch.models.coefficients import Model02
        from na_dd_tpu_torch.models.consts import default_model_consts
        from na_dd_tpu_torch.three_d import (
            HaloOps3, LOCAL_OPS3, MMSCaseExpSin3, make_setup3, make_uniform_grid3,
            state_from_mms_when3,
        )

        g3, case3, _field3, integ3 = make_setup3(
            MMSCaseExpSin3, model=Model02(default_model_consts),
            grid=make_uniform_grid3(7, 2 * n3y - 1, 4, device=device),
            integrator_params=dict(krylov_unroll=24),
        )
        s03 = state_from_mms_when3(mms_case=case3, t=0.0, grid=g3)
        s13_local, _ = integ3.step_fn(g3, LOCAL_OPS3, s03, t0, 1e-3)
        mesh3 = make_mesh((2, n3y), ("x", "y"))
        hops3 = HaloOps3(mesh3, axis_x="x", axis_y="y")
        g3s, s03s = shard_grid_and_state(mesh3, g3, s03, axis_x="x", axis_y="y")
        s13, diag3 = integ3.step_fn(g3s, hops3, s03s, t0, 1e-3)
        _check(bool(diag3.krylov_converged), "3-D sharded step: a Krylov solve missed tolerance")
        d = _max_block_diff(hops3, s13, s13_local)
        _check(d < 1e-12, f"3-D sharded step diverges from local: {d}")

    # the data-parallel ensemble against the unsharded one
    etas = np.linspace(20.0, 200.0, n).tolist()
    kw = dict(study="pol", N=7, Tf=2e-3, dt=1e-3, device=device)
    s_dp, it_dp = simulate_ensemble(etas, mesh=make_mesh((n,), ("b",)), **kw)
    s_one, it_one = simulate_ensemble(etas, **kw)
    d = max(float((a - b).abs().max()) for a, b in zip(s_dp, s_one))
    _check(d <= 1e-13 and torch.equal(it_dp, it_one),
           f"data-parallel ensemble diverges from the unsharded one: {d}")
    return State._fields


def dryrun_multichip(n_ranks: int, *, backend: str, device: str | None = None,
                     timeout_s: float = 600.0) -> None:
    """Run every check on ``n_ranks`` ranks of ``backend`` ("gloo" or
    "nccl") on ``device`` ("cpu", or None/"cuda": the card).  Returns
    nothing; raises on a miss."""
    run_ranks(_dryrun_rank, n_ranks, backend=backend, device=device or "cuda",
              args=(n_ranks,), timeout_s=timeout_s)
