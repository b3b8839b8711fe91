"""The parameter-screening ensemble: B independent η-screen integrations as
one batch (the function of the JAX package's
``studies/ensemble_throughput.py``, the serving workload).

Every member is the study's RegHCs integration of its MMS case from the
exact state at t = 0 to ``Tf``, with its own regularization factor η and no
error collection.  The B members run as one stack: η an (B, 1, 1) tensor
through field, forcing and corrector, the reductions per member
(:data:`~na_dd_tpu_torch.ops.shifts.BATCHED_OPS`), each Newton solve one
launch of the batched K1 and each residual apply one of the batched K2 on
the card, with the study's Krylov budget and ``track_residuals=False``.
A batch larger than one launch of the batched K1 holds runs as consecutive
parts of at most ``kernels.MAX_BATCH`` members each.
The masked early exits keep every member's run its own: a member is the
same integration whether it runs alone or in a batch, up to the order of a
kernel's sums.

With a mesh (data parallelism, the JAX study's ``--dp``), each rank of the
process group runs its B/dp members and the final states are all-gathered,
so every rank returns the whole ensemble.  Members share nothing, so no
collective runs inside the time loop.
"""

from __future__ import annotations

import math

import torch

from na_dd_tpu_torch.core.fields import FieldRegHCsTriple
from na_dd_tpu_torch.core.forcing import MMSForcingRegHCsTriple
from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.harness.studies import STUDIES, _study_unroll, study_consts
from na_dd_tpu_torch.integrators.pc_trapezoidal import PCTrapezoidalRegHCsTriple
from na_dd_tpu_torch.mms.engine import state_from_mms_when
from na_dd_tpu_torch.models.coefficients import Model02
from na_dd_tpu_torch.ops import kernels
from na_dd_tpu_torch.ops.grid import make_uniform_grid
from na_dd_tpu_torch.ops.halo import gather_ranks
from na_dd_tpu_torch.ops.shifts import BATCHED_OPS


def build_ensemble(etas, *, study: str = "pol", N: int = 64, Tf: float = 0.01, dt: float = 5e-4,
                   dtype=None, device=None) -> dict:
    """Everything one ensemble run needs, built once: ``etas``, the grid,
    ``num_steps``, the adjusted ``dt``, the Krylov ``budget``, the
    ``parts`` (consecutive members, at most :data:`kernels.MAX_BATCH
    <na_dd_tpu_torch.ops.kernels.MAX_BATCH>` each, the systems one launch of
    the batched K1 holds: dicts of their ``etas``, stacked initial
    ``state`` and ``integrator``), and ``run()``, which integrates every
    part and returns ``(final State (B, N+1, N+1) each, Krylov iterations
    of each member (B,))`` as device tensors.  Members share nothing, so a
    member's result does not depend on the part it runs in."""
    etas = [float(e) for e in etas]
    cfg, mc = STUDIES[study], study_consts(study)
    grid = make_uniform_grid(N, N, dtype=dtype, device=device)
    model = Model02(mc)
    case = cfg["case_cls"](grid=grid, model=model)
    s0 = state_from_mms_when(mms_case=case, t=0.0, grid=grid)
    num_steps = math.ceil(Tf / dt)
    dt_adj = Tf / num_steps
    budget = _study_unroll(cfg, N, dt_adj, mc)

    def part(members):
        eta = torch.tensor(members, dtype=grid.dtype, device=grid.device).reshape(-1, 1, 1)
        forcing = MMSForcingRegHCsTriple(mms_case=case, model=model, regularization_factor=eta)
        field = FieldRegHCsTriple(grid=grid, model=model, forcing=forcing,
                                  regularization_factor=eta)
        integ = PCTrapezoidalRegHCsTriple(
            field, regularization_factor=eta, track_residuals=False, krylov_unroll=budget
        )
        state = State(*(v.expand(len(members), *v.shape).contiguous() for v in s0))
        return dict(etas=members, state=state, integrator=integ)

    parts = [part(etas[i:i + kernels.MAX_BATCH]) for i in range(0, len(etas), kernels.MAX_BATCH)]
    ks = torch.arange(num_steps, dtype=grid.dtype, device=grid.device)

    def run_part(p):
        s = p["state"]
        iters = torch.zeros(len(p["etas"]), dtype=torch.int64, device=grid.device)
        for k in range(num_steps):
            s, diag = p["integrator"].step_fn(grid, BATCHED_OPS, s, ks[k] * dt_adj, dt_adj)
            iters = iters + diag.krylov_iters.reshape(-1)
        return s, iters

    def run():
        outs = [run_part(p) for p in parts]
        if len(outs) == 1:
            return outs[0]
        return (State(*(torch.cat(vs) for vs in zip(*(s for s, _ in outs)))),
                torch.cat([it for _, it in outs]))

    return dict(etas=etas, grid=grid, parts=parts, num_steps=num_steps, dt=dt_adj,
                budget=budget, run=run)


def simulate_ensemble(etas, *, study: str = "pol", N: int = 64, Tf: float = 0.01,
                      dt: float = 5e-4, mesh=None, dtype=None, device=None):
    """Integrate the ensemble of ``etas`` (defaults: the JAX study's pol
    N=64, Tf=0.01, dt=5e-4) and return ``(final State, each member's Krylov
    iterations)``, stacked over the members.  With ``mesh`` (a 1-D
    :class:`~na_dd_tpu_torch.parallel.sharding.Mesh` over the process
    group's ranks, or of a sub-group's: ``make_mesh(group=...)``) each rank
    runs its B/dp consecutive members, B a multiple of dp, and every rank of
    the mesh returns the whole gathered ensemble.  On the card
    unless ``device="cpu"``."""
    etas = [float(e) for e in etas]
    if mesh is not None:
        dp = mesh.num_ranks
        if len(etas) % dp != 0:
            raise ValueError(f"{len(etas)} members do not divide over {dp} ranks")
        per = len(etas) // dp
        etas = etas[mesh.rank * per:(mesh.rank + 1) * per]
    s, iters = build_ensemble(etas, study=study, N=N, Tf=Tf, dt=dt, dtype=dtype,
                              device=device)["run"]()
    if mesh is None:
        return s, iters
    def gather(v):
        return torch.cat(gather_ranks(v, group=mesh.group))

    return State(*(gather(v) for v in s)), gather(iters)
