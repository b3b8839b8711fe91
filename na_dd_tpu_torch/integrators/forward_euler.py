"""Explicit forward-Euler integrator (counterpart of
:mod:`na_dd_tpu.integrators.forward_euler`).

Boundary semantics are the reference's: u1 = u0 + dt·F(u0) on the *full*
grid, so boundary values evolve under the forcing's boundary trace (no
re-projection onto the Dirichlet boundary — observable in the FE order
tests).  The step makes no solve: :meth:`ForwardEulerIntegrator.step_fn`
returns a bare State, which the harness takes as a converged step of 0
Krylov iterations.
"""

from __future__ import annotations

from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS


class ForwardEulerIntegrator:
    #: ops provider of the eager :meth:`step`; the step body is
    #: dimension-agnostic, so the 3-D subclass overrides only this
    _local_ops = LOCAL_OPS

    def __init__(self, semi_discrete_field, **_ignored):
        self.semi_discrete_field = semi_discrete_field

    def step_fn(self, g, ops, s: State, t0, dt) -> State:
        """One step from ``s`` at time ``t0``."""
        F = self.semi_discrete_field.all_fields(g, ops, s, t0)
        return State(
            cp=s.cp + dt * F.cp,
            T=s.T + dt * F.T,
            cl=s.cl + dt * F.cl,
            cd=s.cd + dt * F.cd,
            cs=s.cs + dt * F.cs,
        )

    def step(self, at_t0: State, *, t0, dt) -> State:
        """Eager single step on the field's grid."""
        return self.step_fn(self.semi_discrete_field.grid, self._local_ops, at_t0, t0, dt)
