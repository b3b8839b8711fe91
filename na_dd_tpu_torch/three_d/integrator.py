"""3-D time integrators (counterpart of :mod:`na_dd_tpu.three_d.integrator`):
the PC-trapezoidal family and forward Euler.

The whole predictor–corrector step of
:class:`na_dd_tpu_torch.integrators.pc_trapezoidal.PCTrapezoidalBase` and
its three cs correctors are dimension-agnostic (pointwise algebra, ``ops``
reductions, a stencil with ``.apply``/``.c0``), so the 3-D integrators
override only how the Newton planes are made (closed form or 7-colour
probes) and the eager ``step``'s ops provider.  Their solves reach the
7-point kernels and the 3-D direct solve through the solver backend, which
picks them by the stencil's type, and so does the double-float step
(``precision="df"``) and ``mixed_df``, whose float32 inner solves are K5 on
the hi volumes.  Forward Euler only
evaluates ``field.all_fields``, so its 3-D class changes nothing but the
ops provider.
"""

from __future__ import annotations

from na_dd_tpu_torch.integrators.forward_euler import ForwardEulerIntegrator
from na_dd_tpu_torch.integrators.pc_trapezoidal import (
    PCTrapezoidalCsTriple,
    PCTrapezoidalHCsTriple,
    PCTrapezoidalRegHCsTriple,
)
from na_dd_tpu_torch.three_d.diffusion import newton_planes3, probe_stencil3
from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3


class ForwardEulerIntegrator3(ForwardEulerIntegrator):
    """Forward Euler on 3-D fields."""

    _local_ops = LOCAL_OPS3


class _Newton3Mixin:
    """Stencil7 Newton planes and 7-colour probing in place of the 2-D
    Stencil5 planes and 5-colour probing.  The solver backends pick the 3-D
    kernels (K5/K6) and the 3-D direct solve by the stencil's type.

    ``differentiable=True`` with ``precision="mixed"`` or
    ``linear_solver="direct"`` is refused with the JAX package's exception
    type: its 3-D integrators fail there (their plane adjoint needs a
    ``Stencil7.transpose`` the JAX package lacks), and the port holds to the
    JAX package rather than add the mode."""

    _local_ops = LOCAL_OPS3

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.differentiable and (self.precision == "mixed" or self.linear_solver == "direct"):
            raise AttributeError(
                "differentiable=True with precision='mixed' or linear_solver='direct' is not "
                "available in 3-D: the JAX package's plane adjoint has no Stencil7 transpose"
            )

    def _newton_planes(self, g, ops, L, dt):
        return newton_planes3(g, ops, L, dt)

    def _probe_stencil(self, matvec, g):
        return probe_stencil3(matvec, g)


class PCTrapezoidalCsTriple3(_Newton3Mixin, PCTrapezoidalCsTriple):
    """PC-trapezoidal with the linear cs corrector, in 3-D."""


class PCTrapezoidalHCsTriple3(_Newton3Mixin, PCTrapezoidalHCsTriple):
    """PC-trapezoidal with the sharp-Heaviside cs corrector, in 3-D."""


class PCTrapezoidalRegHCsTriple3(_Newton3Mixin, PCTrapezoidalRegHCsTriple):
    """PC-trapezoidal with the regularized-Heaviside cs corrector (the
    paper's headline integrator), in 3-D."""
