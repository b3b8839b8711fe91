"""3-D time integrators (counterpart of :mod:`na_dd_tpu.three_d.integrator`):
the PC-trapezoidal family and forward Euler.

The whole predictor–corrector step of
:class:`na_dd_tpu_torch.integrators.pc_trapezoidal.PCTrapezoidalBase` and
its three cs correctors are dimension-agnostic (pointwise algebra, ``ops``
reductions, a stencil with ``.apply``/``.c0``), so the 3-D integrators
override only how the Newton planes are made and the eager ``step``'s ops
provider.  Their solves reach the 7-point kernels through the solver
backend, which picks them by the stencil's type.  Forward Euler only
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
from na_dd_tpu_torch.three_d.diffusion import newton_planes3
from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3


class ForwardEulerIntegrator3(ForwardEulerIntegrator):
    """Forward Euler on 3-D fields."""

    _local_ops = LOCAL_OPS3


class _Newton3Mixin:
    """Stencil7 Newton planes in place of the 2-D Stencil5 planes.

    ``differentiable=True`` and ``linear_solver="direct"`` are 2-D only in
    the port (the IFT adjoint takes Stencil5 planes; the 3-D direct solve
    and 3-D gradients are ROADMAP Queue 1 item 9): both raise here."""

    _local_ops = LOCAL_OPS3

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for option, on in (("differentiable=True", self.differentiable),
                           ("linear_solver='direct'", self.linear_solver == "direct")):
            if on:
                raise NotImplementedError(
                    f"{option} is not ported to the 3-D integrators (ROADMAP Queue 1 item 9)"
                )

    def _newton_planes(self, g, ops, L, dt):
        return newton_planes3(g, ops, L, dt)


class PCTrapezoidalCsTriple3(_Newton3Mixin, PCTrapezoidalCsTriple):
    """PC-trapezoidal with the linear cs corrector, in 3-D."""


class PCTrapezoidalHCsTriple3(_Newton3Mixin, PCTrapezoidalHCsTriple):
    """PC-trapezoidal with the sharp-Heaviside cs corrector, in 3-D."""


class PCTrapezoidalRegHCsTriple3(_Newton3Mixin, PCTrapezoidalRegHCsTriple):
    """PC-trapezoidal with the regularized-Heaviside cs corrector (the
    paper's headline integrator), in 3-D."""
