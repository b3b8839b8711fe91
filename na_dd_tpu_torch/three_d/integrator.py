"""3-D PC-trapezoidal integrator (counterpart of
:mod:`na_dd_tpu.three_d.integrator`, the RegHCs variant).

The whole predictor–corrector step of
:class:`na_dd_tpu_torch.integrators.pc_trapezoidal.PCTrapezoidalBase` is
dimension-agnostic (pointwise algebra, ``ops`` reductions, a stencil with
``.apply``/``.c0``), so the 3-D integrator overrides only the Newton-plane
builder.  Its solves reach the 7-point kernels through the solver backend,
which picks them by the stencil's type.
"""

from __future__ import annotations

from na_dd_tpu_torch.integrators.pc_trapezoidal import PCTrapezoidalRegHCsTriple
from na_dd_tpu_torch.three_d.diffusion import newton_planes3


class _Newton3Mixin:
    """Stencil7 Newton planes in place of the 2-D Stencil5 builder."""

    def _newton_planes(self, g, ops, L, dt):
        return newton_planes3(g, ops, L, dt)


class PCTrapezoidalRegHCsTriple3(_Newton3Mixin, PCTrapezoidalRegHCsTriple):
    """PC-trapezoidal with the regularized-Heaviside cs corrector (the
    paper's headline integrator), in 3-D."""
