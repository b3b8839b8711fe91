"""integrators (port of na_dd_tpu.integrators): forward Euler and the
PC-trapezoidal family."""

from na_dd_tpu_torch.integrators.forward_euler import ForwardEulerIntegrator
from na_dd_tpu_torch.integrators.pc_trapezoidal import (
    HCsCorrectorPositivityError,
    PCTrapezoidalBase,
    PCTrapezoidalCsTriple,
    PCTrapezoidalHCsTriple,
    PCTrapezoidalRegHCsTriple,
)

__all__ = [
    "ForwardEulerIntegrator",
    "PCTrapezoidalBase",
    "PCTrapezoidalCsTriple",
    "PCTrapezoidalHCsTriple",
    "PCTrapezoidalRegHCsTriple",
    "HCsCorrectorPositivityError",
]
