"""integrators (port of na_dd_tpu.integrators): forward Euler and the
PC-trapezoidal family."""

from na_dd_tpu_torch.integrators.forward_euler import ForwardEulerIntegrator
from na_dd_tpu_torch.integrators.pc_trapezoidal import (
    MIXED_INNER_TOL,
    DirectBackend,
    DirectMixedBackend,
    HCsCorrectorPositivityError,
    KrylovBackend,
    MixedBackend,
    PCTrapezoidalBase,
    PCTrapezoidalCsTriple,
    PCTrapezoidalHCsTriple,
    PCTrapezoidalRegHCsTriple,
    default_krylov_unroll,
)

__all__ = [
    "ForwardEulerIntegrator",
    "PCTrapezoidalBase",
    "PCTrapezoidalCsTriple",
    "PCTrapezoidalHCsTriple",
    "PCTrapezoidalRegHCsTriple",
    "HCsCorrectorPositivityError",
    "KrylovBackend",
    "DirectBackend",
    "DirectMixedBackend",
    "MixedBackend",
    "MIXED_INNER_TOL",
    "default_krylov_unroll",
]
