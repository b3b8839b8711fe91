"""utils (port of na_dd_tpu.utils): timing helpers and the dense Newton-step
helper of the algebraic tests."""

from na_dd_tpu_torch.utils.timing import (
    Timed,
    device_trace,
    time_compile_and_run,
    timed_block,
    xla_trace,
)
from na_dd_tpu_torch.utils.testing import solve_newton_step_Fx_eq_C

__all__ = [
    "Timed",
    "timed_block",
    "time_compile_and_run",
    "xla_trace",
    "solve_newton_step_Fx_eq_C",
    "device_trace",
]
