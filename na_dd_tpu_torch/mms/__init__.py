"""mms (port of na_dd_tpu.mms): SymPy → torch manufactured solutions and the
case library."""

from na_dd_tpu_torch.mms.engine import (
    MMSCaseBase,
    MMSCaseFromAnalytic,
    MMSCaseSymbolic,
    pack_analytical_txy_with_o2fdm_derivatives,
    pack_symbolic_txy_with_derivatives,
    state_from_mms_when,
    t_sym,
    x_sym,
    y_sym,
)
from na_dd_tpu_torch.mms import cases

__all__ = [
    "t_sym",
    "x_sym",
    "y_sym",
    "pack_symbolic_txy_with_derivatives",
    "pack_analytical_txy_with_o2fdm_derivatives",
    "MMSCaseBase",
    "MMSCaseSymbolic",
    "MMSCaseFromAnalytic",
    "state_from_mms_when",
    "cases",
]
