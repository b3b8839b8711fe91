"""Manufactured-solution cases (counterpart of :mod:`na_dd_tpu.mms.cases`).
This slice carries the smooth baseline case of the main path."""

from __future__ import annotations

from na_dd_tpu_torch.mms.engine import MMSCaseSymbolic, t_sym, x_sym, y_sym

_W_POLY = x_sym * (1 - x_sym) * y_sym * (1 - y_sym)


class MMSCasePol(MMSCaseSymbolic):
    """f = x(1-x)y(1-y)/(1+t), all five fields equal."""

    def __init__(self, grid, *, model):
        f = _W_POLY / (1 + t_sym)
        super().__init__(
            grid=grid,
            model=model,
            cp_sym_expr=f,
            T_sym_expr=f,
            cl_sym_expr=f,
            cd_sym_expr=f,
            cs_sym_expr=f,
        )
