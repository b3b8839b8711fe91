"""3-D Method-of-Manufactured-Solutions engine: SymPy (t, x, y, z) → torch
closures (counterpart of :mod:`na_dd_tpu.three_d.mms`).

The symbolic differentiation is the JAX package's; lambdification targets
torch through the 2-D engine's printer (:mod:`na_dd_tpu_torch.mms.engine`,
:func:`~na_dd_tpu_torch.mms.engine.lambdify_torch`): ``t`` becomes a 0-d
tensor of the grid's dtype and device, and an expression free of x, y and z
(a derivative that is 0, say) is broadcast to the grid.  The
JAX package's TPU guards (the ``optimization_barrier`` on time and the
separable dispatch) are not carried over.
"""

from __future__ import annotations

from typing import Callable, Dict

import sympy
import torch

from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.mms.engine import as_time, lambdify_torch, t_sym, x_sym, y_sym
from na_dd_tpu_torch.three_d.grid import Grid3

#: third spatial symbol; t, x and y are shared with the 2-D engine
z_sym = sympy.Symbol("z", negative=False, real=True)


def _wrap_shape3(raw: Callable) -> Callable:
    def wrapped(t, xx, yy, zz):
        res = raw(as_time(t, xx), xx, yy, zz)
        res = torch.as_tensor(res, dtype=xx.dtype, device=xx.device)
        return torch.broadcast_to(res, xx.shape).contiguous()

    return wrapped


def pack_symbolic_txyz_with_derivatives(
    *,
    base_expr: sympy.Expr,
    t_var: sympy.Symbol = t_sym,
    x_var: sympy.Symbol = x_sym,
    y_var: sympy.Symbol = y_sym,
    z_var: sympy.Symbol = z_sym,
) -> Dict[str, Callable]:
    """Differentiate symbolically and lambdify to torch.  Returns callables
    ``{base, dt, dtt, dx, dy, dz, dxx, dyy, dzz, lap}``, each mapping
    (t, xx, yy, zz) to a tensor of xx's shape."""
    dt_expr = sympy.diff(base_expr, t_var)
    exprs = {
        "base": base_expr,
        "dt": dt_expr,
        "dtt": sympy.diff(dt_expr, t_var),
        "dx": sympy.diff(base_expr, x_var),
        "dy": sympy.diff(base_expr, y_var),
        "dz": sympy.diff(base_expr, z_var),
    }
    exprs["dxx"] = sympy.diff(exprs["dx"], x_var)
    exprs["dyy"] = sympy.diff(exprs["dy"], y_var)
    exprs["dzz"] = sympy.diff(exprs["dz"], z_var)
    exprs["lap"] = exprs["dxx"] + exprs["dyy"] + exprs["dzz"]
    return {
        name: _wrap_shape3(lambdify_torch([t_var, x_var, y_var, z_var], expr))
        for name, expr in exprs.items()
    }


_VARS = ("cp", "T", "cl", "cd", "cs")
_DERIVS = {
    "": "base",
    "dt_": "dt",
    "dtt_": "dtt",
    "dx_": "dx",
    "dy_": "dy",
    "dz_": "dz",
    "dxx_": "dxx",
    "dyy_": "dyy",
    "dzz_": "dzz",
    "lap_": "lap",
}


class MMSCaseSymbolic3:
    """MMS case defined by five SymPy expressions in (t, x, y, z), with the
    accessors ``cp``, ``dt_cp``, ``dz_cp``, ``lap_cp``, … of the 2-D case
    plus the z derivatives."""

    def __init__(
        self,
        *,
        grid: Grid3,
        model,
        cp_sym_expr: sympy.Expr,
        T_sym_expr: sympy.Expr,
        cl_sym_expr: sympy.Expr,
        cd_sym_expr: sympy.Expr,
        cs_sym_expr: sympy.Expr,
    ):
        self._grid = grid
        self._model = model
        self._exprs = {
            "cp": cp_sym_expr,
            "T": T_sym_expr,
            "cl": cl_sym_expr,
            "cd": cd_sym_expr,
            "cs": cs_sym_expr,
        }
        self._packs = {
            var: pack_symbolic_txyz_with_derivatives(base_expr=expr)
            for var, expr in self._exprs.items()
        }

    @property
    def grid(self):
        return self._grid

    @property
    def model(self):
        return self._model


def _install_symbolic_accessors3():
    for var in _VARS:
        for prefix, key in _DERIVS.items():

            def method(self, t, xx, yy, zz, _var=var, _key=key):
                return self._packs[_var][_key](t, xx, yy, zz)

            setattr(MMSCaseSymbolic3, f"{prefix}{var}", method)


_install_symbolic_accessors3()


def state_from_mms_when3(*, mms_case, t, grid: Grid3) -> State:
    """The exact 3-D solution at time t as a State."""
    xx, yy, zz = grid.xx, grid.yy, grid.zz
    return State(
        cp=mms_case.cp(t, xx, yy, zz),
        T=mms_case.T(t, xx, yy, zz),
        cl=mms_case.cl(t, xx, yy, zz),
        cd=mms_case.cd(t, xx, yy, zz),
        cs=mms_case.cs(t, xx, yy, zz),
    )


_W_POLY3 = x_sym * (1 - x_sym) * y_sym * (1 - y_sym) * z_sym * (1 - z_sym)


class MMSCasePol3(MMSCaseSymbolic3):
    """The polynomial bump x(1−x)y(1−y)z(1−z) times
    φ(t) = ampl (1 + shrink sin(speed t)), all five fields equal."""

    def __init__(self, grid, model, *, ampl: float = 1, speed: float = 1, shrink: float = 1):
        profile = ampl * (1 + shrink * sympy.sin(speed * t_sym)) * _W_POLY3
        super().__init__(
            grid=grid,
            model=model,
            cp_sym_expr=profile,
            T_sym_expr=profile,
            cl_sym_expr=profile,
            cd_sym_expr=profile,
            cs_sym_expr=profile,
        )


class MMSCaseCsZeroCrossing3(MMSCaseSymbolic3):
    """cp = T = cl = cd = 0; cs = (A − B t) W crosses zero — exercises the
    Heaviside switching in 3-D."""

    def __init__(self, grid, model, *, cs_A: float = 0.5, cs_B: float = 1.0):
        zero = sympy.S(0)
        cs = (sympy.Float(cs_A) - sympy.Float(cs_B) * t_sym) * _W_POLY3
        super().__init__(
            grid=grid,
            model=model,
            cp_sym_expr=zero,
            T_sym_expr=zero,
            cl_sym_expr=zero,
            cd_sym_expr=zero,
            cs_sym_expr=cs,
        )


class MMSCaseExpSin3(MMSCaseSymbolic3):
    """W = sin(πx) sin(πy) sin(πz), φ(t) = e^{-a t}, all five fields equal —
    the 3-D study's case."""

    def __init__(self, grid, model, *, a: float = 1.0):
        pi = sympy.pi
        profile = (
            sympy.exp(-a * t_sym)
            * sympy.sin(pi * x_sym)
            * sympy.sin(pi * y_sym)
            * sympy.sin(pi * z_sym)
        )
        super().__init__(
            grid=grid,
            model=model,
            cp_sym_expr=profile,
            T_sym_expr=profile,
            cl_sym_expr=profile,
            cd_sym_expr=profile,
            cs_sym_expr=profile,
        )
