"""Method-of-Manufactured-Solutions engine: SymPy exact solutions → torch
closures (counterpart of :mod:`na_dd_tpu.mms.engine`).

The symbolic differentiation is the JAX package's; lambdification targets
torch.  Each closure maps ``(t, xx, yy)`` to a tensor of ``xx``'s shape:

* ``t`` becomes a 0-d tensor of ``xx``'s dtype on ``xx``'s device before the
  call (torch's ``exp`` and friends refuse a Python float);
* an expression free of x and y comes back 0-d and is broadcast to the grid.

The JAX package's TPU workarounds (the ``optimization_barrier`` time guards
and the separable Σ f(t)·g(x,y) dispatch) are not carried over: both exist
for the TPU's emulated f64.
"""

from __future__ import annotations

from typing import Callable, Dict

import sympy
import torch

from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.ops.grid import Grid

# 0 < t, 0 <= x, y <= 1: the nonnegativity lets SymPy simplify |·|
# derivatives like the reference.
t_sym, x_sym, y_sym = sympy.symbols("t x y", negative=False, real=True)


def _dirac_delta(arg):
    """Numeric DiracDelta stub of the reference: 1 within 1e-13 of 0, else 0."""
    return torch.where(torch.abs(arg) < 1e-13, torch.ones_like(arg), torch.zeros_like(arg))


_TORCH_MODULES = [{"DiracDelta": _dirac_delta}, "torch"]


def as_time(t, like: torch.Tensor) -> torch.Tensor:
    """``t`` as a 0-d tensor of ``like``'s dtype and device."""
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def _wrap_shape(raw: Callable) -> Callable:
    def wrapped(t, xx, yy):
        res = raw(as_time(t, xx), xx, yy)
        res = torch.as_tensor(res, dtype=xx.dtype, device=xx.device)
        return torch.broadcast_to(res, xx.shape)

    return wrapped


def pack_symbolic_txy_with_derivatives(
    *,
    base_expr: sympy.Expr,
    t_var: sympy.Symbol = t_sym,
    x_var: sympy.Symbol = x_sym,
    y_var: sympy.Symbol = y_sym,
) -> Dict[str, Callable]:
    """Differentiate ``base_expr`` symbolically and lambdify to torch.

    Returns callables ``{base, dt, dtt, dx, dy, dxx, dyy, lap}``.
    """
    dt_expr = sympy.diff(base_expr, t_var)
    exprs = {
        "base": base_expr,
        "dt": dt_expr,
        "dtt": sympy.diff(dt_expr, t_var),
        "dx": sympy.diff(base_expr, x_var),
        "dy": sympy.diff(base_expr, y_var),
    }
    exprs["dxx"] = sympy.diff(exprs["dx"], x_var)
    exprs["dyy"] = sympy.diff(exprs["dy"], y_var)
    exprs["lap"] = exprs["dxx"] + exprs["dyy"]
    return {
        name: _wrap_shape(
            sympy.lambdify([t_var, x_var, y_var], expr, modules=_TORCH_MODULES)
        )
        for name, expr in exprs.items()
    }


class MMSCaseBase:
    """Exact-solution protocol: values and analytic derivatives of the five
    fields."""

    def __init__(self, grid: Grid, model):
        self._grid = grid
        self._model = model

    @property
    def grid(self):
        return self._grid

    @property
    def model(self):
        return self._model


_VARS = ("cp", "T", "cl", "cd", "cs")
_DERIVS = {
    "": "base",
    "dt_": "dt",
    "dtt_": "dtt",
    "dx_": "dx",
    "dy_": "dy",
    "dxx_": "dxx",
    "dyy_": "dyy",
    "lap_": "lap",
}


class MMSCaseSymbolic(MMSCaseBase):
    """MMS case defined by five SymPy expressions in (t, x, y)."""

    def __init__(
        self,
        *,
        grid: Grid,
        model,
        cp_sym_expr: sympy.Expr,
        T_sym_expr: sympy.Expr,
        cl_sym_expr: sympy.Expr,
        cd_sym_expr: sympy.Expr,
        cs_sym_expr: sympy.Expr,
        t_var: sympy.Symbol = t_sym,
        x_var: sympy.Symbol = x_sym,
        y_var: sympy.Symbol = y_sym,
    ):
        super().__init__(grid, model)
        self._exprs = {
            "cp": cp_sym_expr,
            "T": T_sym_expr,
            "cl": cl_sym_expr,
            "cd": cd_sym_expr,
            "cs": cs_sym_expr,
        }
        self._packs = {
            var: pack_symbolic_txy_with_derivatives(
                base_expr=expr, t_var=t_var, x_var=x_var, y_var=y_var
            )
            for var, expr in self._exprs.items()
        }


def _install_symbolic_accessors():
    """Generate cp/dt_cp/dx_cp/... accessor methods on MMSCaseSymbolic."""
    for var in _VARS:
        for prefix, key in _DERIVS.items():

            def method(self, t, xx, yy, _var=var, _key=key):
                return self._packs[_var][_key](t, xx, yy)

            setattr(MMSCaseSymbolic, f"{prefix}{var}", method)


_install_symbolic_accessors()


def state_from_mms_when(*, mms_case, t, grid: Grid) -> State:
    """The exact solution at time t as a State."""
    xx, yy = grid.xx, grid.yy
    return State(
        cp=mms_case.cp(t, xx, yy),
        T=mms_case.T(t, xx, yy),
        cl=mms_case.cl(t, xx, yy),
        cd=mms_case.cd(t, xx, yy),
        cs=mms_case.cs(t, xx, yy),
    )
