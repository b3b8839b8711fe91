"""Method-of-Manufactured-Solutions engine: SymPy exact solutions → torch
closures (counterpart of :mod:`na_dd_tpu.mms.engine`).

The symbolic differentiation is the JAX package's; lambdification targets
torch.  Each closure maps ``(t, xx, yy)`` to a tensor of ``xx``'s shape:

* ``t`` becomes a 0-d tensor of ``xx``'s dtype on ``xx``'s device before the
  call (torch's ``exp`` and friends refuse a Python float);
* an expression free of x and y comes back 0-d and is broadcast to the grid
  into a tensor of its own (a broadcast view, such as the zero fields of the
  zero-crossing case, cannot be a primal of ``torch.func.jvp``).

The JAX package's TPU workarounds (the ``optimization_barrier`` time guards
and the separable Σ f(t)·g(x,y) dispatch) are not carried over: both exist
for the TPU's emulated f64.

``DiracDelta`` (from differentiating ``Abs`` in the low-regularity cases) is
stubbed numerically as in the reference: 1 within 1e-13 of zero, else 0.
SymPy's ``TorchPrinter`` refuses it, so the closures are printed by
:class:`MMSTorchPrinter`, which the 3-D engine shares.
"""

from __future__ import annotations

from typing import Callable, Dict

import sympy
import torch
from sympy.printing.pytorch import TorchPrinter

from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.ops.grid import Grid

# 0 < t, 0 <= x, y <= 1: the nonnegativity lets SymPy simplify |·|
# derivatives like the reference.
t_sym, x_sym, y_sym = sympy.symbols("t x y", negative=False, real=True)


def _dirac_delta(arg):
    """Numeric DiracDelta stub of the reference: 1 within 1e-13 of 0, else 0."""
    return torch.where(torch.abs(arg) < 1e-13, torch.ones_like(arg), torch.zeros_like(arg))


_TORCH_MODULES = [{"DiracDelta": _dirac_delta}, "torch"]


class MMSTorchPrinter(TorchPrinter):
    """``TorchPrinter`` for the MMS closures:

    * ``DiracDelta(arg)`` becomes a call of :func:`_dirac_delta` (the name
      ``DiracDelta`` in :data:`_TORCH_MODULES`), its argument printed by this
      printer, so a constant such as 1/π in it is a number;
    * a power of two numbers, e.g. the π² of ``exp(-2π² DT t)``, is Python's
      ``**`` on floats: ``torch.pow`` takes no two Python numbers.
    """

    def _print_DiracDelta(self, expr):
        return f"DiracDelta({self._print(expr.args[0])})"

    def _print_Pow(self, expr, **kwargs):
        if expr.base.is_number and expr.exp.is_number:
            return f"({self._print(expr.base)})**({self._print(expr.exp)})"
        return super()._print_Pow(expr, **kwargs)


def lambdify_torch(args, expr) -> Callable:
    """``sympy.lambdify`` to torch through :class:`MMSTorchPrinter`, with the
    settings lambdify gives the printer it makes itself (bare names from the
    module namespace), so every closure free of the two cases above prints
    as with SymPy's own ``TorchPrinter``."""
    printer = MMSTorchPrinter(
        {"fully_qualified_modules": False, "inline": True, "allow_unknown_functions": True}
    )
    return sympy.lambdify(args, expr, modules=_TORCH_MODULES, printer=printer)


def as_time(t, like: torch.Tensor) -> torch.Tensor:
    """``t`` as a 0-d tensor of ``like``'s dtype and device."""
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def _wrap_shape(raw: Callable) -> Callable:
    def wrapped(t, xx, yy):
        res = raw(as_time(t, xx), xx, yy)
        res = torch.as_tensor(res, dtype=xx.dtype, device=xx.device)
        return torch.broadcast_to(res, xx.shape).contiguous()

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
        name: _wrap_shape(lambdify_torch([t_var, x_var, y_var], expr))
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


def pack_analytical_txy_with_o2fdm_derivatives(
    fn: Callable,
    *,
    default_eps: float = 1e-6,
    time_stepping: str = "center",
) -> Callable:
    """Wrap a plain f(t, x, y) with O(2) finite-difference derivatives, for
    solutions that SymPy cannot express.  ``enhanced(t, x, y, d=(dt, dx,
    dy))`` takes one derivative order per variable (combined order at most
    2), or ``op="lap"``; ``time_stepping`` picks the one-sided ("forward",
    "backward") or central time differences."""

    def dt1(t, x, y, eps):
        if time_stepping == "forward":
            return (-3 * fn(t, x, y) + 4 * fn(t + eps, x, y) - fn(t + 2 * eps, x, y)) / (2 * eps)
        if time_stepping == "backward":
            return (3 * fn(t, x, y) - 4 * fn(t - eps, x, y) + fn(t - 2 * eps, x, y)) / (2 * eps)
        return (fn(t + eps, x, y) - fn(t - eps, x, y)) / (2 * eps)

    def dt2(t, x, y, eps):
        if time_stepping == "forward":
            return (2 * fn(t, x, y) - 5 * fn(t + eps, x, y) + 4 * fn(t + 2 * eps, x, y) - fn(t + 3 * eps, x, y)) / (eps * eps)
        if time_stepping == "backward":
            return (2 * fn(t, x, y) - 5 * fn(t - eps, x, y) + 4 * fn(t - 2 * eps, x, y) - fn(t - 3 * eps, x, y)) / (eps * eps)
        return (fn(t + eps, x, y) - 2 * fn(t, x, y) + fn(t - eps, x, y)) / (eps * eps)

    if time_stepping not in ("forward", "center", "backward"):
        raise ValueError("Invalid time stepping strategy")

    def enhanced(t, x, y, *, d=(0, 0, 0), op=None, small_eps=None):
        eps = small_eps or default_eps
        if op is not None:
            if op.lower() in ("laplacian", "lap"):
                return (
                    fn(t, x + eps, y)
                    + fn(t, x - eps, y)
                    + fn(t, x, y + eps)
                    + fn(t, x, y - eps)
                    - 4 * fn(t, x, y)
                ) / (eps * eps)
            raise ValueError(f"Unknown operator: {op}")
        dt, dx, dy = d
        if not all(v in (0, 1, 2) for v in d):
            raise ValueError("Individual derivatives must be 0, 1, or 2")
        if dt + dx + dy > 2:
            raise ValueError("Combined derivative order must be 0, 1, or 2")
        if dt == 1:
            return dt1(t, x, y, eps)
        if dt == 2:
            return dt2(t, x, y, eps)
        if dx == 1 and dy == 1:
            return (
                fn(t, x + eps, y + eps)
                - fn(t, x + eps, y - eps)
                - fn(t, x - eps, y + eps)
                + fn(t, x - eps, y - eps)
            ) / (4 * eps * eps)
        if dx == 1:
            return (fn(t, x + eps, y) - fn(t, x - eps, y)) / (2 * eps)
        if dx == 2:
            return (fn(t, x + eps, y) - 2 * fn(t, x, y) + fn(t, x - eps, y)) / (eps * eps)
        if dy == 1:
            return (fn(t, x, y + eps) - fn(t, x, y - eps)) / (2 * eps)
        if dy == 2:
            return (fn(t, x, y + eps) - 2 * fn(t, x, y) + fn(t, x, y - eps)) / (eps * eps)
        return fn(t, x, y)

    return enhanced


class MMSCaseFromAnalytic(MMSCaseBase):
    """MMS case from plain callables f(t, xx, yy) on tensors, with
    finite-difference derivatives (``t`` reaches them as a 0-d tensor of the
    grid's dtype and device)."""

    def __init__(self, model, *, grid: Grid, cp_base, T_base, cl_base, cd_base, cs_base):
        super().__init__(grid, model)
        self._ex = {
            "cp": pack_analytical_txy_with_o2fdm_derivatives(cp_base),
            "T": pack_analytical_txy_with_o2fdm_derivatives(T_base),
            "cl": pack_analytical_txy_with_o2fdm_derivatives(cl_base),
            "cd": pack_analytical_txy_with_o2fdm_derivatives(cd_base),
            "cs": pack_analytical_txy_with_o2fdm_derivatives(cs_base),
        }


def _install_analytic_accessors():
    specs = {
        "": dict(d=(0, 0, 0)),
        "dt_": dict(d=(1, 0, 0)),
        "dx_": dict(d=(0, 1, 0)),
        "dy_": dict(d=(0, 0, 1)),
        "dxx_": dict(d=(0, 2, 0)),
        "dyy_": dict(d=(0, 0, 2)),
    }
    for var in _VARS:
        for prefix, kw in specs.items():

            def method(self, t, xx, yy, _var=var, _kw=kw):
                return self._ex[_var](as_time(t, xx), xx, yy, **_kw)

            setattr(MMSCaseFromAnalytic, f"{prefix}{var}", method)

        def lap_method(self, t, xx, yy, _var=var):
            t = as_time(t, xx)
            return self._ex[_var](t, xx, yy, d=(0, 2, 0)) + self._ex[_var](t, xx, yy, d=(0, 0, 2))

        setattr(MMSCaseFromAnalytic, f"lap_{var}", lap_method)


_install_analytic_accessors()


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
