"""Manufactured solutions and their forcing, derived from the continuous
model with SymPy and evaluated with plain torch.

The model (the paper's five-field system, RegHCs reaction):

    ∂t cp = −K1 cp (cl+1) − K2 T cp                                   + fcp
    ∂t T  = DT ΔT − K3 cp T                                           + fT
    ∂t cl = ∇·(Dl(cp) ∇cl − V(T)(cl+1)) − K4 cp (cl+1)                + fcl
    ∂t cd = ∇·(Dd(cp, T) ∇cd) + R                                     + fcd
    ∂t cs = −R                                                        + fcs

    R = Kd (Sd − cd)(cl+1) H_η(cs),  H_η(c) = 1 / (1 + e^{−η c})
    Dl(cp) = Dl_max e^{−φl cp},  Dd(cp, T) = Dd_max e^{−φd cp} e^{−φT/(T+T_ref)},
    V(T) = (γT T, 0, 0)

Each forcing term is ∂t u − (right-hand side without forcing) of the exact
solution, differentiated here from the model above (not from any code of
the program), with η a symbol, so one closure serves every member of a
batch.  The cp forcing is used as its dual-cell average (3-point
Gauss–Legendre in each direction), the other terms pointwise.
"""

from __future__ import annotations

import math

import sympy
import torch

T_SYM = sympy.Symbol("t", real=True)
X_SYMS = sympy.symbols("x y z", real=True)
ETA_SYM = sympy.Symbol("eta", positive=True)
FIELDS = ("cp", "T", "cl", "cd", "cs")

# names the lambdified code looks up: torch for tensors, math for numbers
_MODULES = [{"exp": torch.exp, "sin": torch.sin, "cos": torch.cos, "sqrt": torch.sqrt,
             "log": torch.log}, "math"]


def exact_expressions(case: str, dim: int):
    """The five exact fields of ``case`` ("pol": x(1−x)y(1−y)/(1+t), all
    five equal; "expsin": e^{−t} Π sin(π x_a), all five equal)."""
    xs = X_SYMS[:dim]
    if case == "pol":
        u = sympy.Integer(1)
        for x in xs:
            u = u * x * (1 - x)
        u = u / (1 + T_SYM)
    elif case == "expsin":
        u = sympy.exp(-T_SYM)
        for x in xs:
            u = u * sympy.sin(sympy.pi * x)
    else:
        raise ValueError(f"unknown manufactured solution {case!r}")
    return {name: u for name in FIELDS}


def forcing_expressions(ex, consts: dict, dim: int):
    """{field: forcing} of the exact fields ``ex`` under the model; the cp
    entry is the pointwise term, averaged later."""
    c = {k: sympy.Float(v) if isinstance(v, float) else v for k, v in consts.items()}
    xs = X_SYMS[:dim]
    cp, T, cl, cd, cs = (ex[k] for k in FIELDS)
    Dl = c["Dl_max"] * sympy.exp(-c["phi_l"] * cp)
    Dd = c["Dd_max"] * sympy.exp(-c["phi_d"] * cp) * sympy.exp(-c["phi_T"] / (T + c["T_ref"]))
    V = [c["gamma_T"] * T] + [sympy.Integer(0)] * (dim - 1)
    H = 1 / (1 + sympy.exp(-ETA_SYM * cs))
    R = c["Kd"] * (c["Sd"] - cd) * (cl + 1) * H

    def dt(u):
        return sympy.diff(u, T_SYM)

    rhs = {
        "cp": -c["K1"] * cp * (cl + 1) - c["K2"] * T * cp,
        "T": sum(sympy.diff(c["DT"] * sympy.diff(T, x), x) for x in xs) - c["K3"] * cp * T,
        "cl": sum(sympy.diff(Dl * sympy.diff(cl, x) - v * (cl + 1), x) for x, v in zip(xs, V))
        - c["K4"] * cp * (cl + 1),
        "cd": sum(sympy.diff(Dd * sympy.diff(cd, x), x) for x in xs) + R,
        "cs": -R,
    }
    return {k: dt(ex[k]) - rhs[k] for k in FIELDS}


def lambdify(expr, dim: int):
    """``f(t, coords, eta)`` → tensor of the coordinates' shape."""
    fn = sympy.lambdify((T_SYM, *X_SYMS[:dim], ETA_SYM), expr, modules=_MODULES)

    def call(t, coords, eta):
        out = fn(t, *coords, eta)
        like = coords[0]
        if not isinstance(out, torch.Tensor):
            out = torch.tensor(float(out), dtype=like.dtype, device=like.device)
        return torch.broadcast_to(out, torch.broadcast_shapes(out.shape, like.shape))

    return call


class Manufactured:
    """The exact fields and forcing of one case, as torch closures."""

    _GL = ((5.0 / 9.0, -math.sqrt(3.0 / 5.0)), (8.0 / 9.0, 0.0), (5.0 / 9.0, math.sqrt(3.0 / 5.0)))

    def __init__(self, case: str, consts: dict, dim: int):
        self.dim = dim
        ex = exact_expressions(case, dim)
        forcing = forcing_expressions(ex, consts, dim)
        # fields with one expression share one closure and one evaluation
        closures = {v: lambdify(v, dim) for v in set(ex.values())}
        self.exact = {k: closures[v] for k, v in ex.items()}
        self.forcing = {k: lambdify(v, dim) for k, v in forcing.items()}

    def exact_state(self, grid, t):
        values = {}
        out = {}
        for k in FIELDS:
            fn = self.exact[k]
            if id(fn) not in values:
                values[id(fn)] = fn(t, grid.coords, 0.0) * torch.ones_like(grid.mask)
            out[k] = values[id(fn)]
        return out

    def forcing_terms(self, grid, t, eta):
        """{field: forcing at t}; cp averaged over each interior dual cell,
        0 on the boundary."""
        out = {k: self.forcing[k](t, grid.coords, eta) for k in FIELDS if k != "cp"}
        acc = 0.0
        for combo in _product(self._GL, self.dim):
            w = 1.0
            pts = []
            for a, (wa, na) in enumerate(combo):
                w = w * wa
                pts.append(grid.dual_lo[a] + 0.5 * (na + 1.0) * grid.dual_w[a])
            acc = acc + w * self.forcing["cp"](t, pts, eta)
        out["cp"] = acc * (0.5 ** self.dim) * grid.mask
        return out


def _product(items, n):
    if n == 0:
        yield ()
        return
    for head in items:
        for rest in _product(items, n - 1):
            yield (head, *rest)
