"""Nonlinear coefficients Dl, V1, V2, V3, Dd and their derivatives (counterpart of
:mod:`na_dd_tpu.models.coefficients`).

Dual dispatch as in the JAX package: SymPy expressions go to the symbolic
branch (the MMS forcing derivation), tensors to the numeric one.  The
``T = 0`` limit of ``exp(-phi_T / T)`` is 0 and is taken with a double
``torch.where``, so neither the value nor a ``torch.func.jvp`` tangent sees a
NaN.
"""

from __future__ import annotations

import sympy
import torch

from na_dd_tpu_torch.models.consts import ModelConsts


class Model01:
    """Dl(cp) = Dl_max e^{-φ_l cp}, V = (γ_T T, 0) (and V3 = 0 in 3-D),
    Dd(cp, T) = Dd_max e^{-φ_d cp} e^{-φ_T/T}."""

    def __init__(self, mc: ModelConsts):
        for k, v in mc._asdict().items():
            setattr(self, k, v)

    def Dl(self, cp, *, d: int = 0):
        """Dl = Dl_max exp(-phi_l cp); d-th derivative in cp."""
        if isinstance(cp, sympy.Expr):
            return sympy.diff(self.Dl_max * sympy.exp(-self.phi_l * cp), cp, d)
        return ((-self.phi_l) ** d) * self.Dl_max * torch.exp(-self.phi_l * cp)

    def V1(self, T, *, d: int = 0):
        """V1 = gamma_T * T."""
        if isinstance(T, sympy.Expr):
            return sympy.diff(self.gamma_T * T, T, d)
        if d == 0:
            return self.gamma_T * T
        if d == 1:
            return self.gamma_T * torch.ones_like(T)
        return torch.zeros_like(T)

    def V2(self, T, *, d: int = 0):
        """V2 = 0."""
        if isinstance(T, sympy.Expr):
            return sympy.S(0)
        return torch.zeros_like(T)

    def V3(self, T, *, d: int = 0):
        """V3 = 0: the z component of the velocity in 3-D (the model's
        velocity is along x only)."""
        if isinstance(T, sympy.Expr):
            return sympy.S(0)
        return torch.zeros_like(T)

    def Dd(self, cp, T, *, d=(0, 0)):
        """Dd = Dd_max exp(-phi_d cp) exp(-phi_T / T), with Dd(., 0) := 0.

        ``d = (d_cp, d_T)``: (0,0), (1,0) or (0,1).
        """
        sym_cp = isinstance(cp, sympy.Expr)
        sym_T = isinstance(T, sympy.Expr)
        assert sym_cp == sym_T, "cp and T must both be symbolic or both numeric"
        if sym_cp:
            expr = (
                self.Dd_max * sympy.exp(-self.phi_d * cp) * sympy.exp(-self.phi_T / T)
            )
            return sympy.diff(sympy.diff(expr, cp, d[0]), T, d[1])

        tnz = T != 0
        T_safe = torch.where(tnz, T, torch.ones_like(T))  # NaN-safe value and tangent
        base = torch.where(
            tnz,
            self.Dd_max * torch.exp(-self.phi_d * cp) * torch.exp(-self.phi_T / T_safe),
            torch.zeros_like(T),
        )
        if d == (0, 0):
            return base
        if d == (1, 0):
            return -self.phi_d * base
        if d == (0, 1):
            return torch.where(tnz, base * self.phi_T / (T_safe**2), torch.zeros_like(T))
        raise ValueError(f"unsupported derivative spec {d!r}")


class Model02(Model01):
    """Temperature-shifted Dd: Dd(cp, T) := Model01.Dd(cp, T + T_ref)."""

    def Dd(self, cp, T, *, d=(0, 0)):
        return super().Dd(cp, T + self.T_ref, d=d)
