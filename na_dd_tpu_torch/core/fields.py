"""Semi-discrete fields: the spatially discretized right-hand sides
(counterpart of :mod:`na_dd_tpu.core.fields`).

    Fcp = -K1 cp (cl + 1) - K2 T cp                      + fcp   (pointwise)
    FT  = D*_x(DT D_{-x} T) + D*_y(DT D_{-y} T) - K3 cp T + fT
    Fcl = D*_x(Dl(Mx cp) D_{-x} cl - Mx(V1(T)(cl+1)))
        + D*_y(Dl(My cp) D_{-y} cl - My(V2(T)(cl+1)))
        - K4 cp (cl + 1)                                  + fcl
    Fcd = D*_x(Dd(Mx cp, Mx T) D_{-x} cd)
        + D*_y(Dd(My cp, My T) D_{-y} cd) + [Cs-Cd-int]   + fcd
    Fcs = -[Cs-Cd-int]                                    + fcs

    [Cs-Cd-int] = F1(cp) (a_T T + b_T)(a_cl cl + b_cl)(a_cd cd + b_cd) F2(cs)

The stencil and reaction parts are added on the interior only; the forcing
keeps its boundary values, as in the reference.  FT, Fcl and Fcd are linear
in their own variable, so their self-Jacobians are 5-point stencils with
closed-form planes (``stencil_dF*_d*``).  The cross couplings dFcl/dT,
dFcd/dT and dFcd/dcl that the triangular Newton sweep applies to the
preceding solves' increments have closed forms too (``stencil_dFcl_dT``,
``stencil_dFcd_dT``, ``diag_dFcd_dcl``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from na_dd_tpu_torch.core.state import State, heaviside_regularized
from na_dd_tpu_torch.models.coefficients import Model01
from na_dd_tpu_torch.ops.grid import Grid
from na_dd_tpu_torch.ops.linsolve import (
    Stencil5,
    advection_planes,
    diffusion_planes,
    midpoint_coupling_planes,
    stencil_add_diag,
)
from na_dd_tpu_torch.ops.shifts import Ops
from na_dd_tpu_torch.ops.stencils import Dx_reg, Dx_star, Dy_reg, Dy_star, Mx, My


class Field01Base:
    """Shared triangular-coupling field; subclasses fix F2(cs)."""

    def __init__(self, *, grid: Grid, model: Model01, forcing):
        self.grid = grid
        self.model = model
        self.forcing = forcing

    # reaction factorization
    def cscd_reaction_T(self) -> Tuple[float, float]:
        return (0.0, 1.0)

    def cscd_reaction_cl(self) -> Tuple[float, float]:
        return (1.0, 1.0)

    def cscd_reaction_cd(self) -> Tuple[float, float]:
        return (-1.0, self.model.Sd)

    def cscd_reaction_cp(self, cp):
        return torch.ones_like(cp)

    def cscd_reaction_cs(self, cs):  # pragma: no cover - abstract
        raise NotImplementedError

    def cscd_reaction_term(self, g: Grid, s: State):
        a_T, b_T = self.cscd_reaction_T()
        a_cl, b_cl = self.cscd_reaction_cl()
        a_cd, b_cd = self.cscd_reaction_cd()
        return (
            self.cscd_reaction_cp(s.cp)
            * (a_T * s.T + b_T)
            * (a_cl * s.cl + b_cl)
            * (a_cd * s.cd + b_cd)
            * self.cscd_reaction_cs(s.cs)
            * g.interior_mask
        )

    # the five right-hand sides
    def Fcp(self, g: Grid, ops: Ops, s: State, t):
        m = self.model
        out = self.forcing.fcp(g, ops, t)
        return out + g.interior_mask * (
            -m.K1 * (s.cl + 1.0) * s.cp - m.K2 * s.T * s.cp
        )

    def FT(self, g: Grid, ops: Ops, s: State, t):
        m = self.model
        DmxT = Dx_reg(ops, g, s.T)
        DmyT = Dy_reg(ops, g, s.T)
        out = self.forcing.fT(g, ops, t)
        return out + g.interior_mask * (
            Dx_star(ops, g, m.DT * DmxT)
            + Dy_star(ops, g, m.DT * DmyT)
            - m.K3 * s.cp * s.T
        )

    def Fcl(self, g: Grid, ops: Ops, s: State, t):
        m = self.model
        Dl_Mxcp = m.Dl(Mx(ops, g, s.cp))
        Dl_Mycp = m.Dl(My(ops, g, s.cp))
        V1T = m.V1(s.T)
        V2T = m.V2(s.T)
        flux_x = Dl_Mxcp * Dx_reg(ops, g, s.cl) - Mx(ops, g, V1T * (s.cl + 1.0))
        flux_y = Dl_Mycp * Dy_reg(ops, g, s.cl) - My(ops, g, V2T * (s.cl + 1.0))
        out = self.forcing.fcl(g, ops, t)
        return out + g.interior_mask * (
            Dx_star(ops, g, flux_x)
            + Dy_star(ops, g, flux_y)
            - m.K4 * s.cp * (s.cl + 1.0)
        )

    def Fcd(self, g: Grid, ops: Ops, s: State, t):
        m = self.model
        Dd_x = m.Dd(Mx(ops, g, s.cp), Mx(ops, g, s.T))
        Dd_y = m.Dd(My(ops, g, s.cp), My(ops, g, s.T))
        out = self.forcing.fcd(g, ops, t)
        return out + g.interior_mask * (
            Dx_star(ops, g, Dd_x * Dx_reg(ops, g, s.cd))
            + Dy_star(ops, g, Dd_y * Dy_reg(ops, g, s.cd))
            + self.cscd_reaction_term(g, s)
        )

    def Fcs(self, g: Grid, ops: Ops, s: State, t):
        out = self.forcing.fcs(g, ops, t) - self.cscd_reaction_term(g, s)
        return out * g.interior_mask

    # analytic self-coupling Jacobian stencils
    def stencil_dFT_dT(self, g: Grid, ops: Ops, s: State) -> Stencil5:
        """∂FT/∂T = D*(DT D_- ·) − K3·cp."""
        m = self.model
        DT = torch.full_like(s.T, m.DT)
        L = diffusion_planes(g, ops, DT, DT)
        return stencil_add_diag(L, -m.K3 * s.cp)

    def stencil_dFcl_dcl(self, g: Grid, ops: Ops, s: State) -> Stencil5:
        """∂Fcl/∂cl = D*(Dl(M cp) D_- ·) − D*(M(V(T)·)) − K4·cp."""
        m = self.model
        diff = diffusion_planes(g, ops, m.Dl(Mx(ops, g, s.cp)), m.Dl(My(ops, g, s.cp)))
        adv = advection_planes(g, ops, m.V1(s.T), m.V2(s.T))
        return Stencil5(
            c0=diff.c0 + adv.c0 - m.K4 * s.cp,
            cxm=diff.cxm + adv.cxm,
            cxp=diff.cxp + adv.cxp,
            cym=diff.cym + adv.cym,
            cyp=diff.cyp + adv.cyp,
        )

    def stencil_dFcd_dcd(self, g: Grid, ops: Ops, s: State) -> Stencil5:
        """∂Fcd/∂cd = D*(Dd(M cp, M T) D_- ·) + a_cd·[reaction/(a_cd cd + b_cd)]."""
        m = self.model
        L = diffusion_planes(
            g,
            ops,
            m.Dd(Mx(ops, g, s.cp), Mx(ops, g, s.T)),
            m.Dd(My(ops, g, s.cp), My(ops, g, s.T)),
        )
        a_T, b_T = self.cscd_reaction_T()
        a_cl, b_cl = self.cscd_reaction_cl()
        a_cd, _b_cd = self.cscd_reaction_cd()
        dreac = (
            self.cscd_reaction_cp(s.cp)
            * (a_T * s.T + b_T)
            * (a_cl * s.cl + b_cl)
            * a_cd
            * self.cscd_reaction_cs(s.cs)
            * g.interior_mask
        )
        return stencil_add_diag(L, dreac)

    # analytic cross-coupling Jacobian stencils
    def stencil_dFcl_dT(self, g: Grid, ops: Ops, s: State) -> Stencil5:
        """∂Fcl/∂T·w = −D*_x(M_x(V1'(T)(cl+1)·w)) − D*_y(M_y(V2'(T)(cl+1)·w)):
        Fcl sees T only through the advection velocity, so these are
        :func:`advection_planes` with b = V'(T)·(cl+1)."""
        m = self.model
        return advection_planes(
            g, ops, m.V1(s.T, d=1) * (s.cl + 1.0), m.V2(s.T, d=1) * (s.cl + 1.0)
        )

    def stencil_dFcd_dT(self, g: Grid, ops: Ops, s: State) -> Stencil5:
        """∂Fcd/∂T·w = D*_x(∂_T Dd(M cp, M T)·D₋x cd ⊙ M_x w) + (y) +
        a_T·[reaction factor]·w: the diffusion coefficient's T-derivative in
        midpoint-coupling form, plus the reaction diagonal (a_T = 0 in this
        model family)."""
        m = self.model
        ax = m.Dd(Mx(ops, g, s.cp), Mx(ops, g, s.T), d=(0, 1)) * Dx_reg(ops, g, s.cd)
        ay = m.Dd(My(ops, g, s.cp), My(ops, g, s.T), d=(0, 1)) * Dy_reg(ops, g, s.cd)
        st = midpoint_coupling_planes(g, ops, ax, ay)
        a_T, _b_T = self.cscd_reaction_T()
        if a_T == 0.0:
            return st
        return stencil_add_diag(st, self._dreac_dT(g, s, a_T))

    def _dreac_dT(self, g, s: State, a_T):
        """T-derivative of the reaction term (dimension-agnostic)."""
        a_cl, b_cl = self.cscd_reaction_cl()
        a_cd, b_cd = self.cscd_reaction_cd()
        return (
            self.cscd_reaction_cp(s.cp)
            * a_T
            * (a_cl * s.cl + b_cl)
            * (a_cd * s.cd + b_cd)
            * self.cscd_reaction_cs(s.cs)
            * g.interior_mask
        )

    def diag_dFcd_dcl(self, g: Grid, s: State):
        """∂Fcd/∂cl is purely diagonal: the reaction's cl-factor derivative
        (the diffusion coefficients never see cl)."""
        a_T, b_T = self.cscd_reaction_T()
        a_cl, _b_cl = self.cscd_reaction_cl()
        a_cd, b_cd = self.cscd_reaction_cd()
        return (
            self.cscd_reaction_cp(s.cp)
            * (a_T * s.T + b_T)
            * a_cl
            * (a_cd * s.cd + b_cd)
            * self.cscd_reaction_cs(s.cs)
            * g.interior_mask
        )

    def all_fields(self, g: Grid, ops: Ops, s: State, t) -> State:
        """All five right-hand sides as a State."""
        return State(
            cp=self.Fcp(g, ops, s, t),
            T=self.FT(g, ops, s, t),
            cl=self.Fcl(g, ops, s, t),
            cd=self.Fcd(g, ops, s, t),
            cs=self.Fcs(g, ops, s, t),
        )


class FieldCsTriple(Field01Base):
    """[Cs-Cd-int] = Kd (Sd - cd)(1 + cl) cs."""

    def cscd_reaction_cs(self, cs):
        return self.model.Kd * cs


class FieldHCsTriple(Field01Base):
    """[Cs-Cd-int] = Kd (Sd - cd)(1 + cl) 1{cs>0}."""

    def cscd_reaction_cs(self, cs):
        return self.model.Kd * (cs > 0).to(cs.dtype)


class FieldRegHCsTriple(Field01Base):
    """[Cs-Cd-int] = Kd (Sd - cd)(1 + cl) H_eta(cs) — the paper's headline
    scheme."""

    def __init__(self, *, grid: Grid, model: Model01, forcing, regularization_factor):
        super().__init__(grid=grid, model=model, forcing=forcing)
        self.regularization_factor = regularization_factor

    def cscd_reaction_cs(self, cs):
        return self.model.Kd * heaviside_regularized(cs, self.regularization_factor)
