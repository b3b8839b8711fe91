"""3-D semi-discrete fields (counterpart of :mod:`na_dd_tpu.three_d.fields`).

    FT  = ∇·(DT ∇T) − K3 cp T                                     + fT
    Fcl = ∇·(Dl(M cp) ∇cl − M(V(T)(cl+1))) − K4 cp (cl+1)          + fcl
    Fcd = ∇·(Dd(M cp, M T) ∇cd) + [Cs-Cd-int]                      + fcd

with V(T) = (V1(T), V2(T), V3(T)) and every ∇ the mimetic staggered triple
of :mod:`na_dd_tpu_torch.three_d.stencils`.  Everything pointwise — Fcp,
Fcs, the reaction factorization, ``all_fields`` and the variants' cs factor
(linear, sharp or regularized Heaviside) — is inherited unchanged from
:mod:`na_dd_tpu_torch.core.fields`; the 3-D base class overrides only the
methods that touch spatial operators, and its
self- and cross-coupling Jacobians are :class:`Stencil7` planes
(``diag_dFcd_dcl`` is pointwise and inherited).
"""

from __future__ import annotations

import torch

from na_dd_tpu_torch.core.fields import (
    Field01Base,
    FieldCsTriple,
    FieldHCsTriple,
    FieldRegHCsTriple,
)
from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.three_d.diffusion import (
    Stencil7,
    advection_planes3,
    diffusion_planes3,
    midpoint_coupling_planes3,
    stencil_add_diag3,
)
from na_dd_tpu_torch.three_d.grid import Grid3
from na_dd_tpu_torch.three_d.shifts import Ops3
from na_dd_tpu_torch.three_d.stencils import (
    Dx_reg3,
    Dx_star3,
    Dy_reg3,
    Dy_star3,
    Dz_reg3,
    Dz_star3,
    Mx3,
    My3,
    Mz3,
)


class Field3Base(Field01Base):
    """Five-field 3-D semi-discrete field; subclasses fix F2(cs)."""

    def FT(self, g: Grid3, ops: Ops3, s: State, t):
        m = self.model
        out = self.forcing.fT(g, ops, t)
        return out + g.interior_mask * (
            Dx_star3(ops, g, m.DT * Dx_reg3(ops, g, s.T))
            + Dy_star3(ops, g, m.DT * Dy_reg3(ops, g, s.T))
            + Dz_star3(ops, g, m.DT * Dz_reg3(ops, g, s.T))
            - m.K3 * s.cp * s.T
        )

    def Fcl(self, g: Grid3, ops: Ops3, s: State, t):
        m = self.model
        V1T = m.V1(s.T)
        V2T = m.V2(s.T)
        V3T = m.V3(s.T)
        flux_x = m.Dl(Mx3(ops, g, s.cp)) * Dx_reg3(ops, g, s.cl) - Mx3(
            ops, g, V1T * (s.cl + 1.0)
        )
        flux_y = m.Dl(My3(ops, g, s.cp)) * Dy_reg3(ops, g, s.cl) - My3(
            ops, g, V2T * (s.cl + 1.0)
        )
        flux_z = m.Dl(Mz3(ops, g, s.cp)) * Dz_reg3(ops, g, s.cl) - Mz3(
            ops, g, V3T * (s.cl + 1.0)
        )
        out = self.forcing.fcl(g, ops, t)
        return out + g.interior_mask * (
            Dx_star3(ops, g, flux_x)
            + Dy_star3(ops, g, flux_y)
            + Dz_star3(ops, g, flux_z)
            - m.K4 * s.cp * (s.cl + 1.0)
        )

    def Fcd(self, g: Grid3, ops: Ops3, s: State, t):
        m = self.model
        Dd_x = m.Dd(Mx3(ops, g, s.cp), Mx3(ops, g, s.T))
        Dd_y = m.Dd(My3(ops, g, s.cp), My3(ops, g, s.T))
        Dd_z = m.Dd(Mz3(ops, g, s.cp), Mz3(ops, g, s.T))
        out = self.forcing.fcd(g, ops, t)
        return out + g.interior_mask * (
            Dx_star3(ops, g, Dd_x * Dx_reg3(ops, g, s.cd))
            + Dy_star3(ops, g, Dd_y * Dy_reg3(ops, g, s.cd))
            + Dz_star3(ops, g, Dd_z * Dz_reg3(ops, g, s.cd))
            + self.cscd_reaction_term(g, s)
        )

    # analytic self-coupling Jacobian stencils
    def stencil_dFT_dT(self, g: Grid3, ops: Ops3, s: State) -> Stencil7:
        """∂FT/∂T = ∇·(DT ∇·) − K3·cp."""
        m = self.model
        DT = torch.full_like(s.T, m.DT)
        L = diffusion_planes3(g, ops, DT, DT, DT)
        return stencil_add_diag3(L, -m.K3 * s.cp)

    def stencil_dFcl_dcl(self, g: Grid3, ops: Ops3, s: State) -> Stencil7:
        """∂Fcl/∂cl = ∇·(Dl(M cp) ∇·) − ∇·(M(V(T)·)) − K4·cp."""
        m = self.model
        diff = diffusion_planes3(
            g,
            ops,
            m.Dl(Mx3(ops, g, s.cp)),
            m.Dl(My3(ops, g, s.cp)),
            m.Dl(Mz3(ops, g, s.cp)),
        )
        adv = advection_planes3(g, ops, m.V1(s.T), m.V2(s.T), m.V3(s.T))
        return Stencil7(
            c0=diff.c0 + adv.c0 - m.K4 * s.cp,
            cxm=diff.cxm + adv.cxm,
            cxp=diff.cxp + adv.cxp,
            cym=diff.cym + adv.cym,
            cyp=diff.cyp + adv.cyp,
            czm=diff.czm + adv.czm,
            czp=diff.czp + adv.czp,
        )

    def stencil_dFcd_dcd(self, g: Grid3, ops: Ops3, s: State) -> Stencil7:
        """∂Fcd/∂cd = ∇·(Dd(M cp, M T) ∇·) + a_cd·[reaction/(a_cd cd + b_cd)]."""
        m = self.model
        L = diffusion_planes3(
            g,
            ops,
            m.Dd(Mx3(ops, g, s.cp), Mx3(ops, g, s.T)),
            m.Dd(My3(ops, g, s.cp), My3(ops, g, s.T)),
            m.Dd(Mz3(ops, g, s.cp), Mz3(ops, g, s.T)),
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
        return stencil_add_diag3(L, dreac)

    # analytic cross-coupling Jacobian stencils
    def stencil_dFcl_dT(self, g: Grid3, ops: Ops3, s: State) -> Stencil7:
        """∂Fcl/∂T·w = −∇·(M(V'(T)(cl+1)·w)): advection planes with
        b = V'(T)·(cl+1) per axis."""
        m = self.model
        cl1 = s.cl + 1.0
        return advection_planes3(
            g, ops, m.V1(s.T, d=1) * cl1, m.V2(s.T, d=1) * cl1, m.V3(s.T, d=1) * cl1
        )

    def stencil_dFcd_dT(self, g: Grid3, ops: Ops3, s: State) -> Stencil7:
        """∂Fcd/∂T·w = Σ_axis D*(∂_T Dd · D₋cd ⊙ M w) + a_T·[reaction]·w."""
        m = self.model
        ax = m.Dd(Mx3(ops, g, s.cp), Mx3(ops, g, s.T), d=(0, 1)) * Dx_reg3(ops, g, s.cd)
        ay = m.Dd(My3(ops, g, s.cp), My3(ops, g, s.T), d=(0, 1)) * Dy_reg3(ops, g, s.cd)
        az = m.Dd(Mz3(ops, g, s.cp), Mz3(ops, g, s.T), d=(0, 1)) * Dz_reg3(ops, g, s.cd)
        st = midpoint_coupling_planes3(g, ops, ax, ay, az)
        a_T, _b_T = self.cscd_reaction_T()
        if a_T == 0.0:
            return st
        return stencil_add_diag3(st, self._dreac_dT(g, s, a_T))


class FieldCsTriple3(Field3Base, FieldCsTriple):
    """[Cs-Cd-int] = Kd (Sd − cd)(1 + cl) cs, in 3-D."""


class FieldHCsTriple3(Field3Base, FieldHCsTriple):
    """[Cs-Cd-int] = Kd (Sd − cd)(1 + cl) 1{cs>0}, in 3-D."""


class FieldRegHCsTriple3(Field3Base, FieldRegHCsTriple):
    """[Cs-Cd-int] = Kd (Sd − cd)(1 + cl) H_eta(cs), in 3-D — the paper's
    headline scheme."""
