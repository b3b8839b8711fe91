"""3-D MMS forcing terms (counterpart of :mod:`na_dd_tpu.three_d.forcing`).

Residual insertion as in 2-D: for each field ``f = d/dt u_exact −
RHS_continuous(u_exact)``, with the continuous operators now including the z
terms and the velocity V = (V1(T), V2(T), V3(T)); the cp forcing is projected
onto dual-cell averages by 3×3×3 Gauss–Legendre quadrature
(:func:`avg_int3`).
"""

from __future__ import annotations

from na_dd_tpu_torch.core.forcing import NoForcing
from na_dd_tpu_torch.core.state import heaviside_regularized
from na_dd_tpu_torch.models.coefficients import Model01
from na_dd_tpu_torch.three_d.grid import Grid3
from na_dd_tpu_torch.three_d.quadrature import avg_int3
from na_dd_tpu_torch.three_d.shifts import Ops3


class Forcing3Base:
    def fcp(self, g: Grid3, ops: Ops3, t):  # pragma: no cover - interface
        raise NotImplementedError

    def fT(self, g: Grid3, ops: Ops3, t):  # pragma: no cover - interface
        raise NotImplementedError

    def fcl(self, g: Grid3, ops: Ops3, t):  # pragma: no cover - interface
        raise NotImplementedError

    def fcd(self, g: Grid3, ops: Ops3, t):  # pragma: no cover - interface
        raise NotImplementedError

    def fcs(self, g: Grid3, ops: Ops3, t):  # pragma: no cover - interface
        raise NotImplementedError


#: the all-zero forcing: the 2-D class, whose zeros take the grid's shape
NoForcing3 = NoForcing


class MMSForcingCsTriple3(Forcing3Base):
    """Forcing derived from a 3-D MMS case for the CsTriple reaction."""

    def __init__(self, *, mms_case, model: Model01):
        self.mms_case = mms_case
        self.model = model

    def fcp_ptwise(self, t, xx, yy, zz):
        c = self.mms_case
        m = self.model
        cp = c.cp(t, xx, yy, zz)
        cl = c.cl(t, xx, yy, zz)
        T = c.T(t, xx, yy, zz)
        return c.dt_cp(t, xx, yy, zz) + cp * (m.K1 * (1.0 + cl) + m.K2 * T)

    def fcp(self, g, ops, t):
        return avg_int3(lambda p, q, r: self.fcp_ptwise(t, p, q, r), g, ops)

    def fT(self, g, ops, t):
        c = self.mms_case
        m = self.model
        xx, yy, zz = g.xx, g.yy, g.zz
        return c.dt_T(t, xx, yy, zz) - (
            m.DT * c.lap_T(t, xx, yy, zz)
            - m.K3 * c.cp(t, xx, yy, zz) * c.T(t, xx, yy, zz)
        )

    def fcl(self, g, ops, t):
        c = self.mms_case
        m = self.model
        xx, yy, zz = g.xx, g.yy, g.zz
        cp = c.cp(t, xx, yy, zz)
        T = c.T(t, xx, yy, zz)
        cl = c.cl(t, xx, yy, zz)
        dxCl = c.dx_cl(t, xx, yy, zz)
        dyCl = c.dy_cl(t, xx, yy, zz)
        dzCl = c.dz_cl(t, xx, yy, zz)
        V1 = m.V1(T)
        V2 = m.V2(T)
        V3 = m.V3(T)
        dV1 = m.V1(T, d=1)
        dV2 = m.V2(T, d=1)
        dV3 = m.V3(T, d=1)
        Dl = m.Dl(cp)
        dDl = m.Dl(cp, d=1)
        return c.dt_cl(t, xx, yy, zz) - (
            dDl
            * (
                c.dx_cp(t, xx, yy, zz) * dxCl
                + c.dy_cp(t, xx, yy, zz) * dyCl
                + c.dz_cp(t, xx, yy, zz) * dzCl
            )
            + Dl * c.lap_cl(t, xx, yy, zz)
            - V1 * dxCl
            - V2 * dyCl
            - V3 * dzCl
            - (cl + 1.0)
            * (
                dV1 * c.dx_T(t, xx, yy, zz)
                + dV2 * c.dy_T(t, xx, yy, zz)
                + dV3 * c.dz_T(t, xx, yy, zz)
            )
            - m.K4 * cp * (cl + 1.0)
        )

    def _cs_reaction_factor(self, cs):
        """F2(cs)/Kd of the continuous reaction; the Heaviside variants
        override it."""
        return cs

    def _fcd_fcs_core(self, g, t):
        c = self.mms_case
        m = self.model
        xx, yy, zz = g.xx, g.yy, g.zz
        cp = c.cp(t, xx, yy, zz)
        T = c.T(t, xx, yy, zz)
        cl = c.cl(t, xx, yy, zz)
        cd = c.cd(t, xx, yy, zz)
        cs = c.cs(t, xx, yy, zz)
        Dd = m.Dd(cp, T)
        dCp_Dd = m.Dd(cp, T, d=(1, 0))
        dT_Dd = m.Dd(cp, T, d=(0, 1))
        reaction = m.Kd * (m.Sd - cd) * (cl + 1.0) * self._cs_reaction_factor(cs)
        diffusion = (
            (dCp_Dd * c.dx_cp(t, xx, yy, zz) + dT_Dd * c.dx_T(t, xx, yy, zz))
            * c.dx_cd(t, xx, yy, zz)
            + (dCp_Dd * c.dy_cp(t, xx, yy, zz) + dT_Dd * c.dy_T(t, xx, yy, zz))
            * c.dy_cd(t, xx, yy, zz)
            + (dCp_Dd * c.dz_cp(t, xx, yy, zz) + dT_Dd * c.dz_T(t, xx, yy, zz))
            * c.dz_cd(t, xx, yy, zz)
            + Dd * c.lap_cd(t, xx, yy, zz)
        )
        return diffusion, reaction

    def fcd(self, g, ops, t):
        diffusion, reaction = self._fcd_fcs_core(g, t)
        return self.mms_case.dt_cd(t, g.xx, g.yy, g.zz) - (diffusion + reaction)

    def fcs(self, g, ops, t):
        _, reaction = self._fcd_fcs_core(g, t)
        return self.mms_case.dt_cs(t, g.xx, g.yy, g.zz) + reaction


class MMSForcingHCsTriple3(MMSForcingCsTriple3):
    """Sharp-Heaviside reaction in fcd/fcs; fcp/fT/fcl as CsTriple."""

    def _cs_reaction_factor(self, cs):
        return (cs > 0).to(cs.dtype)


class MMSForcingRegHCsTriple3(MMSForcingCsTriple3):
    """Regularized-Heaviside reaction (the paper's headline scheme, in 3-D)."""

    def __init__(self, *, mms_case, model: Model01, regularization_factor):
        super().__init__(mms_case=mms_case, model=model)
        self.regularization_factor = regularization_factor

    def _cs_reaction_factor(self, cs):
        return heaviside_regularized(cs, self.regularization_factor)
