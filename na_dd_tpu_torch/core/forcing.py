"""MMS-derived forcing terms (counterpart of :mod:`na_dd_tpu.core.forcing`).

Residual insertion: for each field, ``f = d/dt u_exact - RHS(u_exact)`` from
the MMS case's analytic derivatives; the cp forcing is projected onto
dual-cell averages by 3×3 Gauss–Legendre quadrature.
:class:`ForcingFromTimeGrid` serves any forcing from tables built once on
a uniform time grid.
"""

from __future__ import annotations

import torch

from na_dd_tpu_torch.core.state import heaviside_regularized
from na_dd_tpu_torch.models.coefficients import Model01
from na_dd_tpu_torch.ops.grid import Grid
from na_dd_tpu_torch.ops.quadrature import avg_int
from na_dd_tpu_torch.ops.shifts import Ops


class ForcingBase:
    def fcp(self, g: Grid, ops: Ops, t):  # pragma: no cover - interface
        raise NotImplementedError

    def fT(self, g: Grid, ops: Ops, t):  # pragma: no cover - interface
        raise NotImplementedError

    def fcl(self, g: Grid, ops: Ops, t):  # pragma: no cover - interface
        raise NotImplementedError

    def fcd(self, g: Grid, ops: Ops, t):  # pragma: no cover - interface
        raise NotImplementedError

    def fcs(self, g: Grid, ops: Ops, t):  # pragma: no cover - interface
        raise NotImplementedError


class ForcingFromTimeGrid(ForcingBase):
    """Forcing tabulated on the uniform time grid ``t0 + j·dt``, j = 0..num.

    The integrators evaluate the state-independent forcing terms only at the
    grid times t_k and t_{k+1} of each step.  This wrapper holds device
    tables of all five terms of ``inner``, built once (:meth:`build_tables`,
    then :meth:`bind`), and serves ``f(t)`` as the table row
    ``j = round((t − t0)/dt)`` clipped to [0, num].  The row index stays a
    device tensor (``index_select``), so a lookup never synchronises with
    the host.  The values are the inner forcing's own outputs at the grid
    times.
    """

    _KEYS = ("fcp", "fT", "fcl", "fcd", "fcs")

    def __init__(self, inner, *, t0: float, dt: float, num: int):
        self.inner = inner
        self.t0 = float(t0)
        self.dt = float(dt)
        self.num = int(num)
        self._tables = None

    def build_tables(self, g: Grid, ops: Ops):
        """All five terms at the num+1 grid times, each stacked into a
        (num+1, *plane) tensor; one evaluation per time, run once."""
        ts = self.t0 + self.dt * torch.arange(self.num + 1, dtype=g.dtype, device=g.device)
        return {
            k: torch.stack([getattr(self.inner, k)(g, ops, ts[j]) for j in range(self.num + 1)])
            for k in self._KEYS
        }

    def bind(self, tables) -> None:
        """Attach the tables :meth:`build_tables` made."""
        self._tables = tables

    def _lookup(self, key, t):
        if self._tables is None:
            raise RuntimeError("ForcingFromTimeGrid used before bind(): build and bind its tables")
        table = self._tables[key]
        t = torch.as_tensor(t, dtype=table.dtype, device=table.device)
        j = torch.clamp(torch.round((t - self.t0) / self.dt).to(torch.int64), 0, self.num)
        return table.index_select(0, j.reshape(1)).squeeze(0)

    def fcp(self, g, ops, t):
        return self._lookup("fcp", t)

    def fT(self, g, ops, t):
        return self._lookup("fT", t)

    def fcl(self, g, ops, t):
        return self._lookup("fcl", t)

    def fcd(self, g, ops, t):
        return self._lookup("fcd", t)

    def fcs(self, g, ops, t):
        return self._lookup("fcs", t)


class NoForcing(ForcingBase):
    """All-zero forcing."""

    def fcp(self, g, ops, t):
        return torch.zeros_like(g.xx)

    fT = fcp
    fcl = fcp
    fcd = fcp
    fcs = fcp


class ForcingFromCallables(ForcingBase):
    """User callables ``f(t, xx, yy)``, one per term, in a dict keyed
    "fcp", "fT", "fcl", "fcd", "fcs"."""

    def __init__(self, terms: dict):
        self._terms = terms

    def fcp(self, g, ops, t):
        return self._terms["fcp"](t, g.xx, g.yy)

    def fT(self, g, ops, t):
        return self._terms["fT"](t, g.xx, g.yy)

    def fcl(self, g, ops, t):
        return self._terms["fcl"](t, g.xx, g.yy)

    def fcd(self, g, ops, t):
        return self._terms["fcd"](t, g.xx, g.yy)

    def fcs(self, g, ops, t):
        return self._terms["fcs"](t, g.xx, g.yy)


class MMSForcingCsTriple(ForcingBase):
    """Forcing derived from an MMS case for the CsTriple reaction."""

    def __init__(self, *, mms_case, model: Model01):
        self.mms_case = mms_case
        self.model = model

    def fcp_ptwise(self, t, xx, yy):
        c = self.mms_case
        m = self.model
        cp = c.cp(t, xx, yy)
        cl = c.cl(t, xx, yy)
        T = c.T(t, xx, yy)
        return c.dt_cp(t, xx, yy) + cp * (m.K1 * (1.0 + cl) + m.K2 * T)

    def fcp(self, g, ops, t):
        return avg_int(lambda p, q: self.fcp_ptwise(t, p, q), g, ops)

    def fT(self, g, ops, t):
        c = self.mms_case
        m = self.model
        xx, yy = g.xx, g.yy
        return c.dt_T(t, xx, yy) - (
            m.DT * c.lap_T(t, xx, yy) - m.K3 * c.cp(t, xx, yy) * c.T(t, xx, yy)
        )

    def fcl(self, g, ops, t):
        c = self.mms_case
        m = self.model
        xx, yy = g.xx, g.yy
        cp = c.cp(t, xx, yy)
        T = c.T(t, xx, yy)
        cl = c.cl(t, xx, yy)
        dxCl = c.dx_cl(t, xx, yy)
        dyCl = c.dy_cl(t, xx, yy)
        V1 = m.V1(T)
        V2 = m.V2(T)
        dV1 = m.V1(T, d=1)
        dV2 = m.V2(T, d=1)
        Dl = m.Dl(cp)
        dDl = m.Dl(cp, d=1)
        return c.dt_cl(t, xx, yy) - (
            dDl * (c.dx_cp(t, xx, yy) * dxCl + c.dy_cp(t, xx, yy) * dyCl)
            + Dl * c.lap_cl(t, xx, yy)
            - V1 * dxCl
            - V2 * dyCl
            - (cl + 1.0) * (dV1 * c.dx_T(t, xx, yy) + dV2 * c.dy_T(t, xx, yy))
            - m.K4 * cp * (cl + 1.0)
        )

    def _cs_reaction_factor(self, cs):
        """F2(cs)/Kd of the continuous reaction; the Heaviside variants
        override it."""
        return cs

    def _fcd_fcs_core(self, g, t):
        c = self.mms_case
        m = self.model
        xx, yy = g.xx, g.yy
        cp = c.cp(t, xx, yy)
        T = c.T(t, xx, yy)
        cl = c.cl(t, xx, yy)
        cd = c.cd(t, xx, yy)
        cs = c.cs(t, xx, yy)
        Dd = m.Dd(cp, T)
        dCp_Dd = m.Dd(cp, T, d=(1, 0))
        dT_Dd = m.Dd(cp, T, d=(0, 1))
        reaction = m.Kd * (m.Sd - cd) * (cl + 1.0) * self._cs_reaction_factor(cs)
        diffusion = (
            (dCp_Dd * c.dx_cp(t, xx, yy) + dT_Dd * c.dx_T(t, xx, yy))
            * c.dx_cd(t, xx, yy)
            + (dCp_Dd * c.dy_cp(t, xx, yy) + dT_Dd * c.dy_T(t, xx, yy))
            * c.dy_cd(t, xx, yy)
            + Dd * c.lap_cd(t, xx, yy)
        )
        return diffusion, reaction

    def fcd(self, g, ops, t):
        diffusion, reaction = self._fcd_fcs_core(g, t)
        return self.mms_case.dt_cd(t, g.xx, g.yy) - (diffusion + reaction)

    def fcs(self, g, ops, t):
        _, reaction = self._fcd_fcs_core(g, t)
        return self.mms_case.dt_cs(t, g.xx, g.yy) + reaction


class MMSForcingHCsTriple(MMSForcingCsTriple):
    """Sharp-Heaviside reaction in fcd/fcs; fcp/fT/fcl as CsTriple."""

    def _cs_reaction_factor(self, cs):
        return (cs > 0).to(cs.dtype)


class MMSForcingRegHCsTriple(MMSForcingCsTriple):
    """Regularized-Heaviside reaction in fcd/fcs."""

    def __init__(self, *, mms_case, model: Model01, regularization_factor):
        super().__init__(mms_case=mms_case, model=model)
        self.regularization_factor = regularization_factor

    def _cs_reaction_factor(self, cs):
        return heaviside_regularized(cs, self.regularization_factor)
