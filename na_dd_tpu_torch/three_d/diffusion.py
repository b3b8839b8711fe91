"""Assembled 7-point stencils (counterpart of the parts of
:mod:`na_dd_tpu.three_d.diffusion` that the RegHCs study path runs).

A 3-D Newton operator is held as seven dense coefficient volumes
(:class:`Stencil7`): :class:`na_dd_tpu_torch.ops.linsolve.Stencil5` plus the
two z planes.  The plane builders are the closed forms of the JAX package;
``Stencil7.apply`` is the plain 7-point apply that the hand-written kernel
(:func:`na_dd_tpu_torch.ops.kernels.stencil7_apply`) reproduces.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from na_dd_tpu_torch.three_d.grid import Grid3
from na_dd_tpu_torch.three_d.shifts import Ops3


class Stencil7(NamedTuple):
    """out[ijk] = c0·w[ijk] + cxm·w[i-1,j,k] + cxp·w[i+1,j,k] + cym·w[i,j-1,k]
    + cyp·w[i,j+1,k] + czm·w[i,j,k-1] + czp·w[i,j,k+1]."""

    c0: torch.Tensor
    cxm: torch.Tensor
    cxp: torch.Tensor
    cym: torch.Tensor
    cyp: torch.Tensor
    czm: torch.Tensor
    czp: torch.Tensor

    def apply(self, ops: Ops3, w):
        return (
            self.c0 * w
            + self.cxm * ops.shift_xm(w)
            + self.cxp * ops.shift_xp(w)
            + self.cym * ops.shift_ym(w)
            + self.cyp * ops.shift_yp(w)
            + self.czm * ops.shift_zm(w)
            + self.czp * ops.shift_zp(w)
        )


def diffusion_planes3(g: Grid3, ops: Ops3, ax, ay, az) -> Stencil7:
    """Planes of w ↦ D*_x(ax ⊙ D₋x w) + D*_y(ay ⊙ D₋y w) + D*_z(az ⊙ D₋z w)."""
    cxp = g.inv_hh_phalf * ops.shift_xp(ax * g.inv_hh)
    cxm = g.inv_hh_phalf * ax * g.inv_hh
    cyp = g.inv_kk_phalf * ops.shift_yp(ay * g.inv_kk)
    cym = g.inv_kk_phalf * ay * g.inv_kk
    czp = g.inv_ll_phalf * ops.shift_zp(az * g.inv_ll)
    czm = g.inv_ll_phalf * az * g.inv_ll
    return Stencil7(
        c0=-(cxp + cxm + cyp + cym + czp + czm),
        cxm=cxm,
        cxp=cxp,
        cym=cym,
        cyp=cyp,
        czm=czm,
        czp=czp,
    )


def advection_planes3(g: Grid3, ops: Ops3, bx, by, bz) -> Stencil7:
    """Planes of w ↦ −D*_x(M_x(bx⊙w)) − D*_y(M_y(by⊙w)) − D*_z(M_z(bz⊙w))."""
    half_x = 0.5 * g.inv_hh_phalf
    half_y = 0.5 * g.inv_kk_phalf
    half_z = 0.5 * g.inv_ll_phalf
    cxp = -half_x * ops.shift_xp(bx * g.mask_x1)
    cxm = half_x * ops.shift_xm(bx) * g.mask_x1
    c0x = -half_x * bx * (ops.shift_xp(g.mask_x1) - g.mask_x1)
    cyp = -half_y * ops.shift_yp(by * g.mask_y1)
    cym = half_y * ops.shift_ym(by) * g.mask_y1
    c0y = -half_y * by * (ops.shift_yp(g.mask_y1) - g.mask_y1)
    czp = -half_z * ops.shift_zp(bz * g.mask_z1)
    czm = half_z * ops.shift_zm(bz) * g.mask_z1
    c0z = -half_z * bz * (ops.shift_zp(g.mask_z1) - g.mask_z1)
    return Stencil7(
        c0=c0x + c0y + c0z, cxm=cxm, cxp=cxp, cym=cym, cyp=cyp, czm=czm, czp=czp
    )


def midpoint_coupling_planes3(g: Grid3, ops: Ops3, ax, ay, az) -> Stencil7:
    """Planes of w ↦ D*_x(ax ⊙ M_x w) + D*_y(ay ⊙ M_y w) + D*_z(az ⊙ M_z w):
    the coefficient outside the midpoint average (a diffusion coefficient's
    state-derivative)."""
    half_x = 0.5 * g.inv_hh_phalf
    half_y = 0.5 * g.inv_kk_phalf
    half_z = 0.5 * g.inv_ll_phalf
    axm = ax * g.mask_x1
    aym = ay * g.mask_y1
    azm = az * g.mask_z1
    cxp = half_x * ops.shift_xp(axm)
    cxm = -half_x * axm
    cyp = half_y * ops.shift_yp(aym)
    cym = -half_y * aym
    czp = half_z * ops.shift_zp(azm)
    czm = -half_z * azm
    return Stencil7(
        c0=(cxp + cxm) + (cyp + cym) + (czp + czm),
        cxm=cxm,
        cxp=cxp,
        cym=cym,
        cyp=cyp,
        czm=czm,
        czp=czp,
    )


def newton_planes3(g: Grid3, ops: Ops3, L: Stencil7, dt) -> Stencil7:
    """Planes of the interior Newton operator w ↦ m·(2(w·m) − dt·m·L(w·m)),
    m = interior_mask."""
    m = g.interior_mask
    return Stencil7(
        c0=m * (2.0 - dt * L.c0),
        cxm=-dt * m * L.cxm * ops.shift_xm(m),
        cxp=-dt * m * L.cxp * ops.shift_xp(m),
        cym=-dt * m * L.cym * ops.shift_ym(m),
        cyp=-dt * m * L.cyp * ops.shift_yp(m),
        czm=-dt * m * L.czm * ops.shift_zm(m),
        czp=-dt * m * L.czp * ops.shift_zp(m),
    )


def stencil_add_diag3(st: Stencil7, d) -> Stencil7:
    """st + diag(d)."""
    return st._replace(c0=st.c0 + d)
