"""Mimetic staggered-difference operators on (N+1, M+1, P+1) volumes
(counterpart of :mod:`na_dd_tpu.three_d.stencils`).

    Mx3(u)[i,j,k]      = (u[i,j,k] + u[i-1,j,k]) / 2          (plane i=0 -> 0)
    Dx_reg3(u)[i,j,k]  = (u[i,j,k] - u[i-1,j,k]) / h_i        (plane i=0 -> 0)
    Dx_star3(u)[i,j,k] = (u[i+1,j,k] - u[i,j,k]) / h_{i+1/2}  (planes 0,N -> 0)
    (and the same per y with k_j, per z with l_k)
"""

from __future__ import annotations

from na_dd_tpu_torch.three_d.grid import Grid3
from na_dd_tpu_torch.three_d.shifts import Ops3


def Mx3(ops: Ops3, g: Grid3, u):
    return 0.5 * (u + ops.shift_xm(u)) * g.mask_x1


def My3(ops: Ops3, g: Grid3, u):
    return 0.5 * (u + ops.shift_ym(u)) * g.mask_y1


def Mz3(ops: Ops3, g: Grid3, u):
    return 0.5 * (u + ops.shift_zm(u)) * g.mask_z1


def Dx_reg3(ops: Ops3, g: Grid3, u):
    return (u - ops.shift_xm(u)) * g.inv_hh


def Dy_reg3(ops: Ops3, g: Grid3, u):
    return (u - ops.shift_ym(u)) * g.inv_kk


def Dz_reg3(ops: Ops3, g: Grid3, u):
    return (u - ops.shift_zm(u)) * g.inv_ll


def Dx_star3(ops: Ops3, g: Grid3, u):
    return (ops.shift_xp(u) - u) * g.inv_hh_phalf


def Dy_star3(ops: Ops3, g: Grid3, u):
    return (ops.shift_yp(u) - u) * g.inv_kk_phalf


def Dz_star3(ops: Ops3, g: Grid3, u):
    return (ops.shift_zp(u) - u) * g.inv_ll_phalf


def grad_H3(ops: Ops3, g: Grid3, u):
    """Discrete gradient of the H¹-type error norms."""
    return (Dx_reg3(ops, g, u), Dy_reg3(ops, g, u), Dz_reg3(ops, g, u))
