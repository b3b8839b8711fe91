"""Mimetic staggered-difference operators (counterpart of
:mod:`na_dd_tpu.ops.stencils`).

    Mx(u)[i,j]      = (u[i,j] + u[i-1,j]) / 2         (row 0 -> 0)
    My(u)[i,j]      = (u[i,j] + u[i,j-1]) / 2         (col 0 -> 0)
    Dx_reg(u)[i,j]  = (u[i,j] - u[i-1,j]) / h_i       (row 0 -> 0)
    Dy_reg(u)[i,j]  = (u[i,j] - u[i,j-1]) / k_j       (col 0 -> 0)
    Dx_star(u)[i,j] = (u[i+1,j] - u[i,j]) / h_{i+1/2} (rows 0,N -> 0)
    Dy_star(u)[i,j] = (u[i,j+1] - u[i,j]) / k_{j+1/2} (cols 0,M -> 0)
"""

from __future__ import annotations

from na_dd_tpu_torch.ops.grid import Grid
from na_dd_tpu_torch.ops.shifts import Ops


def Mx(ops: Ops, g: Grid, u):
    return 0.5 * (u + ops.shift_xm(u)) * g.mask_x1


def My(ops: Ops, g: Grid, u):
    return 0.5 * (u + ops.shift_ym(u)) * g.mask_y1


def Dx_reg(ops: Ops, g: Grid, u):
    return (u - ops.shift_xm(u)) * g.inv_hh


def Dy_reg(ops: Ops, g: Grid, u):
    return (u - ops.shift_ym(u)) * g.inv_kk


def Dx_star(ops: Ops, g: Grid, u):
    return (ops.shift_xp(u) - u) * g.inv_hh_phalf


def Dy_star(ops: Ops, g: Grid, u):
    return (ops.shift_yp(u) - u) * g.inv_kk_phalf


def grad_H(ops: Ops, g: Grid, u):
    """Discrete gradient of the H¹-type error norms."""
    return (Dx_reg(ops, g, u), Dy_reg(ops, g, u))
