"""3-D discrete weighted inner products and norms (counterpart of
:mod:`na_dd_tpu.three_d.inner_products`); each is a whole-array masked sum.

    <u,v>_H     = Σ_{interior} u v h_{i+1/2} k_{j+1/2} l_{k+1/2}
    <∇u,∇v>_p   = Σ ux vx w_gx + Σ uy vy w_gy + Σ uz vz w_gz
"""

from __future__ import annotations

import torch

from na_dd_tpu_torch.three_d.grid import Grid3
from na_dd_tpu_torch.three_d.shifts import Ops3


def inner_H3(ops: Ops3, g: Grid3, u, v):
    return ops.asum(u * v * g.w_H)


def norm_H3(ops: Ops3, g: Grid3, u):
    return torch.sqrt(inner_H3(ops, g, u, u))


def inner_p3(ops: Ops3, g: Grid3, ux, uy, uz, vx, vy, vz):
    return (
        ops.asum(ux * vx * g.w_gx)
        + ops.asum(uy * vy * g.w_gy)
        + ops.asum(uz * vz * g.w_gz)
    )


def norm_p3(ops: Ops3, g: Grid3, ux, uy, uz):
    return torch.sqrt(inner_p3(ops, g, ux, uy, uz, ux, uy, uz))
