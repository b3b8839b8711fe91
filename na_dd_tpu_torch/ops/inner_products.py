"""Discrete weighted inner products and norms (counterpart of
:mod:`na_dd_tpu.ops.inner_products`); each is a whole-array masked sum.

    <u,v>_H    = Σ_{1<=i<=N-1, 1<=j<=M-1} u v h_{i+1/2} k_{j+1/2}
    <u,v>_{+k} = Σ_{1<=i<=N,   1<=j<=M-1} u v h_i       k_{j+1/2}
    <u,v>_{h+} = Σ_{1<=i<=N-1, 1<=j<=M}   u v h_{i+1/2} k_j
    <(ux,uy),(vx,vy)>_p = <ux,vx>_{+k} + <uy,vy>_{h+}
"""

from __future__ import annotations

import torch

from na_dd_tpu_torch.ops.grid import Grid
from na_dd_tpu_torch.ops.shifts import Ops


def inner_H(ops: Ops, g: Grid, u, v):
    return ops.asum(u * v * g.w_H)


def norm_H(ops: Ops, g: Grid, u):
    return torch.sqrt(inner_H(ops, g, u, u))


def inner_pk(ops: Ops, g: Grid, u, v):
    return ops.asum(u * v * g.w_pk)


def norm_pk(ops: Ops, g: Grid, u):
    return torch.sqrt(inner_pk(ops, g, u, u))


def inner_hp(ops: Ops, g: Grid, u, v):
    return ops.asum(u * v * g.w_hp)


def norm_hp(ops: Ops, g: Grid, u):
    return torch.sqrt(inner_hp(ops, g, u, u))


def inner_p(ops: Ops, g: Grid, ux, uy, vx, vy):
    return inner_pk(ops, g, ux, vx) + inner_hp(ops, g, uy, vy)


def norm_p(ops: Ops, g: Grid, ux, uy):
    return torch.sqrt(inner_p(ops, g, ux, uy, ux, uy))
