"""3×3 Gauss–Legendre cell averages over the dual cells (counterpart of
:mod:`na_dd_tpu.ops.quadrature`), used to project the cp forcing."""

from __future__ import annotations

import numpy as np

from na_dd_tpu_torch.ops.grid import Grid
from na_dd_tpu_torch.ops.shifts import Ops

_GL_W = (5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0)
_GL_N = (-float(np.sqrt(3.0 / 5.0)), 0.0, float(np.sqrt(3.0 / 5.0)))


def avg_int(f, g: Grid, ops: Ops):
    """Average of ``f(x, y)`` over each interior dual cell
    [x_{i-1/2}, x_{i+1/2}] × [y_{j-1/2}, y_{j+1/2}]; 0 on the boundary."""
    base_x = ops.shift_xm(g.xx_phalf)
    base_y = ops.shift_ym(g.yy_phalf)
    width_x = g.hh_phalf
    width_y = g.kk_phalf

    acc = 0.0
    for wi, ni in zip(_GL_W, _GL_N):
        p = base_x + (ni + 1.0) * 0.5 * width_x
        for wj, nj in zip(_GL_W, _GL_N):
            q = base_y + (nj + 1.0) * 0.5 * width_y
            acc = acc + (wi * wj) * f(p, q)

    # 0.25 = quadrature Jacobian (area/4) over the cell area
    return 0.25 * acc * g.interior_mask
