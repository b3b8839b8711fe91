"""3×3×3 Gauss–Legendre cell averages over the 3-D dual cells (counterpart
of :mod:`na_dd_tpu.three_d.quadrature`), used to project the cp forcing."""

from __future__ import annotations

import numpy as np

from na_dd_tpu_torch.three_d.grid import Grid3
from na_dd_tpu_torch.three_d.shifts import Ops3

_GL_W = (5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0)
_GL_N = (-float(np.sqrt(3.0 / 5.0)), 0.0, float(np.sqrt(3.0 / 5.0)))


def avg_int3(f, g: Grid3, ops: Ops3):
    """Average of ``f(x, y, z)`` over each interior dual cell
    [x_{i-1/2}, x_{i+1/2}] × [y_{j-1/2}, y_{j+1/2}] × [z_{k-1/2}, z_{k+1/2}];
    0 on the boundary.  ``f`` is evaluated at 27 node sets."""
    base_x = ops.shift_xm(g.xx_phalf)
    base_y = ops.shift_ym(g.yy_phalf)
    base_z = ops.shift_zm(g.zz_phalf)
    width_x = g.hh_phalf
    width_y = g.kk_phalf
    width_z = g.ll_phalf

    acc = 0.0
    for wi, ni in zip(_GL_W, _GL_N):
        p = base_x + (ni + 1.0) * 0.5 * width_x
        for wj, nj in zip(_GL_W, _GL_N):
            q = base_y + (nj + 1.0) * 0.5 * width_y
            for wk, nk in zip(_GL_W, _GL_N):
                r = base_z + (nk + 1.0) * 0.5 * width_z
                acc = acc + (wi * wj * wk) * f(p, q, r)

    # 0.125 = quadrature Jacobian (volume/8) over the cell volume
    return 0.125 * acc * g.interior_mask
