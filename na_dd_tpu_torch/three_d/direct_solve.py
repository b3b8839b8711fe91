"""Exact direct solve of assembled 7-point systems by block cyclic reduction
(counterpart of :mod:`na_dd_tpu.three_d.direct_solve`, the single-device
part).

The interior Stencil7 system, written over x-planes, is block tridiagonal,

    A_i x_{i-1} + B_i x_i + C_i x_{i+1} = b_i,   x_i in R^m,  m = (M-1)(P-1),

with B_i the in-plane 5-point (y, z) couplings (c0 on the diagonal, czm/czp
one flattened slot away, cym/cyp one z-row, P-1 slots, away) and A_i, C_i
diagonal (cxm/cxp).  The 2-D solver's block cyclic reduction
(:func:`na_dd_tpu_torch.ops.direct_solve.block_tridiag_solve_bcr`) and its
padding solve it unchanged: they see only dense (n, m, m) blocks.

Cost: O(N·m³) = O(N⁷) operations and three (n, m, m) block arrays: at N=32
(31, 961, 961), ~230 MB each in float64; at N=64 ~7.9 GB each.  Like the 2-D
direct mode it is the exact, stiffness-independent backstop of
``linear_solver="direct"``, not the default.  Under domain decomposition
:func:`stencil7_solve_direct_ops` replicates the solve, as the 2-D one does:
gather every rank's volumes (x-planes over the mesh's x axis, y-planes over
y; z is never sharded), solve the full grid on every rank, keep this rank's
block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from na_dd_tpu_torch.ops.direct_solve import _pad_pow2, block_tridiag_solve_bcr
from na_dd_tpu_torch.three_d.diffusion import Stencil7


def _dense_blocks3(st: Stencil7, b, mask):
    """Interior block-tridiagonal system ``(A, B, C, rhs)`` of shapes
    (n, m, m) ×3 and (n, m) from full-grid volumes of shape (n+2, My, Pz),
    m = (My-2)(Pz-2) interior (y, z) nodes an x-plane flattened with z
    fastest; A and C are diagonal, stored dense.  Rows with ``mask == 0``
    become identity equations with a zero rhs."""
    sl = (slice(1, -1), slice(1, -1), slice(1, -1))
    alive = mask[sl] > 0
    one = torch.ones((), dtype=st.c0.dtype, device=st.c0.device)
    zero = torch.zeros((), dtype=st.c0.dtype, device=st.c0.device)

    def live(plane):
        return torch.where(alive, plane[sl], zero)

    c0 = torch.where(alive, st.c0[sl], one)
    cxm, cxp, cym, cyp, czm, czp = (live(p) for p in st[1:])
    rhs = live(b)
    n, my, pz = c0.shape
    m = my * pz

    # the z couplings at k = 0 / pz-1 reach the boundary frame; left in, the
    # flattened offset-1 diagonals would carry them into the next y-row
    k = torch.arange(pz, device=c0.device)
    czm = torch.where(k == 0, zero, czm)
    czp = torch.where(k == pz - 1, zero, czp)

    def flat(a):
        return a.reshape(n, m)

    # cym[i, jj, kk] couples x[i, jj-1, kk], flattened column j - pz (the
    # first pz rows, jj = 0, couple to the frame and are left out)
    B = (
        torch.diag_embed(flat(c0))
        + torch.diag_embed(flat(czm)[:, 1:], offset=-1)
        + torch.diag_embed(flat(czp)[:, :-1], offset=1)
        + torch.diag_embed(flat(cym)[:, pz:], offset=-pz)
        + torch.diag_embed(flat(cyp)[:, :-pz], offset=pz)
    )
    return torch.diag_embed(flat(cxm)), B, torch.diag_embed(flat(cxp)), flat(rhs)


def stencil7_solve_direct(st: Stencil7, b, mask):
    """Exact solve of ``st · x = b`` on the masked interior: full-grid
    volumes in and out, ``x`` zero wherever ``mask`` is 0 and on the
    boundary frame."""
    A, B, C, rhs = _pad_pow2(*_dense_blocks3(st, b, mask))
    n_int = st.c0.shape[0] - 2
    x_int = block_tridiag_solve_bcr(A, B, C, rhs)[:n_int]
    x_int = x_int.reshape(n_int, b.shape[1] - 2, b.shape[2] - 2)
    return F.pad(x_int, (1, 1, 1, 1, 1, 1)) * mask


def stencil7_solve_direct_ops(ops, st: Stencil7, b, mask):
    """:func:`stencil7_solve_direct` through an ops provider: the local solve
    on the local ops, the replicated one on ``HaloOps3``."""
    st_full = Stencil7(*(ops.gather_full(p) for p in st))
    x_full = stencil7_solve_direct(st_full, ops.gather_full(b), ops.gather_full(mask))
    return ops.local_slice(x_full)
