"""Exact direct solve of assembled 5-point systems by block cyclic reduction
(counterpart of :mod:`na_dd_tpu.ops.direct_solve`, the single-device part).

The interior system, written over grid rows, is block tridiagonal,

    A_i x_{i-1} + B_i x_i + C_i x_{i+1} = b_i,      i = 1..n,  x_i in R^m,

with B_i tridiagonal (the in-row y-couplings) and A_i, C_i diagonal (the
x-couplings).  Block cyclic reduction (BCR) eliminates every other block row
per level,

    B'_e = B_e - A_e B_{e-1}^{-1} C_{e-1} - C_e B_{e+1}^{-1} A_{e+1}
    A'_e = -A_e B_{e-1}^{-1} A_{e-1}
    C'_e = -C_e B_{e+1}^{-1} C_{e+1}
    b'_e = b_e - A_e B_{e-1}^{-1} b_{e-1} - C_e B_{e+1}^{-1} b_{e+1}

halving the block count, then substitutes back.  It is exact for every
Newton operator of the integrators (any coefficients, non-uniform grids),
with no iteration budget: ``log2(n + 1)`` levels of batched dense m×m
inverses (``torch.linalg.inv``: LAPACK on the CPU, cuSOLVER on a card) and
batched matrix products, O(n·m³) operations a solve.  That is far more than a
converged BiCGStab on the smooth study protocols, so it is the integrators'
``linear_solver="direct"`` option, not their default.  In float32 (the inner
solve of ``precision="mixed"``) each refinement pass contracts the f64
residual by about float32's epsilon; the products run in full float32 as
long as TF32 matmuls stay off (``torch.backends.cuda.matmul.allow_tf32``,
False by default).

Dead rows (``mask == 0``: the boundary frame and any masked interior node)
become identity equations with a zero rhs, so the solve is well-posed for
any masked stencil and ``x`` is exactly 0 there.

Under domain decomposition BCR cannot run on a block: it addresses whole
grid rows.  :func:`stencil5_solve_direct_ops` replicates it, as the JAX
package does: gather the planes, rhs and mask of every rank
(``ops.gather_full``), solve the full grid on every rank, and keep this
rank's block (``ops.local_slice``); the gathered system is bitwise the
single-device one, so the sharded solve is the local solve.

Not ported: ``inv_gauss_jordan``/``_inv`` (the JAX package's LU-free inverse
for the TPU, which has no f64 LU).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from na_dd_tpu_torch.ops.linsolve import Stencil5


def _dense_blocks(st: Stencil5, b, mask):
    """Interior block-tridiagonal system ``(A, B, C, rhs)`` of shapes (n, m,
    m) ×3 and (n, m) from full-grid planes of shape (n+2, m+2); A and C are
    diagonal, stored dense.  Rows with ``mask == 0`` become identity
    equations with a zero rhs."""
    sl = (slice(1, -1), slice(1, -1))
    alive = mask[sl] > 0
    one = torch.ones((), dtype=st.c0.dtype, device=st.c0.device)
    zero = torch.zeros((), dtype=st.c0.dtype, device=st.c0.device)
    c0 = torch.where(alive, st.c0[sl], one)
    cym = torch.where(alive, st.cym[sl], zero)
    cyp = torch.where(alive, st.cyp[sl], zero)
    cxm = torch.where(alive, st.cxm[sl], zero)
    cxp = torch.where(alive, st.cxp[sl], zero)
    rhs = torch.where(alive, b[sl], zero)
    # row jj couples x[jj-1] by cym[jj] (jj >= 1) and x[jj+1] by cyp[jj]; the
    # jj = 0 / m-1 couplings reach the boundary column and are left out
    B = (
        torch.diag_embed(c0)
        + torch.diag_embed(cym[:, 1:], offset=-1)
        + torch.diag_embed(cyp[:, :-1], offset=1)
    )
    return torch.diag_embed(cxm), B, torch.diag_embed(cxp), rhs


def _pad_pow2(A, B, C, b):
    """Pad the block count to 2^k - 1 with decoupled identity equations."""
    n, m, _ = B.shape
    k = 1
    while 2**k - 1 < n:
        k += 1
    pad = 2**k - 1 - n
    if pad == 0:
        return A, B, C, b
    eye = torch.eye(m, dtype=B.dtype, device=B.device).expand(pad, m, m)
    zero = torch.zeros((pad, m, m), dtype=B.dtype, device=B.device)
    return (
        torch.cat([A, zero]),
        torch.cat([B, eye]),
        torch.cat([C, zero]),
        torch.cat([b, torch.zeros((pad, m), dtype=b.dtype, device=b.device)]),
    )


def _mv(X, y):
    return torch.matmul(X, y.unsqueeze(-1)).squeeze(-1)


def block_tridiag_solve_bcr(A, B, C, b):
    """Solve the block tridiagonal system by block cyclic reduction.

    A, B, C: (n, m, m) sub, main and super diagonal blocks (A[0] and C[-1]
    are not read); b: (n, m).  Requires n = 2^k - 1 (:func:`_pad_pow2`).
    ``log2(n + 1)`` sequential levels, each a few batched inverses and
    products.
    """
    n = B.shape[0]
    if (n + 1) & n != 0:
        raise ValueError(f"block count must be 2^k - 1, got {n}")

    stack = []
    while n > 1:
        A_o, B_o, C_o, b_o = A[0::2], B[0::2], C[0::2], b[0::2]
        A_e, B_e, C_e, b_e = A[1::2], B[1::2], C[1::2], b[1::2]
        inv_o = torch.linalg.inv(B_o)
        stack.append((inv_o, A_o, C_o, b_o))
        G = torch.matmul(A_e, inv_o[:-1])  # couples even row e to odd row e-1
        H = torch.matmul(C_e, inv_o[1:])  # couples even row e to odd row e+1
        B = B_e - torch.matmul(G, C_o[:-1]) - torch.matmul(H, A_o[1:])
        A = -torch.matmul(G, A_o[:-1])
        C = -torch.matmul(H, C_o[1:])
        b = b_e - _mv(G, b_o[:-1]) - _mv(H, b_o[1:])
        n = (n - 1) // 2

    x = _mv(torch.linalg.inv(B[:1]), b[:1])
    for inv_o, A_o, C_o, b_o in reversed(stack):
        zero = torch.zeros((1, x.shape[1]), dtype=x.dtype, device=x.device)
        x_prev = torch.cat([zero, x])  # the even row left of each odd row
        x_next = torch.cat([x, zero])  # the even row right of each odd row
        x_o = _mv(inv_o, b_o - _mv(A_o, x_prev) - _mv(C_o, x_next))
        full = torch.empty((x_o.shape[0] + x.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
        full[0::2] = x_o
        full[1::2] = x
        x = full
    return x


def stencil5_solve_direct(st: Stencil5, b, mask):
    """Exact solve of ``st · x = b`` on the masked interior: full-grid planes
    in and out, ``x`` zero wherever ``mask`` is 0 and on the boundary
    frame."""
    A, B, C, rhs = _pad_pow2(*_dense_blocks(st, b, mask))
    n_int = st.c0.shape[0] - 2
    x_int = block_tridiag_solve_bcr(A, B, C, rhs)[:n_int]
    return F.pad(x_int, (1, 1, 1, 1)) * mask


def stencil5_solve_direct_ops(ops, st: Stencil5, b, mask):
    """:func:`stencil5_solve_direct` through an ops provider: on the local
    ops exactly that solve, on a halo-exchange provider the replicated one
    (gather everything, solve the full grid on every rank, slice this
    rank's block back out)."""
    st_full = Stencil5(*(ops.gather_full(p) for p in st))
    x_full = stencil5_solve_direct(st_full, ops.gather_full(b), ops.gather_full(mask))
    return ops.local_slice(x_full)
