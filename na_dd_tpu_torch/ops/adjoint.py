"""Implicit-function-theorem adjoint of a plane solve (the port's
counterpart of ``jax.lax.custom_linear_solve`` as
:mod:`na_dd_tpu.integrators.pc_trapezoidal` uses it with
``differentiable=True``).

For ``x = A⁻¹ b`` with ``A`` held as :class:`Stencil5` planes (or, in 3-D,
:class:`~na_dd_tpu_torch.three_d.diffusion.Stencil7` volumes), reverse mode
needs no pass through the solver's iterations:

    y = A⁻ᵀ ḡ,     b̄ = y,     c̄_k = −y ⊙ shift_k(x)

for each plane ``c_k`` of :meth:`Stencil5.apply` (``c0`` with ``x`` itself,
``cxm`` with ``shift_xm(x)``, and so on), which is what the VJP of the
matvec gives inside ``custom_linear_solve``.  The transposed system is
solved by the same solver on :meth:`Stencil5.transpose` planes: on CUDA
tensors the Krylov backend's solve is the BiCGStab kernel (K1) forward and
in the adjoint, its float32 instance under mixed refinement, or block cyclic
reduction for ``linear_solver="direct"``.  The Jacobi preconditioner of the
transposed solve is again ``1/c0``, since ``diag(Aᵀ) = diag(A)``.

The forward is the solver's own call on detached tensors, so its bits are
those of the non-differentiable path.  The diagnostics of the transposed
solve are discarded, as the JAX package discards them: an adjoint that
misses its tolerance is not reported (the forward's verdict is the guard,
the two systems sharing their spectrum).

On a block of a sharded grid the caller passes its halo-exchange ``ops``:
the transposed planes and the shifted ``x`` then take their neighbours'
lines, and the solver is the sharded one.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from na_dd_tpu_torch.ops.linsolve import Stencil5
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS
from na_dd_tpu_torch.three_d.diffusion import Stencil7
from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3


def _kind(planes):
    """(stencil type, ops provider) of a tuple of 5 or 7 planes."""
    return (Stencil5, LOCAL_OPS) if len(planes) == 5 else (Stencil7, LOCAL_OPS3)


def _neighbours(ops, x, nplanes):
    """``x`` shifted as each plane of the stencil multiplies it."""
    shifts = (ops.shift_xm, ops.shift_xp, ops.shift_ym, ops.shift_yp)
    if nplanes == 7:
        shifts += (ops.shift_zm, ops.shift_zp)
    return (x, *(shift(x) for shift in shifts))


class _PlaneSolve(torch.autograd.Function):
    """``(solver, transpose_solver, ops, mask, b, *planes) -> (x, iters,
    resnorm_sq, converged)`` with ``solver(stencil, b) -> (x, info)``; the
    three diagnostics are non-differentiable outputs.  ``ops`` (None: the
    local ops of the planes' dimension) shifts in the backward."""

    @staticmethod
    def forward(ctx, solver, transpose_solver, ops, mask, b, *planes):
        planes = tuple(p.detach() for p in planes)
        stencil, local_ops = _kind(planes)
        x, info = solver(stencil(*planes), b.detach())
        ctx.solver = transpose_solver or solver
        ctx.ops = local_ops if ops is None else ops
        ctx.save_for_backward(mask, x, *planes)
        diags = (info["iters"], info["resnorm_sq"], info["converged"])
        ctx.mark_non_differentiable(*diags)
        return (x, *diags)

    @staticmethod
    @once_differentiable
    def backward(ctx, gx, *_diag_grads):
        mask, x, *planes = ctx.saved_tensors
        stencil, ops = _kind(planes)[0], ctx.ops
        y, _info = ctx.solver(stencil(*planes).transpose(ops), (gx * mask).contiguous())
        y = y * mask
        need = ctx.needs_input_grad
        grad_b = y if need[4] else None
        grad_planes = tuple(
            -y * xk if need[5 + k] else None
            for k, xk in enumerate(_neighbours(ops, x, len(planes)))
        )
        return (None, None, None, None, grad_b, *grad_planes)


def plane_solve(solver, st, b, mask, transpose_solver=None, ops=None):
    """``x = solver(st, b)[0]`` with the IFT adjoint as its gradient in
    ``b`` and in every plane of ``st`` (a Stencil5 or a Stencil7); the
    transposed system goes to ``transpose_solver`` (``solver`` by default).
    ``ops``: the shift provider of the transposed planes (None: the local
    one; a halo-exchange provider on a sharded block).  Returns ``(x,
    info)`` as the solver does; ``info``'s tensors carry no gradient."""
    x, iters, resnorm_sq, converged = _PlaneSolve.apply(
        solver, transpose_solver, ops, mask, b, *st
    )
    return x, {"iters": iters, "resnorm_sq": resnorm_sq, "converged": converged}
