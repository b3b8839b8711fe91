"""Implicit-function-theorem adjoint of a plane solve (the port's
counterpart of ``jax.lax.custom_linear_solve`` as
:mod:`na_dd_tpu.integrators.pc_trapezoidal` uses it with
``differentiable=True``).

For ``x = A⁻¹ b`` with ``A`` held as :class:`Stencil5` planes, reverse mode
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
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from na_dd_tpu_torch.ops.linsolve import Stencil5
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS


class _PlaneSolve(torch.autograd.Function):
    """``(solver, mask, b, *planes) -> (x, iters, resnorm_sq, converged)``
    with ``solver(stencil, b) -> (x, info)``; the three diagnostics are
    non-differentiable outputs."""

    @staticmethod
    def forward(ctx, solver, mask, b, *planes):
        planes = tuple(p.detach() for p in planes)
        x, info = solver(Stencil5(*planes), b.detach())
        ctx.solver = solver
        ctx.save_for_backward(mask, x, *planes)
        diags = (info["iters"], info["resnorm_sq"], info["converged"])
        ctx.mark_non_differentiable(*diags)
        return (x, *diags)

    @staticmethod
    @once_differentiable
    def backward(ctx, gx, *_diag_grads):
        mask, x, *planes = ctx.saved_tensors
        st = Stencil5(*planes)
        y, _info = ctx.solver(st.transpose(LOCAL_OPS), (gx * mask).contiguous())
        y = y * mask
        need = ctx.needs_input_grad
        grad_b = y if need[2] else None
        neighbours = (
            x,
            LOCAL_OPS.shift_xm(x),
            LOCAL_OPS.shift_xp(x),
            LOCAL_OPS.shift_ym(x),
            LOCAL_OPS.shift_yp(x),
        )
        grad_planes = tuple(
            -y * xk if need[3 + k] else None for k, xk in enumerate(neighbours)
        )
        return (None, None, grad_b, *grad_planes)


def plane_solve(solver, st: Stencil5, b, mask):
    """``x = solver(st, b)[0]`` with the IFT adjoint as its gradient in
    ``b`` and in every plane of ``st``.  Returns ``(x, info)`` as the solver
    does; ``info``'s tensors carry no gradient."""
    x, iters, resnorm_sq, converged = _PlaneSolve.apply(solver, mask, b, *st)
    return x, {"iters": iters, "resnorm_sq": resnorm_sq, "converged": converged}
