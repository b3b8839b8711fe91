"""Assembled 5-point stencils and the masked-early-exit BiCGStab
(counterpart of :mod:`na_dd_tpu.ops.linsolve`, the parts on the main path).

A Newton operator is held as five dense coefficient planes
(:class:`Stencil5`).  :func:`bicgstab_unrolled` is the algebraic reference
that the hand-written solve kernel (:mod:`na_dd_tpu_torch.ops.kernels`) and
its plain twin reproduce.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from na_dd_tpu_torch.ops.grid import Grid
from na_dd_tpu_torch.ops.shifts import Ops


class Stencil5(NamedTuple):
    """out[ij] = c0·w[ij] + cxm·w[i-1,j] + cxp·w[i+1,j] + cym·w[i,j-1]
    + cyp·w[i,j+1]."""

    c0: torch.Tensor
    cxm: torch.Tensor
    cxp: torch.Tensor
    cym: torch.Tensor
    cyp: torch.Tensor

    def apply(self, ops: Ops, w):
        return (
            self.c0 * w
            + self.cxm * ops.shift_xm(w)
            + self.cxp * ops.shift_xp(w)
            + self.cym * ops.shift_ym(w)
            + self.cyp * ops.shift_yp(w)
        )

    def transpose(self, ops: Ops) -> "Stencil5":
        """Planes of Aᵀ, again a 5-point stencil: (Aᵀv)[ij] = c0[ij]v[ij]
        + cxp[i-1,j]v[i-1,j] + cxm[i+1,j]v[i+1,j] + cyp[i,j-1]v[i,j-1]
        + cym[i,j+1]v[i,j+1].  Each off-diagonal plane swaps with its
        partner and shifts by one (zero inflow); the diagonal is unchanged.
        The adjoint solves (:mod:`na_dd_tpu_torch.ops.adjoint`) run on
        these planes."""
        return Stencil5(
            c0=self.c0,
            cxm=ops.shift_xm(self.cxp),
            cxp=ops.shift_xp(self.cxm),
            cym=ops.shift_ym(self.cyp),
            cyp=ops.shift_yp(self.cym),
        )


def diffusion_planes(g: Grid, ops: Ops, ax, ay) -> Stencil5:
    """Planes of w ↦ D*_x(ax ⊙ D_{-x} w) + D*_y(ay ⊙ D_{-y} w)."""
    cxp = g.inv_hh_phalf * ops.shift_xp(ax * g.inv_hh)
    cxm = g.inv_hh_phalf * ax * g.inv_hh
    cyp = g.inv_kk_phalf * ops.shift_yp(ay * g.inv_kk)
    cym = g.inv_kk_phalf * ay * g.inv_kk
    return Stencil5(c0=-(cxp + cxm + cyp + cym), cxm=cxm, cxp=cxp, cym=cym, cyp=cyp)


def advection_planes(g: Grid, ops: Ops, bx, by) -> Stencil5:
    """Planes of w ↦ -D*_x(M_x(bx ⊙ w)) - D*_y(M_y(by ⊙ w))."""
    half_x = 0.5 * g.inv_hh_phalf
    half_y = 0.5 * g.inv_kk_phalf
    cxp = -half_x * ops.shift_xp(bx * g.mask_x1)
    cxm = half_x * ops.shift_xm(bx) * g.mask_x1
    c0x = -half_x * bx * (ops.shift_xp(g.mask_x1) - g.mask_x1)
    cyp = -half_y * ops.shift_yp(by * g.mask_y1)
    cym = half_y * ops.shift_ym(by) * g.mask_y1
    c0y = -half_y * by * (ops.shift_yp(g.mask_y1) - g.mask_y1)
    return Stencil5(c0=c0x + c0y, cxm=cxm, cxp=cxp, cym=cym, cyp=cyp)


def midpoint_coupling_planes(g: Grid, ops: Ops, ax, ay) -> Stencil5:
    """Planes of w ↦ D*_x(ax ⊙ M_x w) + D*_y(ay ⊙ M_y w)."""
    half_x = 0.5 * g.inv_hh_phalf
    half_y = 0.5 * g.inv_kk_phalf
    axm = ax * g.mask_x1
    aym = ay * g.mask_y1
    cxp = half_x * ops.shift_xp(axm)
    cxm = -half_x * axm
    cyp = half_y * ops.shift_yp(aym)
    cym = -half_y * aym
    return Stencil5(c0=(cxp + cxm) + (cyp + cym), cxm=cxm, cxp=cxp, cym=cym, cyp=cyp)


def newton_planes(g: Grid, ops: Ops, L: Stencil5, dt) -> Stencil5:
    """Planes of the interior Newton operator w ↦ m·(2(w·m) − dt·m·L(w·m)),
    m = interior_mask."""
    m = g.interior_mask
    return Stencil5(
        c0=m * (2.0 - dt * L.c0),
        cxm=-dt * m * L.cxm * ops.shift_xm(m),
        cxp=-dt * m * L.cxp * ops.shift_xp(m),
        cym=-dt * m * L.cym * ops.shift_ym(m),
        cyp=-dt * m * L.cyp * ops.shift_yp(m),
    )


def stencil_add_diag(st: Stencil5, d) -> Stencil5:
    """st + diag(d)."""
    return st._replace(c0=st.c0 + d)


def _safe_div(num, den, eps_div):
    den_ok = torch.abs(den) > eps_div
    quotient = num / torch.where(den_ok, den, torch.ones_like(den))
    return torch.where(den_ok, quotient, torch.zeros_like(num)), den_ok


def bicgstab_unrolled(
    matvec,
    b,
    x0,
    *,
    dot,
    minv=None,
    tol: float = 1e-13,
    iters: int = 16,
):
    """Preconditioned BiCGStab, ``iters`` masked-early-exit iterations.

    Once ``done`` trips the remaining iterations keep every carried value, so
    the result equals a loop that stops there; ``iters_used`` counts only the
    iterations taken while not done.  Everything stays in tensors: no host
    synchronisation inside the solve.

    ``dot`` sets the systems: a whole-array sum solves one, a sum per entry of
    a leading batch dimension (kept as (B, 1, ...)) solves each entry alone
    under ``jax.vmap``'s semantics: every system carries its own scalars,
    ``done`` and ``iters_used`` (shaped as ``dot``'s result), and a system
    that is done keeps its ``x`` while the others iterate.  ``safe_div``'s guard is
    ``|den| > 1e-300`` cast to the dtype, which is ``|den| > 0`` in float32.
    """
    if minv is None:
        minv = lambda r: r  # noqa: E731
    eps_div = torch.tensor(1e-300, dtype=b.dtype, device=b.device)

    r = b - matvec(x0)
    rhat = r
    tol_sq = tol * tol * dot(b, b)
    x = x0
    z = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    p, v = z, z
    rho = alpha = omega = one
    done = dot(r, r) <= tol_sq
    iters_used = torch.zeros_like(done, dtype=torch.int32)

    def keep(old, new):
        return torch.where(done, old, new)

    for _ in range(iters):
        rho1 = dot(rhat, r)
        ratio, ok1 = _safe_div(rho1, rho, eps_div)
        aw, ok2 = _safe_div(alpha, omega, eps_div)
        beta = ratio * aw
        p_new = r + beta * (p - omega * v)
        phat = minv(p_new)
        v_new = matvec(phat)
        alpha_new, ok3 = _safe_div(rho1, dot(rhat, v_new), eps_div)
        s = r - alpha_new * v_new
        x_half = x + alpha_new * phat
        s_conv = dot(s, s) <= tol_sq

        shat = minv(s)
        t = matvec(shat)
        omega_new, ok4 = _safe_div(dot(t, s), dot(t, t), eps_div)
        x_full = x_half + omega_new * shat
        r_new = torch.where(s_conv, s, s - omega_new * t)
        x_new = torch.where(s_conv, x_half, x_full)

        breakdown = ~(ok1 & ok2 & ok3 & ok4)
        x = keep(x, x_new)
        r = keep(r, r_new)
        p = keep(p, p_new)
        v = keep(v, v_new)
        rho = keep(rho, rho1)
        alpha = keep(alpha, alpha_new)
        omega = keep(omega, omega_new)
        iters_used = iters_used + (~done).to(torch.int32)
        done = done | s_conv | breakdown | (dot(r, r) <= tol_sq)

    rsq = dot(r, r)
    return x, {"iters": iters_used, "resnorm_sq": rsq, "converged": rsq <= tol_sq}
