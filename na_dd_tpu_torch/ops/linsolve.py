"""Assembled 5-point stencils, colour probing and BiCGStab (counterpart of
:mod:`na_dd_tpu.ops.linsolve`).

A Newton operator is held as five dense coefficient planes
(:class:`Stencil5`), built in closed form or extracted from any distance-1
linear map by colour probing (:func:`probe_stencil`; its diagonal alone by
:func:`probe_diag`).  :func:`bicgstab_unrolled` is the algebraic reference
that the hand-written solve kernel (:mod:`na_dd_tpu_torch.ops.kernels`) and
its plain twin reproduce; :func:`bicgstab` is the while form, whose early
exit is a true one (one host read an iteration), and the solve of the
matrix-free Newton route (:func:`newton_inner_solve`), which has no kernel.
:func:`bicgstab_ops` is the solve of one rank's block of a sharded system
(the JAX package's jnp solve under ``shard_map``, which its sharded path
runs): no single kernel can hold a dot product summed across ranks.

Not ported: ``probe_stencil_vmapped`` and ``bicgstab_scanned``, which exist
for the size and compile time of XLA programs.
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


def checkerboard_masks(g: Grid):
    """The red/black parity masks of diagonal probing."""
    return g.red_mask, 1.0 - g.red_mask


def probe_diag(matvec, red, black):
    """Diagonal of a distance-1 operator from two probes: nodes of equal
    (i+j) parity never couple, so ``diag = Σ_c (A 1_c) ⊙ 1_c``."""
    return matvec(red) * red + matvec(black) * black


def probe_planes(matvec, colour, deltas, ncolours: int, dtype):
    """The planes of a distance-1 operator from ``ncolours`` probes
    ``A 1_c``: the coefficient at offset delta of node p is entry p of the
    probe of colour ``(colour[p] + delta) mod ncolours``.  Each pick selects
    one value, so the gather is exact."""
    probes = torch.stack([matvec((colour == k).to(dtype)) for k in range(ncolours)])
    planes = []
    for delta in deltas:
        idx = torch.remainder(colour + delta, ncolours).to(torch.int64)
        idx = idx.expand(probes.shape[1:]).unsqueeze(0)
        planes.append(torch.gather(probes, 0, idx).squeeze(0))
    return planes


# neighbour colour offsets under the (i + 2j) mod 5 colouring
_OFFSET_DELTA = {"c0": 0, "cxm": -1, "cxp": 1, "cym": -2, "cyp": 2}


def probe_stencil(matvec, g: Grid) -> Stencil5:
    """All five planes of a distance-1 operator from 5 probes on the
    (i + 2j) mod 5 colouring, under which a node and its four axis
    neighbours carry distinct colours (the neighbour at offset (a, b) has
    colour (c + a + 2b) mod 5)."""
    return Stencil5(*probe_planes(matvec, g.color5, _OFFSET_DELTA.values(), 5, g.xx.dtype))


def _safe_div(num, den, eps_div):
    den_ok = torch.abs(den) > eps_div
    quotient = num / torch.where(den_ok, den, torch.ones_like(den))
    return torch.where(den_ok, quotient, torch.zeros_like(num)), den_ok


def _bicgstab(matvec, b, x0, *, dot, minv, tol, atol, iters, host_exit):
    """The preconditioned BiCGStab iteration both forms share: ``iters``
    masked-early-exit iterations; with ``host_exit`` the loop also stops
    (one host read an iteration) once every system is done, which changes
    no value: a done system keeps everything it carries."""
    if minv is None:
        minv = lambda r: r  # noqa: E731
    eps_div = torch.tensor(1e-300, dtype=b.dtype, device=b.device)

    r = b - matvec(x0)
    rhat = r
    tol_sq = tol * tol * dot(b, b)
    if atol:
        tol_sq = torch.clamp_min(tol_sq, atol * atol)
    x = x0
    z = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    p, v = z, z
    rho = alpha = omega = one
    done = dot(r, r) <= tol_sq
    iters_used = torch.zeros_like(done, dtype=torch.int32)

    def keep(old, new):
        return torch.where(done, old, new)

    for _ in range(int(iters)):
        if host_exit and bool(done.all()):
            break
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
    return _bicgstab(matvec, b, x0, dot=dot, minv=minv, tol=tol, atol=0.0, iters=iters,
                     host_exit=False)



def bicgstab(
    matvec,
    b,
    x0,
    *,
    dot,
    minv=None,
    tol: float = 1e-13,
    atol: float = 0.0,
    maxiter: int = 200,
):
    """Preconditioned BiCGStab, the while form: iterate until every system
    is done (``‖r‖² ≤ max(tol²·‖b‖², atol²)``, or the half step converged,
    or a breakdown) or ``maxiter`` iterations, reading ``done`` on the host
    once an iteration.  The update is :func:`bicgstab_unrolled`'s, so the
    result equals an unrolled solve with any budget the exit falls inside;
    for one system ``iters`` is the while loop's trip count.  A batch
    (``dot`` per system) iterates until its last system is done, the done
    ones kept as they are."""
    return _bicgstab(matvec, b, x0, dot=dot, minv=minv, tol=tol, atol=atol, iters=maxiter,
                     host_exit=True)


def bicgstab_ops(ops, st, b, inv_diag, mask, *, tol: float, iters: int):
    """Jacobi-BiCGStab of ``st·x = b`` from x0 = 0 on the arrays of ``ops``
    (one rank's block under a halo-exchange provider): the matvec
    ``ops.matvec(st)``, the dots ``ops.asum(u·v)`` (all-reduced there), at
    most ``iters`` iterations of the while form (its exit reads the
    all-reduced verdict, the same on every rank); returns ``(x·mask,
    info)``."""
    x, info = bicgstab(
        ops.matvec(st), b, torch.zeros_like(b), dot=lambda u, v: ops.asum(u * v),
        minv=lambda r: r * inv_diag, tol=tol, maxiter=iters,
    )
    return x * mask, info


def linearized(fn, *primals):
    """``(fn(*primals), lin)`` with ``lin(*tangents)`` the Jacobian of ``fn``
    at ``primals`` applied to ``tangents``: the role of ``jax.linearize``.
    Each application is a ``torch.func.jvp`` at the fixed point, which
    evaluates the primal again; ``torch.func.linearize`` would trace the
    graph anew at every Newton solve, which costs more than the applies a
    solve makes."""

    def lin(*tangents):
        return torch.func.jvp(fn, primals, tangents)[1]

    return fn(*primals), lin


def interior_linearized_matvec(residual_fn, u0, g: Grid, dt):
    """``(F(u0), matvec)`` with ``matvec(w) = m·(2 w·m − dt·J_F[u0] (w·m))``,
    m = interior_mask: the interior Newton operator, matrix-free."""
    f0, f_lin = linearized(residual_fn, u0)
    m = g.interior_mask

    def matvec(w):
        wm = w * m
        return (2.0 * wm - dt * f_lin(wm)) * m

    return f0, matvec


def jacobi_from_diag(diag, mask):
    """``1/diag`` on the interior, 0 elsewhere (and where the diagonal is 0)."""
    safe = torch.where(diag == 0, torch.ones_like(diag), diag)
    return torch.where(mask > 0, 1.0 / safe, torch.zeros_like(diag))


def newton_inner_solve(
    residual_fn, u0, rhs, g: Grid, ops: Ops, dt, *, red, black, tol: float = 1e-13,
    maxiter: int = 200,
):
    """Solve ``m·(2I − dt·J_F[u0]) Δ = rhs·m`` for the Newton update by the
    while-form Jacobi-BiCGStab on the matrix-free operator, its diagonal
    from two probes.  Returns ``(F(u0), Δ, info)``, Δ zero on the
    boundary."""
    f0, matvec = interior_linearized_matvec(residual_fn, u0, g, dt)
    m = g.interior_mask
    inv_diag = jacobi_from_diag(probe_diag(matvec, red * m, black * m), m)
    b = rhs * m
    delta, info = bicgstab(
        matvec, b, torch.zeros_like(b), dot=lambda u, v: ops.asum(u * v),
        minv=lambda r: r * inv_diag, tol=tol, maxiter=maxiter,
    )
    return f0, delta * m, info
