"""Assembled 7-point stencils, 7-colour probing and the Crank–Nicolson heat
solve (counterpart of :mod:`na_dd_tpu.three_d.diffusion`).

A 3-D Newton operator is held as seven dense coefficient volumes
(:class:`Stencil7`): :class:`na_dd_tpu_torch.ops.linsolve.Stencil5` plus the
two z planes.  The plane builders are the closed forms of the JAX package,
:func:`probe_stencil3` extracts the same planes from any distance-1 linear
map; ``Stencil7.apply`` is the plain 7-point apply that the hand-written
kernel (:func:`na_dd_tpu_torch.ops.kernels.stencil7_apply`) reproduces.
:func:`crank_nicolson_heat_step` solves its masked system ``I − dt/2·L`` as
Stencil7 planes by the BiCGStab kernel (K5) and applies the rhs by K6;
:func:`heat_mms_error` runs it to a final time against a manufactured
solution.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from na_dd_tpu_torch.ops.linsolve import jacobi_from_diag, probe_planes
from na_dd_tpu_torch.three_d.grid import Grid3, make_uniform_grid3
from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3, Ops3
from na_dd_tpu_torch.three_d.stencils import Dx_reg3, Dx_star3, Dy_reg3, Dy_star3, Dz_reg3, Dz_star3


class Stencil7(NamedTuple):
    """out[ijk] = c0·w[ijk] + cxm·w[i-1,j,k] + cxp·w[i+1,j,k] + cym·w[i,j-1,k]
    + cyp·w[i,j+1,k] + czm·w[i,j,k-1] + czp·w[i,j,k+1]."""

    c0: torch.Tensor
    cxm: torch.Tensor
    cxp: torch.Tensor
    cym: torch.Tensor
    cyp: torch.Tensor
    czm: torch.Tensor
    czp: torch.Tensor

    def apply(self, ops: Ops3, w):
        return (
            self.c0 * w
            + self.cxm * ops.shift_xm(w)
            + self.cxp * ops.shift_xp(w)
            + self.cym * ops.shift_ym(w)
            + self.cyp * ops.shift_yp(w)
            + self.czm * ops.shift_zm(w)
            + self.czp * ops.shift_zp(w)
        )

    def transpose(self, ops: Ops3) -> "Stencil7":
        """Planes of Aᵀ, again a 7-point stencil: each off-diagonal plane
        swaps with its partner and shifts by one (zero inflow), as
        :meth:`na_dd_tpu_torch.ops.linsolve.Stencil5.transpose` does in 2-D;
        the diagonal is unchanged.  The 3-D adjoint solves run on these."""
        return Stencil7(
            c0=self.c0,
            cxm=ops.shift_xm(self.cxp),
            cxp=ops.shift_xp(self.cxm),
            cym=ops.shift_ym(self.cyp),
            cyp=ops.shift_yp(self.cym),
            czm=ops.shift_zm(self.czp),
            czp=ops.shift_zp(self.czm),
        )


def diffusion_apply3(ops: Ops3, g: Grid3, ax, ay, az, u):
    """w ↦ D*_x(ax ⊙ D₋x w) + D*_y(ay ⊙ D₋y w) + D*_z(az ⊙ D₋z w), the
    matrix-free 3-D diffusion operator whose planes
    :func:`diffusion_planes3` gives; ``ax[i,j,k]`` multiplies the flux at the
    lower x-face of node i, where ``D₋x w`` lives."""
    return (
        Dx_star3(ops, g, ax * Dx_reg3(ops, g, u))
        + Dy_star3(ops, g, ay * Dy_reg3(ops, g, u))
        + Dz_star3(ops, g, az * Dz_reg3(ops, g, u))
    )


def diffusion_planes3(g: Grid3, ops: Ops3, ax, ay, az) -> Stencil7:
    """Planes of w ↦ D*_x(ax ⊙ D₋x w) + D*_y(ay ⊙ D₋y w) + D*_z(az ⊙ D₋z w)."""
    cxp = g.inv_hh_phalf * ops.shift_xp(ax * g.inv_hh)
    cxm = g.inv_hh_phalf * ax * g.inv_hh
    cyp = g.inv_kk_phalf * ops.shift_yp(ay * g.inv_kk)
    cym = g.inv_kk_phalf * ay * g.inv_kk
    czp = g.inv_ll_phalf * ops.shift_zp(az * g.inv_ll)
    czm = g.inv_ll_phalf * az * g.inv_ll
    return Stencil7(
        c0=-(cxp + cxm + cyp + cym + czp + czm),
        cxm=cxm,
        cxp=cxp,
        cym=cym,
        cyp=cyp,
        czm=czm,
        czp=czp,
    )


def advection_planes3(g: Grid3, ops: Ops3, bx, by, bz) -> Stencil7:
    """Planes of w ↦ −D*_x(M_x(bx⊙w)) − D*_y(M_y(by⊙w)) − D*_z(M_z(bz⊙w))."""
    half_x = 0.5 * g.inv_hh_phalf
    half_y = 0.5 * g.inv_kk_phalf
    half_z = 0.5 * g.inv_ll_phalf
    cxp = -half_x * ops.shift_xp(bx * g.mask_x1)
    cxm = half_x * ops.shift_xm(bx) * g.mask_x1
    c0x = -half_x * bx * (ops.shift_xp(g.mask_x1) - g.mask_x1)
    cyp = -half_y * ops.shift_yp(by * g.mask_y1)
    cym = half_y * ops.shift_ym(by) * g.mask_y1
    c0y = -half_y * by * (ops.shift_yp(g.mask_y1) - g.mask_y1)
    czp = -half_z * ops.shift_zp(bz * g.mask_z1)
    czm = half_z * ops.shift_zm(bz) * g.mask_z1
    c0z = -half_z * bz * (ops.shift_zp(g.mask_z1) - g.mask_z1)
    return Stencil7(
        c0=c0x + c0y + c0z, cxm=cxm, cxp=cxp, cym=cym, cyp=cyp, czm=czm, czp=czp
    )


def midpoint_coupling_planes3(g: Grid3, ops: Ops3, ax, ay, az) -> Stencil7:
    """Planes of w ↦ D*_x(ax ⊙ M_x w) + D*_y(ay ⊙ M_y w) + D*_z(az ⊙ M_z w):
    the coefficient outside the midpoint average (a diffusion coefficient's
    state-derivative)."""
    half_x = 0.5 * g.inv_hh_phalf
    half_y = 0.5 * g.inv_kk_phalf
    half_z = 0.5 * g.inv_ll_phalf
    axm = ax * g.mask_x1
    aym = ay * g.mask_y1
    azm = az * g.mask_z1
    cxp = half_x * ops.shift_xp(axm)
    cxm = -half_x * axm
    cyp = half_y * ops.shift_yp(aym)
    cym = -half_y * aym
    czp = half_z * ops.shift_zp(azm)
    czm = -half_z * azm
    return Stencil7(
        c0=(cxp + cxm) + (cyp + cym) + (czp + czm),
        cxm=cxm,
        cxp=cxp,
        cym=cym,
        cyp=cyp,
        czm=czm,
        czp=czp,
    )


def newton_planes3(g: Grid3, ops: Ops3, L: Stencil7, dt) -> Stencil7:
    """Planes of the interior Newton operator w ↦ m·(2(w·m) − dt·m·L(w·m)),
    m = interior_mask."""
    m = g.interior_mask
    return Stencil7(
        c0=m * (2.0 - dt * L.c0),
        cxm=-dt * m * L.cxm * ops.shift_xm(m),
        cxp=-dt * m * L.cxp * ops.shift_xp(m),
        cym=-dt * m * L.cym * ops.shift_ym(m),
        cyp=-dt * m * L.cyp * ops.shift_yp(m),
        czm=-dt * m * L.czm * ops.shift_zm(m),
        czp=-dt * m * L.czp * ops.shift_zp(m),
    )


def stencil_add_diag3(st: Stencil7, d) -> Stencil7:
    """st + diag(d)."""
    return st._replace(c0=st.c0 + d)


# neighbour colour offsets under the (i + 2j + 3k) mod 7 colouring
_OFFSET_DELTA7 = {"c0": 0, "cxm": -1, "cxp": 1, "cym": -2, "cyp": 2, "czm": -3, "czp": 3}


def probe_stencil3(matvec, g: Grid3) -> Stencil7:
    """All seven planes of a distance-1 3-D operator from 7 probes on the
    (i + 2j + 3k) mod 7 colouring (the neighbour at offset (a, b, c) has
    colour (q + a + 2b + 3c) mod 7, distinct for the seven points)."""
    return Stencil7(*probe_planes(matvec, g.color7, _OFFSET_DELTA7.values(), 7, g.xx.dtype))


def heat_planes(g: Grid3, ops: Ops3, st: Stencil7, dt) -> Stencil7:
    """Planes of the masked Crank–Nicolson operator w ↦ m·(w − dt/2·L w) on
    the masked subspace, m = interior_mask (each off-diagonal also carries
    the neighbour's mask, which changes nothing there)."""
    m = g.interior_mask
    h = 0.5 * dt
    return Stencil7(
        c0=m * (1.0 - h * st.c0),
        cxm=-h * m * st.cxm * ops.shift_xm(m),
        cxp=-h * m * st.cxp * ops.shift_xp(m),
        cym=-h * m * st.cym * ops.shift_ym(m),
        cyp=-h * m * st.cyp * ops.shift_yp(m),
        czm=-h * m * st.czm * ops.shift_zm(m),
        czp=-h * m * st.czp * ops.shift_zp(m),
    )


def crank_nicolson_heat_step(
    g: Grid3, ops: Ops3, st: Stencil7, u, f_n, f_np1, dt, *, tol: float = 1e-12,
    iters: int = 32, planes: Stencil7 | None = None,
):
    """One Crank–Nicolson step of u_t = L u + f with a homogeneous Dirichlet
    boundary (L the assembled diffusion stencil ``st``):

        (I − dt/2 L) u^{n+1} = (I + dt/2 L) u^n + dt (f^n + f^{n+1}) / 2

    on the masked interior.  The rhs applies ``st`` by
    :func:`~na_dd_tpu_torch.ops.kernels.stencil7_apply` (K6 on CUDA
    tensors); the system, as :func:`heat_planes` (``planes``, built once by
    a caller that loops), goes to
    :func:`~na_dd_tpu_torch.ops.kernels.bicgstab_solve3` (K5: Jacobi
    BiCGStab from 0, ``iters`` masked-early-exit iterations to ``tol``),
    the update of the JAX package's ``bicgstab_unrolled``.  Returns
    ``(u_next, info)``."""
    from na_dd_tpu_torch.ops import kernels

    mask = g.interior_mask
    if planes is None:
        planes = heat_planes(g, ops, st, dt)
    rhs = mask * (u + (0.5 * dt) * kernels.stencil7_apply(st, u) + dt * 0.5 * (f_n + f_np1))
    inv_diag = jacobi_from_diag(planes.c0, mask)
    u_next, info = kernels.bicgstab_solve3(planes, rhs, inv_diag, mask, tol=tol, iters=iters)
    return u_next * mask, info


def heat_mms_error(
    N: int, *, D: float = 0.1, Tf: float = 0.1, dt: float | None = None, iters: int = 32,
    ops: Ops3 = LOCAL_OPS3, g: Grid3 | None = None, dtype=None, device=None,
) -> float:
    """The 3-D heat solve's manufactured-solution error: exact solution
    u = sin(πx) sin(πy) sin(πz) e^{−t}, constant diffusivity D, forcing
    (3π²D − 1)·u from the continuous operator, so the error is the
    discretization's, O(h²) + O(dt²).  ``num = round(Tf/dt)`` Crank–Nicolson
    steps (dt = Tf/20 by default) in a Python loop on the device, then the
    final-time ‖u_h − u‖_H (the w_H-weighted L² norm) in the run's one host
    transfer.  On the card unless ``device="cpu"`` (or a grid ``g``)."""
    if g is None:
        g = make_uniform_grid3(N, N, N, dtype=dtype, device=device)
    if dt is None:
        dt = Tf / 20.0
    num_steps = int(round(Tf / dt))
    pi = math.pi
    shape_fn = torch.sin(pi * g.xx) * torch.sin(pi * g.yy) * torch.sin(pi * g.zz)

    def exact(t):
        return shape_fn * math.exp(-t)

    def forcing(t):
        return (3.0 * pi**2 * D - 1.0) * exact(t) * g.interior_mask

    aD = torch.full_like(g.xx, D)
    st = diffusion_planes3(g, ops, aD, aD, aD)
    planes = heat_planes(g, ops, st, dt)
    u = exact(0.0) * g.interior_mask
    for n in range(num_steps):
        t_n = float(n) * dt
        u, _info = crank_nicolson_heat_step(
            g, ops, st, u, forcing(t_n), forcing(t_n + dt), dt, iters=iters, planes=planes
        )
    err = u - exact(num_steps * dt) * g.interior_mask
    return float(torch.sqrt(ops.asum(g.w_H * err * err)))
