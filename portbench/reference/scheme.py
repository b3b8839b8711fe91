"""The paper's scheme in plain torch, written once for 2-D and 3-D: the
yardstick the benchmark holds the program's outputs to.

Arrays are (B, n, n) or (B, n, n, n): B independent systems (one η each)
on the uniform grid of N cells a side, n = N+1 nodes, homogeneous
Dirichlet boundary.  Staggered operators along axis a (h the node spacing,
h_{i+1/2} the dual-cell width):

    M_a u[i]   = (u[i] + u[i−1]) / 2        (0 at i = 0)
    D−_a u[i]  = (u[i] − u[i−1]) / h_i      (0 at i = 0)
    D*_a u[i]  = (u[i+1] − u[i]) / h_{i+1/2} (0 at i = 0, N)

A step is the predictor–corrector trapezoidal scheme: cp and cs predicted
by Heun's method; (T, cl, cd) advanced by ``sweeps`` Gauss–Seidel Newton
sweeps over the triangular coupling T → cl → cd, each linear solve
Jacobi-preconditioned BiCGStab from 0 to a relative residual ``tol`` on the
Newton operator w ↦ 2w − dt·J w restricted to the interior, J the field's
derivative in its own variable applied as the difference of two
evaluations of the field, which is affine in it (no assembled planes), and
the cross couplings as forward-mode tangents of the increments; cp
corrected in closed form; cs by pointwise Newton on the regularized
Heaviside corrector, stopped when max|dx| < 1e-6·min|x| over the system.
T is re-zeroed on the boundary by each sweep, cl and cd keep their boundary
values, the correctors zero cp and cs there.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from portbench.reference.mms import FIELDS, Manufactured

#: relative residual of every linear solve, by working dtype
SOLVE_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
SOLVE_MAXITER = 300


class Grid:
    """Uniform grid of N cells a side in ``dim`` dimensions; every array
    (1, n, ..., n), to broadcast against a batch."""

    def __init__(self, N: int, dim: int, dtype, device):
        self.N, self.dim, self.dtype, self.device = N, dim, dtype, device
        n = N + 1
        x = np.linspace(0.0, 1.0, n)
        h = np.concatenate([[0.0], np.diff(x)])
        hp = np.zeros(n)
        hp[1:N] = 0.5 * (h[1:N] + h[2:])
        lo = np.zeros(n)
        lo[1:] = 0.5 * (x[:-1] + x[1:])

        def recip(a):
            out = np.zeros_like(a)
            out[a != 0] = 1.0 / a[a != 0]
            return out

        inner = np.zeros(n)
        inner[1:N] = 1.0
        self.coords, self.dual_lo, self.dual_w = [], [], []
        self.inv_h, self.inv_hp, self.after0, self.h, self.hp = [], [], [], [], []
        mask = 1.0
        parity = 0
        for a in range(dim):
            self.coords.append(self.along(a, x))
            self.dual_lo.append(self.along(a, lo))
            self.dual_w.append(self.along(a, hp))
            self.inv_h.append(self.along(a, recip(h)))
            self.inv_hp.append(self.along(a, recip(hp)))
            self.after0.append(self.along(a, (np.arange(n) > 0).astype(float)))
            self.h.append(self.along(a, h))
            self.hp.append(self.along(a, hp))
            mask = mask * self.along(a, inner)
            parity = parity + self.along(a, np.arange(n, dtype=float))
        self.mask = mask
        self.red = (torch.remainder(parity, 2.0) == 0).to(dtype)
        self.black = 1.0 - self.red

    def along(self, a: int, v):
        shape = [1] * (self.dim + 1)
        shape[a + 1] = -1
        return torch.as_tensor(v, dtype=self.dtype, device=self.device).reshape(shape)

    # zero-inflow neighbours along spatial axis a
    def prev(self, u, a):
        ax = a + 1
        n = u.shape[ax]
        return torch.cat([torch.zeros_like(u.narrow(ax, 0, 1)), u.narrow(ax, 0, n - 1)], ax)

    def next(self, u, a):
        ax = a + 1
        n = u.shape[ax]
        return torch.cat([u.narrow(ax, 1, n - 1), torch.zeros_like(u.narrow(ax, 0, 1))], ax)

    def mid(self, u, a):
        return 0.5 * (u + self.prev(u, a)) * self.after0[a]

    def dminus(self, u, a):
        return (u - self.prev(u, a)) * self.inv_h[a]

    def dstar(self, u, a):
        return (self.next(u, a) - u) * self.inv_hp[a]

    def total(self, u):
        """Sum over each system, kept as (B, 1, ...)."""
        return torch.sum(u, dim=tuple(range(1, self.dim + 1)), keepdim=True)

    def amax(self, u):
        return torch.amax(u, dim=tuple(range(1, self.dim + 1)), keepdim=True)


class Model:
    """The RegHCs model's coefficients and forcing-free right-hand sides."""

    def __init__(self, consts: dict, grid: Grid, eta):
        self.c = consts
        self.g = grid
        self.eta = eta

    def Dl(self, cp):
        return self.c["Dl_max"] * torch.exp(-self.c["phi_l"] * cp)

    def Dd(self, cp, T):
        c = self.c
        return c["Dd_max"] * torch.exp(-c["phi_d"] * cp) * torch.exp(-c["phi_T"] / (T + c["T_ref"]))

    def reaction(self, s):
        c = self.c
        return c["Kd"] * (c["Sd"] - s["cd"]) * (s["cl"] + 1.0) * torch.sigmoid(self.eta * s["cs"])

    def rhs(self, name, s):
        """The field ``name`` without its forcing, 0 on the boundary."""
        c, g = self.c, self.g
        cp, T, cl, cd = s["cp"], s["T"], s["cl"], s["cd"]
        axes = range(g.dim)
        if name == "cp":
            out = -c["K1"] * (cl + 1.0) * cp - c["K2"] * T * cp
        elif name == "T":
            out = sum(g.dstar(c["DT"] * g.dminus(T, a), a) for a in axes) - c["K3"] * cp * T
        elif name == "cl":
            vel = [c["gamma_T"] * T] + [torch.zeros_like(T)] * (g.dim - 1)
            out = sum(g.dstar(self.Dl(g.mid(cp, a)) * g.dminus(cl, a)
                              - g.mid(vel[a] * (cl + 1.0), a), a) for a in axes)
            out = out - c["K4"] * cp * (cl + 1.0)
        elif name == "cd":
            out = sum(g.dstar(self.Dd(g.mid(cp, a), g.mid(T, a)) * g.dminus(cd, a), a)
                      for a in axes) + self.reaction(s)
        elif name == "cs":
            out = -self.reaction(s)
        else:
            raise KeyError(name)
        return out * g.mask


def bicgstab(matvec, b, inv_diag, total, tol: float, maxiter: int = SOLVE_MAXITER):
    """Right-Jacobi-preconditioned BiCGStab from x = 0 for each system of a
    batch, each stopped (frozen) once its residual is below tol·‖b‖."""
    x = torch.zeros_like(b)
    r = b.clone()
    rhat = b.clone()
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones_like(total(b))
    rho, alpha, omega = one, one, one
    limit = tol * tol * total(b * b)
    done = total(r * r) <= limit
    for _ in range(maxiter):
        if bool(done.all()):
            break
        rho_new = total(rhat * r)
        beta = (rho_new / rho) * (alpha / omega)
        p_new = r + beta * (p - omega * v)
        y = inv_diag * p_new
        v_new = matvec(y)
        alpha_new = rho_new / total(rhat * v_new)
        s = r - alpha_new * v_new
        x_half = x + alpha_new * y
        s_ok = total(s * s) <= limit
        z = inv_diag * s
        t = matvec(z)
        tt = total(t * t)
        omega_new = torch.where(tt > 0, total(t * s) / torch.where(tt > 0, tt, one), one)
        x_new = torch.where(s_ok, x_half, x_half + omega_new * z)
        r_new = torch.where(s_ok, s, s - omega_new * t)
        keep = done
        x = torch.where(keep, x, x_new)
        r = torch.where(keep, r, r_new)
        p = torch.where(keep, p, p_new)
        v = torch.where(keep, v, v_new)
        rho = torch.where(keep, rho, rho_new)
        alpha = torch.where(keep, alpha, alpha_new)
        omega = torch.where(keep, omega, omega_new)
        done = done | s_ok | (total(r * r) <= limit)
    return x


class Scheme:
    """One RegHCs simulation of B members (η one a member) of a
    manufactured case."""

    def __init__(self, *, case: str, consts: dict, N: int, dim: int, etas, sweeps: int,
                 dtype=torch.float64, device="cpu", mms: Manufactured | None = None):
        self.g = Grid(N, dim, dtype, device)
        shape = (-1,) + (1,) * dim
        self.eta = torch.as_tensor(list(etas), dtype=dtype, device=device).reshape(shape)
        self.model = Model(consts, self.g, self.eta)
        self.mms = mms if mms is not None else Manufactured(case, consts, dim)
        self.sweeps = int(sweeps)
        self.tol = SOLVE_TOL[dtype]
        self.B = self.eta.shape[0]
        self._forcing = {}

    def time(self, t):
        return torch.as_tensor(t, dtype=self.g.dtype, device=self.g.device)

    def initial_state(self):
        s = self.mms.exact_state(self.g, self.time(0.0))
        return {k: v.expand(self.B, *v.shape[1:]).contiguous() for k, v in s.items()}

    def forcing(self, k: int, dt: float):
        """The forcing at t_k = k·dt, kept for the two latest k."""
        if k not in self._forcing:
            if len(self._forcing) >= 2:
                self._forcing.pop(min(self._forcing))
            self._forcing[k] = self.mms.forcing_terms(self.g, self.time(k * dt), self.eta)
        return self._forcing[k]

    def F(self, name, s, f):
        if name == "cs":
            return (f["cs"] - self.model.reaction(s)) * self.g.mask
        return f[name] + self.model.rhs(name, s)

    def _solve(self, name, s, rhs, dt):
        """The Newton correction of field ``name`` at ``s``: (2 − dt J) x =
        rhs on the interior."""
        g, m = self.g, self.g.mask

        # the field is affine in its own variable (linear in T; cl and cd
        # enter their fluxes linearly and their reactions affinely), so its
        # derivative along w is the difference of two evaluations, exactly
        base = self.model.rhs(name, {**s, name: torch.zeros_like(s[name])})

        def A(w):
            wm = w * m
            return m * (2.0 * wm - dt * (self.model.rhs(name, {**s, name: wm}) - base))

        diag = A(g.red) * g.red + A(g.black) * g.black
        inv = torch.where(m > 0, 1.0 / torch.where(m > 0, diag, torch.ones_like(diag)),
                          torch.zeros_like(diag))
        return bicgstab(A, rhs * m, inv, g.total, self.tol) * m

    def _tangent(self, name, s, directions):
        """The derivative of field ``name`` at ``s`` along ``directions``
        ({field: increment}), by forward-mode automatic differentiation."""
        with fwAD.dual_level():
            duals = {k: fwAD.make_dual(s[k], w) for k, w in directions.items()}
            return fwAD.unpack_dual(self.model.rhs(name, {**s, **duals})).tangent

    def _sweep(self, s, Y, f1, dt):
        m = self.g.mask
        rhs_T = Y["T"] - (2.0 * s["T"] - dt * self.F("T", s, f1))
        T1 = s["T"] * m + self._solve("T", s, rhs_T, dt)
        wT = (T1 - s["T"]) * m

        jcl = self._tangent("cl", s, {"T": wT})
        rhs_cl = Y["cl"] - 2.0 * s["cl"] + dt * self.F("cl", s, f1) + dt * jcl
        cl1 = s["cl"] + self._solve("cl", s, rhs_cl, dt)
        wcl = (cl1 - s["cl"]) * m

        jcd = self._tangent("cd", s, {"T": wT, "cl": wcl})
        rhs_cd = Y["cd"] - 2.0 * s["cd"] + dt * self.F("cd", s, f1) + dt * jcd
        cd1 = s["cd"] + self._solve("cd", s, rhs_cd, dt)
        return T1, cl1, cd1

    def _heun(self, name, s0, f0, f1, dt):
        F0 = self.F(name, s0, f0)
        star = {**s0, name: s0[name] + dt * F0}
        return s0[name] + 0.5 * dt * (F0 + self.F(name, star, f1))

    def _cs_newton(self, y, a, x, iters: int = 5, rtol: float = 1e-6):
        """x solving 2x + (2x − y)e^{−ηx} = y − a pointwise; for ηx < −300
        the residual and its derivative are both scaled by e^{ηx}."""
        eta = self.eta
        done = torch.zeros_like(self.g.total(x), dtype=torch.bool)
        for _ in range(iters):
            big = eta * x < -300.0
            xo = torch.where(big, torch.zeros_like(x), x)
            e = torch.exp(-eta * xo)
            f_o = 2.0 * xo + (2.0 * xo - y) * e - y + a
            d_o = 2.0 + 2.0 * e - eta * (2.0 * xo - y) * e
            xs = torch.where(big, x, torch.zeros_like(x))
            ep = torch.exp(eta * xs)
            f_s = (2.0 * xs - y + a) * ep + (2.0 * xs - y)
            d_s = 2.0 * ep + 2.0 - eta * (2.0 * xs - y)
            dx = -torch.where(big, f_s, f_o) / torch.where(big, d_s, d_o)
            x_new = x + dx
            small = self.g.amax(torch.abs(dx)) < rtol * (-self.g.amax(-torch.abs(x_new)))
            x = torch.where(done, x, x_new)
            done = done | small
        return x

    def step(self, s0, k: int, dt: float):
        c, m = self.model.c, self.g.mask
        f0, f1 = self.forcing(k, dt), self.forcing(k + 1, dt)
        Y = {v: dt * self.F(v, s0, f0) + 2.0 * s0[v] for v in ("T", "cl", "cd")}
        cp1 = self._heun("cp", s0, f0, f1, dt)
        cs1 = self._heun("cs", s0, f0, f1, dt) * m
        T1, cl1, cd1 = s0["T"], s0["cl"], s0["cd"]
        for _ in range(self.sweeps):
            s = {"cp": cp1, "T": T1, "cl": cl1, "cd": cd1, "cs": cs1}
            T1, cl1, cd1 = self._sweep(s, Y, f1, dt)
        # cp: trapezoidal, closed form
        a0 = -c["K2"] * s0["T"] - c["K1"] * (s0["cl"] + 1.0)
        a1 = -c["K2"] * T1 - c["K1"] * (cl1 + 1.0)
        cp1 = m * ((1.0 + 0.5 * dt * a0) * s0["cp"] + 0.5 * dt * (f0["cp"] + f1["cp"])) / (
            1.0 - 0.5 * dt * a1)
        # cs: regularized-Heaviside trapezoidal corrector
        H0 = torch.sigmoid(self.eta * s0["cs"])
        y = (2.0 * s0["cs"] - dt * c["Kd"] * (c["Sd"] - s0["cd"]) * (s0["cl"] + 1.0) * H0
             + dt * (f0["cs"] + f1["cs"]))
        a = dt * c["Kd"] * (c["Sd"] - cd1) * (cl1 + 1.0)
        cs1 = self._cs_newton(y, a, s0["cs"]) * m
        return {"cp": cp1, "T": T1, "cl": cl1, "cd": cd1, "cs": cs1}

    # the combined max-integral error of the 3-D study
    def error_terms(self, s, t):
        """(Σ_v ||e_v||_H², Σ_{T,cl,cd} ||∇e_v||², per-field ||e_v||_H²) a
        member, against the exact fields at t."""
        g = self.g
        ex = self.mms.exact_state(g, self.time(t))
        wH = 1.0
        for a in range(g.dim):
            wH = wH * g.hp[a]
        wH = wH * g.mask
        total, grad, per = 0.0, 0.0, {}
        for v in FIELDS:
            e = s[v] - ex[v]
            per[v] = g.total(e * e * wH)
            total = total + per[v]
            if v in ("T", "cl", "cd"):
                for a in range(g.dim):
                    w = g.h[a]
                    for b in range(g.dim):
                        if b != a:
                            w = w * g.hp[b]
                    d = g.dminus(e, a)
                    grad = grad + g.total(d * d * w)
        return total, grad, per

    def simulate(self, num_steps: int, dt: float, errors: bool = False):
        """The final state after ``num_steps`` steps from the exact state at
        0 and, with ``errors``, (the combined max-integral error, per-field
        final H errors) a member."""
        s = self.initial_state()
        if errors:
            worst, prev, _ = self.error_terms(s, 0.0)
            integral = torch.zeros_like(worst)
        for k in range(num_steps):
            s = self.step(s, k, dt)
            if errors:
                tot, grad, _ = self.error_terms(s, (k + 1) * dt)
                integral = integral + 0.5 * dt * (prev + grad)
                worst = torch.maximum(worst, tot + integral)
                prev = grad
        if not errors:
            return s, None
        _, _, per = self.error_terms(s, num_steps * dt)
        return s, {"error": torch.sqrt(worst).reshape(-1),
                   "final": {v: torch.sqrt(per[v]).reshape(-1) for v in FIELDS}}


def steps_of(Tf: float, dt: float):
    """(number of steps, the step that lands on Tf)."""
    n = max(1, int(math.ceil(Tf / dt)))
    return n, Tf / n
