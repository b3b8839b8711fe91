"""Predictor–corrector trapezoidal integrator — the paper's main scheme
(counterpart of :mod:`na_dd_tpu.integrators.pc_trapezoidal`, on the main
path's configuration).

Per step:

1. cp, cs predicted with modified Euler (Heun);
2. (T, cl, cd) advanced with the trapezoidal rule by Newton sweeps over the
   triangular coupling FT(T) → Fcl(T, cl) → Fcd(T, cl, cd): three interior
   linear solves per sweep on the closed-form Newton planes, the cross
   couplings entering the right-hand sides as ``torch.func.jvp`` tangents
   (``coupling_source="jvp"``, the default) or as closed-form coupling
   planes (``coupling_source="analytic"``);
3. cp corrected in closed form; cs by the variant's corrector: in closed
   form (:class:`PCTrapezoidalCsTriple`), by the sign-based exact solve
   (:class:`PCTrapezoidalHCsTriple`) or by a pointwise regularized-Heaviside
   Newton iteration (:class:`PCTrapezoidalRegHCsTriple`).

The Newton planes are closed-form (``stencil_source="analytic"``, the
default) or probed from the linearized field graph by 5 (2-D) or 7 (3-D)
colour probes (``stencil_source="probe"``); with ``assemble_stencil=False``
no planes are made and the solve is matrix-free (the plain BiCGStab on the
linearized graph, its Jacobi diagonal from two probes), which has no kernel
in either package.  The assembled solves go through one solver-backend
object: :class:`KrylovBackend` (``precision="full"``) runs the hand-written
BiCGStab kernel of the stencil's dimension in the working dtype on CUDA
tensors, its plain twin on CPU tensors; :class:`MixedBackend`
(``precision="mixed"``) runs the same kernels on float32 copies of the
planes under float64 iterative refinement; :class:`DirectBackend`
(``linear_solver="direct"``) solves exactly by block cyclic reduction (2-D
row blocks, 3-D x-plane blocks), and with ``precision="mixed"``
:class:`DirectMixedBackend` makes the float32 BCR the refinement's inner
solve.  ``krylov_unroll`` is the kernels' iteration budget; ``None`` is the
JAX package's while form, whose update is the same: the kernels run with a
budget of ``krylov_maxiter`` and break when done.

``differentiable=True`` makes the step reverse-mode differentiable: every
Newton solve goes through :func:`na_dd_tpu_torch.ops.adjoint.plane_solve`,
whose forward is the backend's own call (the same bits) and whose backward
solves the transposed system with the same backend (the BiCGStab kernel on
the transposed planes, for the Krylov backend on CUDA tensors).  Parameter
gradients (model constants that are tensors, the regularization factor, the
initial state) flow through the plane assembly, the ``torch.func.jvp``
couplings and the correctors by autograd.  The fused triple solve has no
adjoint, as in the JAX package, so under ``differentiable=True`` analytic
couplings take the per-solve route.  In 3-D the Krylov adjoints run on
``Stencil7.transpose`` volumes (K5); the 3-D integrators refuse
``differentiable=True`` with mixed or direct solves, which the JAX package
cannot run in 3-D.

With analytic couplings the whole sweep is stencil algebra, so in 2-D
``fused_triple=True`` (the default) hands the three solves and the coupling
applies between them to the backend's :meth:`KrylovBackend.solve_triple` as
one call: one launch of the fused triple-solve kernel on CUDA tensors.  The
JAX package ties that route to ``stencil_backend="pallas"``; the port has no
such switch (its wrappers pick the kernel by the tensor's device), so
``fused_triple`` alone selects it.  As in the JAX package the route needs an
iteration budget (an int ``krylov_unroll``): the while form (None, which the
default "auto" resolves to) takes the per-solve route, and every study and
batched entry point passes a budget.  ``fused_triple=False``, or a 3-D
system (the fused kernel is 2-D only, as in the JAX package), takes three
separate solves with the coupling planes applied between them.

The step also takes a leading batch dimension, the written-out counterpart
of ``jax.vmap`` over (grid, state, dt) or over η: a stack of states (B, ...)
with a stack of grids or one shared grid, ``t0``/``dt`` and the
regularization factor as (B, 1, 1) tensors, and a batched ops provider
(:class:`~na_dd_tpu_torch.ops.shifts.BatchedOps`), whose reductions give
each system its own Krylov verdict, positivity flag and Newton early exit.
Each Newton solve is then one launch of the batched kernel for all B
systems, and a fused sweep one launch of the batched triple solve (each
system with its own dt, scalars and verdicts).

Every backend's ``solve`` takes the step's ops provider, which owns what
differs under domain decomposition (``ops.sharded``: one rank's block, the
provider a ``HaloOps``/``HaloOps3``): there the Krylov solves become the
all-reduced Jacobi-BiCGStab of :func:`~na_dd_tpu_torch.ops.linsolve.bicgstab_ops`
(its matvec ``ops.matvec``, K2/K6 on the halo-padded block; no single
kernel can hold a sum across ranks), the direct solves the replicated ones,
every verdict an all-reduced sum; the fused triple solve stays local-only,
as in the JAX package, so analytic couplings solve one system at a time
there.

``precision="df"`` is the JAX package's double-float step: the state is
split into float32 pairs hi + lo (:mod:`~na_dd_tpu_torch.ops.doublefloat`)
at the step's start and reconstructed at its end, and every field
evaluation, plane assembly, rhs and corrector in between is the float64 code
above run on those pairs by :func:`~na_dd_tpu_torch.ops.df_lift.df_call_df`;
the Newton solves are the mixed refinement with double-float residuals
around the float32 kernels (K4 a pass on the fused route, K1 or K5 a pass and
solve on the per-solve route), which only ever see the plain float32 hi
planes.  ``mixed_df=True`` keeps the float64 step and computes only the
mixed refinement's residuals in double-float.

The step is dimension-agnostic: the
3-D integrators (:mod:`na_dd_tpu_torch.three_d.integrator`) override only
:meth:`PCTrapezoidalBase._newton_planes` and the ops provider of the eager
:meth:`PCTrapezoidalBase.step`.

Boundary semantics are the reference's: T's boundary is
re-zeroed by each sweep, cl and cd keep theirs, the correctors zero cp and
cs on the boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from na_dd_tpu_torch.core.state import State, heaviside_regularized
from na_dd_tpu_torch.ops import adjoint, direct_solve, kernels, linsolve
from na_dd_tpu_torch.ops import doublefloat as dfm
from na_dd_tpu_torch.ops.df_lift import df_call_df
from na_dd_tpu_torch.ops.grid import Grid
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS, Ops
from na_dd_tpu_torch.three_d import direct_solve as direct_solve3
from na_dd_tpu_torch.three_d.diffusion import Stencil7
from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3


class HCsCorrectorPositivityError(ValueError):
    """Raised when 2 - dt·Kd(Sd - cd1)(1 + cl1) loses positivity."""


#: The HCs corrector's sign threshold, 100 ulp of 1 in float64 whatever the
#: working dtype, as in the JAX package.
_ESSENTIALLY_ZERO = float(np.finfo(np.float64).eps) * 100


class StepDiagnostics(NamedTuple):
    residual_T: torch.Tensor
    residual_cl: torch.Tensor
    residual_cd: torch.Tensor
    krylov_iters: torch.Tensor  # total BiCGStab iterations in the step
    krylov_resnorm_sq: torch.Tensor  # worst linear-solve residual (2-norm²)
    krylov_converged: torch.Tensor  # False if any solve missed its tolerance
    hcs_denominator_ok: torch.Tensor  # False only for the HCs failure mode


def default_krylov_tol(dtype: torch.dtype) -> float:
    """1e-13 relative in float64 (the value the parity goldens were
    certified against), 1e-5 in float32 (an f32 solve cannot reach 1e-13)."""
    return 1e-13 if dtype == torch.float64 else 1e-5


def default_krylov_unroll() -> int | None:
    """What ``krylov_unroll="auto"`` (the default) resolves to: None, the
    while form up to ``krylov_maxiter`` iterations, as the JAX package
    resolves it on its reference platform, the CPU.  The JAX package's
    unrolled default elsewhere (48) guards against the TPU's emulated f64 in
    while-loop scalars; the card computes f64 natively, and its kernels run
    the while form with a budget of ``krylov_maxiter`` and break when done."""
    return None


#: Relative tolerance of the float32 inner solves of ``precision="mixed"``:
#: ~10·eps(f32), reachable by an f32 BiCGStab on these systems, so each
#: refinement pass contracts the f64 residual by ~1e-6 and two refinement
#: passes reach the f64 target.
MIXED_INNER_TOL = 1e-6

#: The rhs rounding-noise factor of a double-float verdict: 10 DF unit
#: roundoffs, as the float64 verdicts take 10 float64 epsilons.
_DF_EPS_B = 10.0 * 2.0 ** -48


class KrylovBackend:
    """Jacobi-BiCGStab on assembled Newton planes, ``iters`` masked
    early-exit iterations from x0 = 0, to ``tol`` (None: the dtype's
    :func:`default_krylov_tol`).

    The solve is picked by the stencil's type: :func:`kernels.bicgstab_solve`
    for a :class:`~na_dd_tpu_torch.ops.linsolve.Stencil5`,
    :func:`kernels.bicgstab_solve3` for a
    :class:`~na_dd_tpu_torch.three_d.diffusion.Stencil7`.  Each launches its
    Hopper kernel for CUDA tensors and runs its plain twin for CPU tensors;
    the diagonal of the planes (``c0``) is exact, so the Jacobi
    preconditioner is ``1/c0`` on the interior and 0 elsewhere.  On a
    sharded block (``ops.sharded``) the solve is
    :func:`~na_dd_tpu_torch.ops.linsolve.bicgstab_ops` with the same budget.
    """

    def __init__(self, *, iters: int, tol: float | None = None):
        self.iters = int(iters)
        self.tol = tol

    def tol_of(self, dtype) -> float:
        """The solves' relative tolerance in ``dtype``."""
        return default_krylov_tol(dtype) if self.tol is None else self.tol

    @staticmethod
    def _inv_diag(st, mask):
        return linsolve.jacobi_from_diag(st.c0, mask)

    @staticmethod
    def _kernels(st):
        """(solve, apply) wrappers of the stencil's dimension."""
        if isinstance(st, Stencil7):
            return kernels.bicgstab_solve3, kernels.stencil7_apply
        return kernels.bicgstab_solve, kernels.stencil5_apply

    def solve(self, st, rhs, mask, noise_sq=0.0, ops=None):
        """``st·x = rhs·mask`` on the interior of the arrays of ``ops`` (None:
        the local provider of the stencil's dimension); returns ``(x,
        info)``.  ``noise_sq`` (the rhs's squared rounding floor) is for the
        backends that judge a true residual; this one's solve judges its
        own."""
        if ops is not None and ops.sharded:
            return linsolve.bicgstab_ops(
                ops, st, rhs * mask, self._inv_diag(st, mask), mask,
                tol=self.tol_of(rhs.dtype), iters=self.iters,
            )
        bicgstab, _ = self._kernels(st)
        st, rhs, mask = _one_shape(st, rhs, mask)
        x, info = bicgstab(
            st, rhs * mask, self._inv_diag(st, mask), mask,
            tol=self.tol_of(rhs.dtype), iters=self.iters,
        )
        return x * mask, info

    def solve_triple(
        self, J_T, J_cl, J_cd, C_clT, C_cdT, d_cdcl, rhs_T, base_cl, base_cd, mask, dt,
        noise_sq=(0.0, 0.0, 0.0),
    ):
        """The whole triangular sweep's linear algebra in one call of
        :func:`kernels.triple_solve` (2-D ``Stencil5`` systems):
        ``J_T·δT = rhs_T``, ``J_cl·δcl = base_cl + dt·C_clT·δT``,
        ``J_cd·δcd = base_cd + dt·(C_cdT·δT + d_cdcl ⊙ δcl)`` on the interior.
        On a batch every operand comes to the batch's shape
        (:func:`_batch_shape`) and ``dt`` is a float or one value a system.
        Returns ``(δT, δcl, δcd, (info_T, info_cl, info_cd))``, each info as
        :meth:`solve` returns it (one entry a system on a batch), the
        residual being the recurrence one."""
        (J_T, J_cl, J_cd, C_clT, C_cdT), (d_cdcl, rhs_T, base_cl, base_cd, mask) = (
            _batch_shape((J_T, J_cl, J_cd, C_clT, C_cdT), (d_cdcl, rhs_T, base_cl, base_cd, mask))
        )
        dT, dcl, dcd, info3 = kernels.triple_solve(
            J_T, J_cl, J_cd, C_clT, C_cdT, d_cdcl, rhs_T, base_cl, base_cd,
            self._inv_diag(J_T, mask), self._inv_diag(J_cl, mask), self._inv_diag(J_cd, mask),
            mask, dt, tol=self.tol_of(rhs_T.dtype), iters=self.iters,
        )
        return dT, dcl, dcd, tuple(_triple_info(info3, k) for k in range(3))


def _df_of(dt, like):
    """``dt`` (a float, or one value a system) as a DF pair on ``like``'s
    device."""
    return dfm.df_split(torch.as_tensor(dt, dtype=torch.float64, device=like.device))


def _ndim(st) -> int:
    """Spatial dimensions of a stencil's systems: 3 for Stencil7, else 2."""
    return 3 if isinstance(st, Stencil7) else 2


def _batch_shape(stencils, planes, nd=2):
    """Stencils and planes of ``nd`` spatial dimensions at one shape, as the
    kernels take them: where they are a batch (B, ...) and an operand is one
    system's (the grid's mask, or the planes of a grid shared by the batch,
    such as η sweeps have), that operand is expanded to the batch."""
    shape = torch.broadcast_shapes(*(p.shape for st in stencils for p in st),
                                   *(p.shape for p in planes))
    if len(shape) == nd:
        return stencils, planes

    def full(t):
        return t if t.shape == shape else t.expand(shape).contiguous()

    return (tuple(type(st)(*(full(p) for p in st)) for st in stencils),
            tuple(full(p) for p in planes))


def _one_shape(st, rhs, mask):
    """The planes, rhs and mask of one solve at one shape
    (:func:`_batch_shape`)."""
    (st,), (rhs, mask) = _batch_shape((st,), (rhs, mask), _ndim(st))
    return st, rhs, mask


def _triple_info(info3, k, keys=("iters", "resnorm_sq", "converged")):
    """Solve ``k``'s entries of a triple solve's info, shaped as a solve's
    info is: from entries of shape (3,) scalars, from (B, 3) ``iters`` (B,)
    and the others (B, 1, 1)."""
    out = {}
    for key in keys:
        v = info3[key][..., k]
        out[key] = v if key == "iters" or v.dim() == 0 else v.reshape(-1, 1, 1)
    return out


def _true_verdict(r, b, iters, noise_sq, nd=2, tol=None, total=None):
    """The verdict of a solve judged by its true residual ``r = (b − A·x)·m``
    (``nd`` spatial dimensions; per system of a batch):
    ``resnorm_sq ≤ max(tol²·‖b‖², noise_sq)`` with tol (None: the dtype's
    :func:`default_krylov_tol`) and ``noise_sq`` the rhs's squared rounding
    floor.  ``total`` sums over a system (default: over the array, or each
    system of a stack; ``ops.asum`` on a sharded block)."""
    if total is None:
        total = lambda u: kernels.system_sum(u, nd)  # noqa: E731
    rsq = total(r * r)
    tol = default_krylov_tol(b.dtype) if tol is None else tol
    floor = torch.clamp_min(tol * tol * total(b * b), noise_sq)
    return {"iters": iters, "resnorm_sq": rsq, "converged": rsq <= floor}


def _ops_of(ops, st):
    """``ops``, or for None the local provider of the stencil's dimension."""
    if ops is not None:
        return ops
    return LOCAL_OPS3 if isinstance(st, Stencil7) else LOCAL_OPS


def _total(ops):
    """The per-system sum of a true-residual verdict: all-reduced on a
    sharded block, else over each system (None)."""
    return ops.asum if ops.sharded else None


def _direct_ops(st):
    """The exact solve ``(ops, st, b, mask) -> x`` of the stencil's
    dimension: block cyclic reduction over row blocks (2-D) or x-plane
    blocks (3-D); on the local ops that solve, on a sharded block the
    replicated one."""
    if isinstance(st, Stencil7):
        return direct_solve3.stencil7_solve_direct_ops
    return direct_solve.stencil5_solve_direct_ops


class DirectBackend:
    """``linear_solver="direct"``: the exact block-cyclic-reduction solve of
    :func:`na_dd_tpu_torch.ops.direct_solve.stencil5_solve_direct` (2-D) or
    :func:`na_dd_tpu_torch.three_d.direct_solve.stencil7_solve_direct`
    (3-D) (batched ``torch.linalg`` inverses and products; cuSOLVER on a
    card), with the verdict of its true residual through
    :func:`kernels.stencil5_apply` / :func:`kernels.stencil7_apply` (K2/K6 on
    CUDA tensors), as the JAX package's ``solve_direct`` gives it, to ``tol``
    (None: the dtype's default).  ``info["iters"]`` is 1.  One system: a
    batch takes the Krylov solver.  On a sharded block the solve is the
    replicated one and the verdict's apply and sums those of ``ops``."""

    def __init__(self, *, tol: float | None = None):
        self.tol = tol

    def solve(self, st, rhs, mask, noise_sq=0.0, ops=None):
        ops = _ops_of(ops, st)
        b = rhs * mask
        nd = _ndim(st)
        if b.dim() != nd:
            raise ValueError("DirectBackend: one system; a batch takes the Krylov solver")
        x = _direct_ops(st)(ops, st, b, mask)
        one = torch.ones((), dtype=torch.int32, device=b.device)
        r = (b - ops.matvec(st)(x)) * mask
        return x, _true_verdict(r, b, one, noise_sq, nd, self.tol, _total(ops))


class MixedBackend(KrylovBackend):
    """``precision="mixed"``: float64 planes and rhs, float32 Krylov.

    Classical iterative refinement: ``refine + 1`` passes of (f64 true
    residual → float32 solve by the stencil's solve kernel on the
    downcast planes, to :data:`MIXED_INNER_TOL` → f64 accumulate).  Each
    pass contracts the f64 residual by about the inner tolerance.  The f64
    residuals are applied by the 5-/7-point apply kernels (K2/K6 on CUDA
    tensors; the JAX package applies ``st.apply``, the same sum).

    ``final_check=True``: one more f64 residual ``b − A·x`` gives the
    verdict, ``resnorm_sq ≤ max(tol²·‖b‖², noise_sq)`` with tol the f64
    :func:`default_krylov_tol`.  ``False`` skips it: the solution is the
    same, and the verdict is the last inner solve's own (residual on the
    last pass's rhs).  ``info["iters"]`` sums every pass.

    ``df=True`` is the JAX package's ``mixed_df``: the refinement's true
    residuals run in double-float (:mod:`~na_dd_tpu_torch.ops.doublefloat`,
    float32 error-free arithmetic on the planes split into hi + lo) instead
    of float64, the iterate is a DF pair, and float64 touches only the
    plane splits and the final reconstruction; the inner solves and the
    verdicts are those of ``df=False``.  :meth:`solve_df` and
    :meth:`solve_triple_df` are the same refinements on planes and rhs that
    are already DF pairs (``precision="df"``).
    """

    def __init__(self, *, iters: int, refine: int = 2, final_check: bool = True,
                 tol: float | None = None, df: bool = False):
        super().__init__(iters=iters, tol=tol)
        self.refine = int(refine)
        self.final_check = bool(final_check)
        self.df = bool(df)

    @staticmethod
    def _f32(st):
        return type(st)(*(p.to(torch.float32) for p in st))

    def _inner(self, st32, r32, inv32, mask32, ops):
        """One float32 inner solve: the stencil's solve kernel, or on a
        sharded block the all-reduced BiCGStab."""
        if ops.sharded:
            return linsolve.bicgstab_ops(ops, st32, r32, inv32, mask32, tol=MIXED_INNER_TOL,
                                         iters=self.iters)
        bicgstab = self._kernels(st32)[0]
        return bicgstab(st32, r32, inv32, mask32, tol=MIXED_INNER_TOL, iters=self.iters)

    def _refine_df(self, st32, st_lo, b_df, inv32, mask32, ops):
        """``refine + 1`` passes of (DF true residual → float32 inner solve →
        DF accumulate) from x = 0; returns (x as DF, summed iterations, the
        last inner solve's info)."""
        x = dfm.df_zeros_like(b_df.hi)
        for k in range(self.refine + 1):
            if k == 0:
                r32 = b_df.hi
            else:
                r32 = dfm.df_sub(b_df, dfm.df_stencil_apply(st32, st_lo, ops, x)).hi * mask32
            e32, info = self._inner(st32, r32, inv32, mask32, ops)
            x = dfm.df_add_f32(x, e32 * mask32)
            iters = info["iters"] if k == 0 else iters + info["iters"]
        return x, iters, info

    def solve(self, st, rhs, mask, noise_sq=0.0, ops=None):
        ops = _ops_of(ops, st)
        if not ops.sharded:
            st, rhs, mask = _one_shape(st, rhs, mask)
        f32 = torch.float32
        st32 = self._f32(st)
        # the f64 inverse diagonal, downcast (not the inverse of the f32 planes)
        inv32 = self._inv_diag(st, mask).to(f32)
        mask32 = mask.to(f32)
        apply, total = ops.matvec(st), _total(ops)
        b = rhs * mask
        if self.df:
            st_lo = dfm.df_split_stencil(st, st32)[1]
            x_df, iters, info = self._refine_df(st32, st_lo, dfm.df_split(b), inv32, mask32, ops)
            x = dfm.df_to(x_df, b.dtype) * mask
        else:
            x = torch.zeros_like(b)
            for k in range(self.refine + 1):
                r = b if k == 0 else (b - apply(x)) * mask
                e32, info = self._inner(st32, r.to(f32), inv32, mask32, ops)
                x = x + e32.to(b.dtype) * mask
                iters = info["iters"] if k == 0 else iters + info["iters"]
        if not self.final_check:
            return x, {
                "iters": iters,
                "resnorm_sq": info["resnorm_sq"].to(b.dtype),
                "converged": info["converged"],
            }
        return x, _true_verdict((b - apply(x)) * mask, b, iters, noise_sq, _ndim(st), self.tol,
                                total)

    def solve_triple(
        self, J_T, J_cl, J_cd, C_clT, C_cdT, d_cdcl, rhs_T, base_cl, base_cd, mask, dt,
        noise_sq=(0.0, 0.0, 0.0),
    ):
        """Block-triangular refinement around the float32 triple solve: the
        sweep is the lower-triangular block system M z = w,

            M = [[J_T, 0, 0], [-dt C_clT, J_cl, 0], [-dt C_cdT, -dt diag(d_cdcl), J_cd]],
            w = (rhs_T, base_cl, base_cd)·mask,

        which one :func:`kernels.triple_solve` on a residual solves in that
        form, so ``z ← z + triple(w − M z)`` refines all three rows at once,
        one launch a pass (for a whole batch: each system's residual, verdict
        and noise floor its own).  The inverse diagonals are those of the
        float32 planes.  Verdicts per row as :meth:`solve` gives them, each
        row's rhs being ``w`` plus its coupling to the rows above."""
        (J_T, J_cl, J_cd, C_clT, C_cdT), (d_cdcl, rhs_T, base_cl, base_cd, mask) = (
            _batch_shape((J_T, J_cl, J_cd, C_clT, C_cdT), (d_cdcl, rhs_T, base_cl, base_cd, mask))
        )
        apply = kernels.stencil5_apply
        f32 = torch.float32
        J_T32, J_cl32, J_cd32 = self._f32(J_T), self._f32(J_cl), self._f32(J_cd)
        C_clT32, C_cdT32 = self._f32(C_clT), self._f32(C_cdT)
        d32 = d_cdcl.to(f32)
        m32 = mask.to(f32)
        inv_T32, inv_cl32, inv_cd32 = (
            self._inv_diag(J_T32, mask), self._inv_diag(J_cl32, mask), self._inv_diag(J_cd32, mask)
        )
        wT, wcl, wcd = rhs_T * mask, base_cl * mask, base_cd * mask
        planes32 = (J_T32, J_cl32, J_cd32, C_clT32, C_cdT32)
        if self.df:
            lo = tuple(dfm.df_split_stencil(st, st32)[1]
                       for st, st32 in zip((J_T, J_cl, J_cd, C_clT, C_cdT), planes32))
            z_df, iters3, info3 = self._refine_triple_df(
                planes32, lo, dfm.df_split_with_hi(d_cdcl, d32), _df_of(dt, wT),
                tuple(dfm.df_split(w) for w in (wT, wcl, wcd)),
                (inv_T32, inv_cl32, inv_cd32), m32, dt,
            )
            zT, zcl, zcd = (dfm.df_to(z, wT.dtype) * mask for z in z_df)
        else:
            zT, zcl, zcd = torch.zeros_like(wT), torch.zeros_like(wcl), torch.zeros_like(wcd)
            for k in range(self.refine + 1):
                if k == 0:
                    rT, rcl, rcd = wT, wcl, wcd
                else:
                    rT = wT - apply(J_T, zT)
                    rcl = wcl + dt * apply(C_clT, zT) - apply(J_cl, zcl)
                    rcd = wcd + dt * (apply(C_cdT, zT) + d_cdcl * zcl) - apply(J_cd, zcd)
                eT, ecl, ecd, info3 = kernels.triple_solve(
                    *planes32, d32,
                    (rT * mask).to(f32), (rcl * mask).to(f32), (rcd * mask).to(f32),
                    inv_T32, inv_cl32, inv_cd32, m32, dt, tol=MIXED_INNER_TOL, iters=self.iters,
                )
                zT = zT + eT.to(wT.dtype) * mask
                zcl = zcl + ecl.to(wT.dtype) * mask
                zcd = zcd + ecd.to(wT.dtype) * mask
                iters3 = info3["iters"] if k == 0 else iters3 + info3["iters"]
        if self.final_check:
            bcl = wcl + dt * apply(C_clT, zT)
            bcd = wcd + dt * (apply(C_cdT, zT) + d_cdcl * zcl)
            infos = tuple(
                _true_verdict((b - apply(J, z)) * mask, b, iters3[..., k], noise_sq[k],
                              tol=self.tol)
                for k, (J, z, b) in enumerate(((J_T, zT, wT), (J_cl, zcl, bcl), (J_cd, zcd, bcd)))
            )
        else:
            info3 = dict(info3, iters=iters3, resnorm_sq=info3["resnorm_sq"].to(wT.dtype))
            infos = tuple(_triple_info(info3, k) for k in range(3))
        return zT, zcl, zcd, infos

    def _refine_triple_df(self, planes32, planes_lo, d_df, dt_df, w_df, invs, m32, dt):
        """The block refinement of :meth:`solve_triple` with DF residuals:
        ``z ← z + triple(w − M z)``, the block residual ``w − M z`` in
        double-float on the split planes, one float32 triple solve a pass.
        Returns ((zT, zcl, zcd) as DF, summed (…, 3) iterations, the last
        pass's info)."""
        J_T32, J_cl32, J_cd32, C_clT32, C_cdT32 = planes32
        J_Tlo, J_cllo, J_cdlo, C_clTlo, C_cdTlo = planes_lo
        wT, wcl, wcd = w_df
        apply = lambda st32, st_lo, z: dfm.df_stencil_apply(st32, st_lo, LOCAL_OPS, z)  # noqa: E731
        zT, zcl, zcd = (dfm.df_zeros_like(w.hi) for w in w_df)
        for k in range(self.refine + 1):
            if k == 0:
                rT, rcl, rcd = wT.hi, wcl.hi, wcd.hi
            else:
                rT = dfm.df_sub(wT, apply(J_T32, J_Tlo, zT)).hi * m32
                c_cl = apply(C_clT32, C_clTlo, zT)
                rcl = dfm.df_sub(dfm.df_add(wcl, dfm.df_mul(dt_df, c_cl)),
                                 apply(J_cl32, J_cllo, zcl)).hi * m32
                c_cd = dfm.df_add(apply(C_cdT32, C_cdTlo, zT), dfm.df_mul(d_df, zcl))
                rcd = dfm.df_sub(dfm.df_add(wcd, dfm.df_mul(dt_df, c_cd)),
                                 apply(J_cd32, J_cdlo, zcd)).hi * m32
            eT, ecl, ecd, info3 = kernels.triple_solve(
                *planes32, d_df.hi, rT, rcl, rcd, *invs, m32, dt,
                tol=MIXED_INNER_TOL, iters=self.iters,
            )
            zT = dfm.df_add_f32(zT, eT * m32)
            zcl = dfm.df_add_f32(zcl, ecl * m32)
            zcd = dfm.df_add_f32(zcd, ecd * m32)
            iters3 = info3["iters"] if k == 0 else iters3 + info3["iters"]
        return (zT, zcl, zcd), iters3, info3

    def _df_verdict(self, r_df, b_df, m32, iters, nd, total, noise_sq=0.0):
        """The float64 verdict of a double-float solve from its DF residual
        ``r`` and rhs ``b`` (reconstructed only for the sums), the rhs noise
        floor at the DF unit roundoff: of ``b`` itself, or ``noise_sq`` (the
        floor of the Newton rhs it cancelled from) where that is larger."""
        f64 = torch.float64
        r = dfm.df_to(dfm.df_mask(r_df, m32), f64)
        b = dfm.df_to(b_df, f64)
        total = total or (lambda u: kernels.system_sum(u, nd))
        noise = torch.clamp_min(_DF_EPS_B * _DF_EPS_B * total(b * b), noise_sq)
        return _true_verdict(r, b, iters, noise, nd, self.tol, total)

    def solve_df(self, st_df, b_df, mask, ops=None, noise_sq=0.0):
        """``precision="df"``: the refinement of :meth:`solve` on planes and
        rhs that are DF pairs (a stencil of :class:`~na_dd_tpu_torch.ops.
        doublefloat.DF` planes), from x = 0, the float32 inner solve on the
        hi planes; returns (x as DF, info).  The verdict: with
        ``final_check`` the float64 one of the DF true residual (rhs noise
        floor at the DF unit roundoff, at least ``noise_sq``), else the last
        inner solve's."""
        ops = _ops_of(ops, st_df)
        st32 = type(st_df)(*(p.hi for p in st_df))
        st_lo = type(st_df)(*(p.lo for p in st_df))
        m32 = mask.to(torch.float32)
        if not ops.sharded:
            (st32, st_lo), (b_hi, b_lo, m32) = _batch_shape(
                (st32, st_lo), (b_df.hi, b_df.lo, m32), _ndim(st32)
            )
            b_df = dfm.DF(b_hi, b_lo)
        inv32 = linsolve.jacobi_from_diag(st32.c0, m32)
        b_df = dfm.df_mask(b_df, m32)
        x, iters, info = self._refine_df(st32, st_lo, b_df, inv32, m32, ops)
        if self.final_check:
            r_df = dfm.df_sub(b_df, dfm.df_stencil_apply(st32, st_lo, ops, x))
            return x, self._df_verdict(r_df, b_df, m32, iters, _ndim(st32), _total(ops),
                                       noise_sq)
        return x, {
            "iters": iters,
            "resnorm_sq": info["resnorm_sq"].to(torch.float64),
            "converged": info["converged"],
        }

    def solve_triple_df(self, J_T, J_cl, J_cd, C_clT, C_cdT, d_cdcl, wT, wcl, wcd, mask, dt,
                        noise_sq=(0.0, 0.0, 0.0)):
        """``precision="df"``: the block refinement of :meth:`solve_triple`
        on DF planes and DF rhs ``w`` (already masked), one float32 triple
        solve a pass on the hi planes; returns (zT, zcl, zcd as DF, infos),
        the verdicts as :meth:`solve_df` gives them, each row's rhs being
        ``w`` plus its DF coupling to the rows above."""
        stencils = (J_T, J_cl, J_cd, C_clT, C_cdT)
        m32 = mask.to(torch.float32)
        hi_lo = [type(st)(*(p.hi for p in st)) for st in stencils] + [
            type(st)(*(p.lo for p in st)) for st in stencils]
        hi_lo, planes = _batch_shape(
            hi_lo, (d_cdcl.hi, d_cdcl.lo, *(v for w in (wT, wcl, wcd) for v in w), m32)
        )
        planes32, planes_lo = tuple(hi_lo[:5]), tuple(hi_lo[5:])
        d_df = dfm.DF(*planes[:2])
        w_df = tuple(dfm.DF(planes[2 + 2 * k], planes[3 + 2 * k]) for k in range(3))
        m32 = planes[-1]
        invs = tuple(linsolve.jacobi_from_diag(st.c0, m32) for st in planes32[:3])
        dt_df = _df_of(dt, m32)
        z, iters3, info3 = self._refine_triple_df(planes32, planes_lo, d_df, dt_df, w_df, invs,
                                                  m32, dt)
        if not self.final_check:
            info3 = dict(info3, iters=iters3, resnorm_sq=info3["resnorm_sq"].to(torch.float64))
            return (*z, tuple(_triple_info(info3, k) for k in range(3)))
        zT, zcl = z[0], z[1]
        apply = lambda k, zz: dfm.df_stencil_apply(planes32[k], planes_lo[k], LOCAL_OPS, zz)  # noqa: E731
        b_cl = dfm.df_add(w_df[1], dfm.df_mul(dt_df, apply(3, zT)))
        b_cd = dfm.df_add(w_df[2], dfm.df_mul(
            dt_df, dfm.df_add(apply(4, zT), dfm.df_mul(d_df, zcl))))
        infos = tuple(
            self._df_verdict(dfm.df_sub(b, apply(k, z[k])), b, m32, iters3[..., k], 2, None,
                             noise_sq[k])
            for k, b in enumerate((w_df[0], b_cl, b_cd))
        )
        return (*z, infos)



class DirectMixedBackend(MixedBackend):
    """``precision="mixed"`` with ``linear_solver="direct"``: the refinement
    of :class:`MixedBackend` around the float32 block cyclic reduction of
    the stencil's dimension, which contracts the residual by about float32's
    epsilon a pass with no iteration budget; its own verdict is "converged"
    with 1 iteration, as in the JAX package."""

    def _inner(self, st32, r32, inv32, mask32, ops):
        x32 = _direct_ops(st32)(ops, st32, r32, mask32)
        return x32, {
            "iters": torch.ones((), dtype=torch.int32, device=r32.device),
            "resnorm_sq": torch.zeros((), dtype=r32.dtype, device=r32.device),
            "converged": torch.ones((), dtype=torch.bool, device=r32.device),
        }

class PCTrapezoidalBase:
    """Shared PC machinery; subclasses provide the cs predictor/corrector."""

    #: ops provider of the eager :meth:`step`; the 3-D integrators override it
    _local_ops: Ops = LOCAL_OPS

    def __init__(
        self,
        semi_discrete_field,
        *,
        num_pc_steps: int = 1,
        num_newton_steps: int = 1,
        krylov_tol: float | None = None,
        krylov_maxiter: int = 300,
        krylov_unroll: int | None | str = "auto",
        assemble_stencil: bool = True,
        stencil_source: str = "analytic",
        track_residuals: bool = True,
        coupling_source: str = "jvp",
        fused_triple: bool = True,
        precision: str = "full",
        mixed_refine: int = 2,
        mixed_final_check: bool = True,
        mixed_df: bool = False,
        linear_solver: str = "krylov",
        differentiable: bool = False,
    ):
        """krylov_unroll: BiCGStab iteration budget per solve (masked early
        exit, so any sufficient budget gives the same answer).  None is the
        JAX package's while form: up to ``krylov_maxiter`` iterations with a
        true early exit; the kernels make the unrolled form's update, so on
        assembled planes they run with that budget and break when done.
        "auto" (the default) is :func:`default_krylov_unroll`: None.
        krylov_tol: the solves' relative tolerance (None: 1e-13 in float64,
        1e-5 in float32, :func:`default_krylov_tol`).  The assembled solves
        go through ``self.solver``, an object with ``solve(stencil, rhs,
        mask, noise_sq) -> (x, info)`` and ``solve_triple(...)``: the
        :class:`KrylovBackend` or, with ``precision="mixed"``, the
        :class:`MixedBackend`.

        assemble_stencil / stencil_source: with ``assemble_stencil`` the
        Newton operator's planes are made once a solve, in closed form
        (``stencil_source="analytic"``) or by colour probes of the
        linearized field graph (``"probe"``, which also takes the cross
        couplings from that graph, never the fused sweep); without it the
        solve is matrix-free: BiCGStab on the linearized graph, whose
        Jacobi diagonal comes from two probes, in plain PyTorch (no kernel
        solves a graph).  Mixed precision and the direct solver need
        assembled planes.

        coupling_source: "jvp" — the cross couplings as ``torch.func.jvp``
        tangents; "analytic" — as closed-form coupling planes
        (``field.stencil_dFcl_dT`` etc.).  fused_triple: with analytic
        couplings in 2-D and an int ``krylov_unroll``, the whole sweep
        through ``solver.solve_triple``, on one system or a batch.

        precision: "full" — the solves in the grid's dtype
        (:class:`KrylovBackend`); "mixed" — float32 Krylov under float64
        iterative refinement (:class:`MixedBackend`, a float64 grid
        required), ``mixed_refine`` refinement passes after the first and,
        with ``mixed_final_check``, one more f64 residual for an honest
        per-solve verdict.  With fused analytic couplings the refinement is
        the block-triangular one around the float32 triple solve.
        ``mixed_df``: the refinement's residuals in double-float
        (:class:`MixedBackend` ``df``).  "df" — the double-float step
        (:meth:`_step_fn_df`): the state carried as DF pairs inside the
        step and float64 at its boundary, every field evaluation, plane
        assembly, rhs and corrector run on them by
        :func:`~na_dd_tpu_torch.ops.df_lift.df_call_df`, the Newton solves
        the refinement with DF residuals around the float32 kernels (K4 on
        the fused route, K1/K5 on the per-solve route), with the mixed
        mode's ``mixed_refine`` and ``mixed_final_check``; it needs a
        float64 grid, ``assemble_stencil=True`` and
        ``stencil_source="analytic"``, always takes the analytic
        couplings, refuses ``differentiable=True`` (the lift has no
        adjoint) and a sharded ops provider.

        linear_solver: "krylov" (the BiCGStab kernels) or "direct" (exact
        block cyclic reduction, :class:`DirectBackend`; in ``precision=
        "mixed"`` the float32 BCR inner solve, :class:`DirectMixedBackend`).  The direct route takes the
        per-solve sweep (the fused triple solve is Krylov's).

        differentiable: IFT adjoints on every Newton solve
        (:func:`na_dd_tpu_torch.ops.adjoint.plane_solve`): the forward is
        bit for bit the default path's, and under ``torch.autograd`` each
        cotangent solves the transposed system with the same backend.  With
        analytic couplings the sweep then takes the per-solve route.  As in
        the JAX package the transposed solves' diagnostics are discarded: a
        budget that converges the forward solves (``krylov_converged``) is
        the guard."""
        if isinstance(krylov_unroll, str):
            if krylov_unroll != "auto":
                raise ValueError(
                    f"krylov_unroll must be an int, None or 'auto'; got {krylov_unroll!r}"
                )
            krylov_unroll = default_krylov_unroll()
        if stencil_source not in ("analytic", "probe"):
            raise ValueError(
                f"stencil_source must be 'analytic' or 'probe'; got {stencil_source!r}"
            )
        if precision == "mixed" and not assemble_stencil:
            raise ValueError("precision='mixed' requires assemble_stencil=True")
        if linear_solver == "direct" and not assemble_stencil:
            raise ValueError("linear_solver='direct' requires assemble_stencil=True")
        if coupling_source not in ("jvp", "analytic"):
            raise ValueError(
                f"coupling_source must be 'jvp' or 'analytic', got {coupling_source!r}"
            )
        if precision not in ("full", "mixed", "df"):
            raise ValueError(f"precision must be 'full', 'mixed' or 'df'; got {precision!r}")
        if precision == "df":
            if not assemble_stencil or stencil_source != "analytic":
                raise ValueError(
                    "precision='df' requires assemble_stencil=True and stencil_source='analytic'"
                )
            if differentiable:
                raise ValueError(
                    "precision='df' does not support differentiable=True (the double-float "
                    "lift defines no adjoint); use precision='mixed' for adjoint runs"
                )
        if precision == "mixed" and semi_discrete_field.grid.dtype != torch.float64:
            raise ValueError(
                "precision='mixed' requires a float64 grid (the refinement residuals are f64)"
            )
        if precision == "df" and semi_discrete_field.grid.dtype != torch.float64:
            raise ValueError(
                "precision='df' requires a float64 grid (the DF pairs are split from and "
                "reconstructed to float64 at the step boundary)"
            )
        if int(mixed_refine) < 0:
            raise ValueError(f"mixed_refine must be >= 0; got {mixed_refine!r}")
        if linear_solver not in ("krylov", "direct"):
            raise ValueError(
                f"linear_solver must be 'krylov' or 'direct'; got {linear_solver!r}"
            )
        self.linear_solver = linear_solver
        self.differentiable = bool(differentiable)
        self.krylov_tol = None if krylov_tol is None else float(krylov_tol)
        self.krylov_maxiter = int(krylov_maxiter)
        self.krylov_unroll = None if krylov_unroll is None else int(krylov_unroll)
        self.assemble_stencil = bool(assemble_stencil)
        self.stencil_source = stencil_source
        self.precision = precision
        self.mixed_refine = int(mixed_refine)
        self.mixed_final_check = bool(mixed_final_check)
        self.mixed_df = bool(mixed_df)
        self.coupling_source = coupling_source
        self.fused_triple = bool(fused_triple)
        self.semi_discrete_field = semi_discrete_field
        self._model = semi_discrete_field.model
        self.num_pc_steps = int(num_pc_steps)
        self.num_newton_steps = int(num_newton_steps)
        self.track_residuals = bool(track_residuals)
        # the kernels' budget: the unrolled count, or the while form's cap
        budget = self.krylov_maxiter if self.krylov_unroll is None else self.krylov_unroll
        if precision in ("mixed", "df"):
            backend = DirectMixedBackend if linear_solver == "direct" else MixedBackend
            self.solver = backend(
                iters=budget, refine=mixed_refine, final_check=mixed_final_check,
                tol=self.krylov_tol, df=self.mixed_df,
            )
        elif linear_solver == "direct":
            self.solver = DirectBackend(tol=self.krylov_tol)
        else:
            self.solver = KrylovBackend(iters=budget, tol=self.krylov_tol)
        # filled by the eager step()
        self.last_residual = {}

    # cp predictor / corrector
    def initial_cp_pred(self, g: Grid, ops: Ops, at_t: State, t, *, dt):
        Fcp = self.semi_discrete_field.Fcp
        Fcp0 = Fcp(g, ops, at_t, t)
        s_star = at_t._replace(cp=at_t.cp + dt * Fcp0)
        Fcp_star = Fcp(g, ops, s_star, t + dt)
        return at_t.cp + 0.5 * dt * (Fcp0 + Fcp_star)

    def corrector_cp_step(self, g: Grid, ops: Ops, T1, cl1, _cd1, *, at_t0: State, t0, dt):
        m = self._model
        fcp = self.semi_discrete_field.forcing.fcp
        t1 = t0 + dt
        src0 = fcp(g, ops, t0)
        src1 = fcp(g, ops, t1)
        alpha0 = -m.K2 * at_t0.T - m.K1 * (at_t0.cl + 1.0)
        alpha1 = -m.K2 * T1 - m.K1 * (cl1 + 1.0)
        num = (1.0 + 0.5 * dt * alpha0) * at_t0.cp + 0.5 * dt * (src0 + src1)
        den = 1.0 - 0.5 * dt * alpha1
        return g.interior_mask * num / den

    def _heun_cs(self, g: Grid, ops: Ops, at_t: State, t, *, dt):
        Fcs = self.semi_discrete_field.Fcs
        Fcs0 = Fcs(g, ops, at_t, t)
        s_star = at_t._replace(cs=at_t.cs + dt * Fcs0)
        Fcs_star = Fcs(g, ops, s_star, t + dt)
        return at_t.cs + 0.5 * dt * (Fcs0 + Fcs_star)

    def initial_cs_pred(self, g, ops, at_t, t, *, dt):  # pragma: no cover - abstract
        raise NotImplementedError

    def corrector_cs_step(self, g, ops, T1, cl1, cd1, *, at_t0, t0, dt):  # pragma: no cover
        raise NotImplementedError

    def _newton_planes(self, g, ops, L, dt):
        """Planes of the interior Newton operator 2·I − dt·L for a
        self-Jacobian stencil ``L``: a dimension-specific hook of the step
        (the 3-D integrators build Stencil7 planes)."""
        return linsolve.newton_planes(g, ops, L, dt)

    def _probe_stencil(self, matvec, g):
        """Planes of a linear map by colour probing: the other
        dimension-specific hook (5 colours in 2-D, 7 in 3-D)."""
        return linsolve.probe_stencil(matvec, g)

    def _solve_graph(self, g, ops, matvec, rhs, noise_sq):
        """One Newton solve of the masked operator ``matvec`` (the
        linearized field graph): on probed planes through the backend, or
        matrix-free (``assemble_stencil=False``): Jacobi-BiCGStab on the
        graph, unrolled or, with ``krylov_unroll=None``, the while form.
        Under ``differentiable`` the matrix-free forward is wrapped by the
        plane adjoint, whose transposed solve runs on the probed planes."""
        mask = g.interior_mask
        if self.assemble_stencil:
            return self._solve(ops, self._probe_stencil(matvec, g), rhs, mask, noise_sq)
        red, black = linsolve.checkerboard_masks(g)
        inv_diag = linsolve.jacobi_from_diag(
            linsolve.probe_diag(matvec, red * mask, black * mask), mask
        )
        kwargs = dict(
            dot=lambda u, v: ops.asum(u * v), minv=lambda r: r * inv_diag,
            tol=self.solver.tol_of(rhs.dtype),
        )

        def run(b):
            zero = torch.zeros_like(b)
            if self.krylov_unroll is None:
                return linsolve.bicgstab(matvec, b, zero, maxiter=self.krylov_maxiter, **kwargs)
            return linsolve.bicgstab_unrolled(matvec, b, zero, iters=self.krylov_unroll, **kwargs)

        b = rhs * mask
        if not self.differentiable:
            x, info = run(b)
            return x * mask, info
        x, info = adjoint.plane_solve(
            lambda _st, bb: run(bb), self._probe_stencil(matvec, g), b, mask,
            transpose_solver=self._backend_solve(ops, mask, noise_sq), ops=ops,
        )
        return x * mask, info

    def _backend_solve(self, ops, mask, noise_sq):
        """``(stencil, rhs) -> (x, info)`` through the backend on the arrays
        of ``ops``."""
        return lambda st, b: self.solver.solve(st, b, mask, noise_sq, ops)

    def _solve(self, ops, st, rhs, mask, noise_sq):
        """One Newton solve through the backend; with ``differentiable`` its
        IFT adjoint wraps it (the backend also solves the transposed
        system)."""
        solve = self._backend_solve(ops, mask, noise_sq)
        if not self.differentiable:
            return solve(st, rhs)
        x, info = adjoint.plane_solve(solve, st, rhs * mask, mask, ops=ops)
        return x * mask, info

    def _noise_floors(self, ops, s, Y):
        """The squared rounding floors of the three Newton rhs (each a
        cancellation of O(‖Y‖) values), which a true-residual verdict
        (mixed refinement, direct) cannot beat; 0 for the Krylov kernels,
        whose verdict is their own."""
        if self.precision == "mixed" or self.linear_solver == "direct":
            eps_b = 10.0 * float(torch.finfo(s.T.dtype).eps)
            return tuple(eps_b * eps_b * ops.asum(Yv * Yv) for Yv in Y)
        return (0.0, 0.0, 0.0)

    # Newton sweep over the triangular (T, cl, cd) block
    def _newton_sweep(self, g, ops, s: State, t1, dt, Y):
        """One Gauss–Seidel Newton sweep linearized at ``s``."""
        field = self.semi_discrete_field
        YT0, Ycl0, Ycd0 = Y
        mask = g.interior_mask
        solve = self._solve
        if not (self.assemble_stencil and self.stencil_source == "analytic"):
            return self._newton_sweep_graph(g, ops, s, t1, dt, Y)
        analytic = self.coupling_source == "analytic"
        noise = self._noise_floors(ops, s, Y)

        # T: FT is linear in T — closed-form planes and a direct primal
        fT0 = field.FT(g, ops, s, t1)
        J_T = self._newton_planes(g, ops, field.stencil_dFT_dT(g, ops, s), dt)
        rhs_T = YT0 - (2.0 * s.T - dt * fT0)

        if (
            analytic
            and self.fused_triple
            and self.linear_solver == "krylov"
            and not self.differentiable
            and isinstance(J_T, linsolve.Stencil5)
            and self.krylov_unroll is not None
            and not ops.sharded
        ):
            # the whole sweep's linear algebra in one call
            fcl0 = field.Fcl(g, ops, s, t1)
            fcd0 = field.Fcd(g, ops, s, t1)
            J_cl = self._newton_planes(g, ops, field.stencil_dFcl_dcl(g, ops, s), dt)
            J_cd = self._newton_planes(g, ops, field.stencil_dFcd_dcd(g, ops, s), dt)
            dT, dcl, dcd, infos = self.solver.solve_triple(
                J_T, J_cl, J_cd,
                field.stencil_dFcl_dT(g, ops, s),
                field.stencil_dFcd_dT(g, ops, s),
                field.diag_dFcd_dcl(g, s),
                rhs_T,
                Ycl0 - 2.0 * s.cl + dt * fcl0,
                Ycd0 - 2.0 * s.cd + dt * fcd0,
                mask, dt, noise,
            )
            T1 = s.T * mask + dT  # boundary re-zeroed, as in the reference
            cl1 = s.cl + dcl  # boundary kept
            cd1 = s.cd + dcd
            return self._sweep_tail(g, ops, s, t1, dt, Y, T1, cl1, cd1, *infos)

        dT, info_T = solve(ops, J_T, rhs_T, mask, noise[0])
        T1 = s.T * mask + dT  # boundary re-zeroed, as in the reference

        # cl: the primal and the T-coupling, a closed-form plane apply or
        # the tangent of one jvp pass
        wT = (T1 - s.T) * mask
        if analytic:
            fcl0 = field.Fcl(g, ops, s, t1)
            jvp_cl_T = field.stencil_dFcl_dT(g, ops, s).apply(ops, wT)
        else:
            fcl0, jvp_cl_T = torch.func.jvp(
                lambda T: field.Fcl(g, ops, s._replace(T=T), t1), (s.T,), (wT,)
            )
        J_cl = self._newton_planes(g, ops, field.stencil_dFcl_dcl(g, ops, s), dt)
        rhs_cl = Ycl0 - 2.0 * s.cl + dt * fcl0 + dt * jvp_cl_T
        dcl, info_cl = solve(ops, J_cl, rhs_cl, mask, noise[1])
        cl1 = s.cl + dcl  # boundary kept, as in the reference

        # cd: the primal and the (T, cl)-coupling, likewise
        wcl = (cl1 - s.cl) * mask
        if analytic:
            fcd0 = field.Fcd(g, ops, s, t1)
            jvp_cd_Tcl = (
                field.stencil_dFcd_dT(g, ops, s).apply(ops, wT)
                + field.diag_dFcd_dcl(g, s) * wcl
            )
        else:
            fcd0, jvp_cd_Tcl = torch.func.jvp(
                lambda T, cl: field.Fcd(g, ops, s._replace(T=T, cl=cl), t1),
                (s.T, s.cl),
                (wT, wcl),
            )
        J_cd = self._newton_planes(g, ops, field.stencil_dFcd_dcd(g, ops, s), dt)
        rhs_cd = Ycd0 - 2.0 * s.cd + dt * fcd0 + dt * jvp_cd_Tcl
        dcd, info_cd = solve(ops, J_cd, rhs_cd, mask, noise[2])
        cd1 = s.cd + dcd

        return self._sweep_tail(
            g, ops, s, t1, dt, Y, T1, cl1, cd1, info_T, info_cl, info_cd
        )

    def _newton_sweep_graph(self, g, ops, s: State, t1, dt, Y):
        """The sweep of ``stencil_source="probe"`` and of the matrix-free
        route: each Newton operator is the linearized field graph
        ``w ↦ m·(2 w·m − dt·J (w·m))``, the couplings its tangents."""
        field = self.semi_discrete_field
        YT0, Ycl0, Ycd0 = Y
        mask = g.interior_mask
        noise = self._noise_floors(ops, s, Y)

        def newton_matvec(lin, zeros):
            return lambda w: (2.0 * (w * mask) - dt * lin(*zeros, w * mask)) * mask

        fT0, linT = linsolve.linearized(lambda T: field.FT(g, ops, s._replace(T=T), t1), s.T)
        rhs_T = YT0 - (2.0 * s.T - dt * fT0)
        dT, info_T = self._solve_graph(g, ops, newton_matvec(linT, ()), rhs_T, noise[0])
        T1 = s.T * mask + dT  # boundary re-zeroed, as in the reference

        wT = (T1 - s.T) * mask
        zero = torch.zeros_like(s.T)
        fcl0, lincl = linsolve.linearized(
            lambda T, cl: field.Fcl(g, ops, s._replace(T=T, cl=cl), t1), s.T, s.cl
        )
        rhs_cl = Ycl0 - 2.0 * s.cl + dt * fcl0 + dt * lincl(wT, zero)
        dcl, info_cl = self._solve_graph(g, ops, newton_matvec(lincl, (zero,)), rhs_cl, noise[1])
        cl1 = s.cl + dcl  # boundary kept, as in the reference

        wcl = (cl1 - s.cl) * mask
        fcd0, lincd = linsolve.linearized(
            lambda T, cl, cd: field.Fcd(g, ops, s._replace(T=T, cl=cl, cd=cd), t1),
            s.T, s.cl, s.cd,
        )
        rhs_cd = Ycd0 - 2.0 * s.cd + dt * fcd0 + dt * lincd(wT, wcl, zero)
        dcd, info_cd = self._solve_graph(
            g, ops, newton_matvec(lincd, (zero, zero)), rhs_cd, noise[2]
        )
        cd1 = s.cd + dcd
        return self._sweep_tail(
            g, ops, s, t1, dt, Y, T1, cl1, cd1, info_T, info_cl, info_cd
        )

    def _sweep_tail(self, g, ops, s, t1, dt, Y, T1, cl1, cd1, info_T, info_cl, info_cd):
        """Residual tracking and diagnostics packaging, shared by the
        per-solve and fused sweep routes."""
        field = self.semi_discrete_field
        YT0, Ycl0, Ycd0 = Y
        if self.track_residuals:
            res_T = 2.0 * T1 - dt * field.FT(g, ops, s._replace(T=T1), t1) - YT0
            s_cl = s._replace(T=T1, cl=cl1)
            res_cl = 2.0 * cl1 - dt * field.Fcl(g, ops, s_cl, t1) - Ycl0
            s_cd = s._replace(T=T1, cl=cl1, cd=cd1)
            res_cd = 2.0 * cd1 - dt * field.Fcd(g, ops, s_cd, t1) - Ycd0
        else:
            res_T = res_cl = res_cd = torch.zeros_like(s.T)

        resnorm = torch.maximum(
            torch.maximum(info_T["resnorm_sq"], info_cl["resnorm_sq"]),
            info_cd["resnorm_sq"],
        )
        iters = info_T["iters"] + info_cl["iters"] + info_cd["iters"]
        converged = info_T["converged"] & info_cl["converged"] & info_cd["converged"]
        return T1, cl1, cd1, (res_T, res_cl, res_cd), iters, resnorm, converged

    # precision="df": the double-float step
    def _newton_sweep_df(self, g, ops, s: State, t1, dt, Y):
        """The DF twin of :meth:`_newton_sweep` (analytic sources only): one
        lifted evaluation gives the three rhs, the three Newton planes, both
        coupling planes and the cl→cd diagonal as DF pairs, then the
        triangular solves run the refinement with DF residuals: on the
        fused route (2-D, ``fused_triple``, an int budget, the Krylov
        solver, local ops) one float32 triple solve a pass, else one
        refinement a system with the couplings applied in DF between them.
        ``s`` and ``Y`` are DF; returns DF iterates."""
        field = self.semi_discrete_field
        mask = g.interior_mask
        mask32 = mask.to(torch.float32)

        def sources(s_, t1_, dt_, YT_, Ycl_, Ycd_):
            fT0 = field.FT(g, ops, s_, t1_)
            fcl0 = field.Fcl(g, ops, s_, t1_)
            fcd0 = field.Fcd(g, ops, s_, t1_)
            J_T = self._newton_planes(g, ops, field.stencil_dFT_dT(g, ops, s_), dt_)
            J_cl = self._newton_planes(g, ops, field.stencil_dFcl_dcl(g, ops, s_), dt_)
            J_cd = self._newton_planes(g, ops, field.stencil_dFcd_dcd(g, ops, s_), dt_)
            C_clT = field.stencil_dFcl_dT(g, ops, s_)
            C_cdT = field.stencil_dFcd_dT(g, ops, s_)
            d_cdcl = field.diag_dFcd_dcl(g, s_)
            rhs_T = (YT_ - (2.0 * s_.T - dt_ * fT0)) * mask
            base_cl = (Ycl_ - 2.0 * s_.cl + dt_ * fcl0) * mask
            base_cd = (Ycd_ - 2.0 * s_.cd + dt_ * fcd0) * mask
            return rhs_T, base_cl, base_cd, J_T, J_cl, J_cd, C_clT, C_cdT, d_cdcl

        wT, wcl, wcd, J_T, J_cl, J_cd, C_clT, C_cdT, d_cdcl = df_call_df(
            sources, s, t1, dt, *Y
        )
        # the rhs rounding floors at the DF unit roundoff of the Newton rhs
        # Y (a later sweep's rhs has cancelled far below it); the JAX
        # package's df verdict takes each solve's own rhs
        noise = tuple(
            _DF_EPS_B * _DF_EPS_B * ops.asum(dfm.df_to(Yv, torch.float64) ** 2) for Yv in Y
        ) if self.mixed_final_check else (0.0, 0.0, 0.0)
        if (
            self.fused_triple
            and self.linear_solver == "krylov"
            and type(J_T) is linsolve.Stencil5
            and self.krylov_unroll is not None
            and not ops.sharded
        ):
            zT, zcl, zcd, (info_T, info_cl, info_cd) = self.solver.solve_triple_df(
                J_T, J_cl, J_cd, C_clT, C_cdT, d_cdcl, wT, wcl, wcd, mask, dt, noise
            )
        else:
            dt_df = _df_of(dt, mask)

            def coupled(w, c):
                return dfm.df_add(w, dfm.df_mask(dfm.df_mul(dt_df, c), mask32))

            def apply(st, z):
                return dfm.df_stencil_apply(type(st)(*(p.hi for p in st)),
                                            type(st)(*(p.lo for p in st)), ops, z)

            zT, info_T = self.solver.solve_df(J_T, wT, mask, ops, noise[0])
            zcl, info_cl = self.solver.solve_df(J_cl, coupled(wcl, apply(C_clT, zT)), mask, ops,
                                                noise[1])
            c_cd = dfm.df_add(apply(C_cdT, zT), dfm.df_mul(d_cdcl, zcl))
            zcd, info_cd = self.solver.solve_df(J_cd, coupled(wcd, c_cd), mask, ops, noise[2])

        T1 = dfm.df_add(dfm.df_mask(s.T, mask32), zT)  # boundary re-zeroed
        cl1 = dfm.df_add(s.cl, zcl)  # boundary kept, as in the reference
        cd1 = dfm.df_add(s.cd, zcd)

        if self.track_residuals:
            def resid(s_, T1_, cl1_, cd1_, t1_, dt_, YT_, Ycl_, Ycd_):
                res_T = 2.0 * T1_ - dt_ * field.FT(g, ops, s_._replace(T=T1_), t1_) - YT_
                s_cl = s_._replace(T=T1_, cl=cl1_)
                res_cl = 2.0 * cl1_ - dt_ * field.Fcl(g, ops, s_cl, t1_) - Ycl_
                s_cd = s_._replace(T=T1_, cl=cl1_, cd=cd1_)
                res_cd = 2.0 * cd1_ - dt_ * field.Fcd(g, ops, s_cd, t1_) - Ycd_
                return res_T, res_cl, res_cd

            res = df_call_df(resid, s, T1, cl1, cd1, t1, dt, *Y, out="f64")
        else:
            res = (torch.zeros(s.T.hi.shape, dtype=torch.float64, device=mask.device),) * 3
        resnorm = torch.maximum(
            torch.maximum(info_T["resnorm_sq"], info_cl["resnorm_sq"]), info_cd["resnorm_sq"]
        )
        iters = info_T["iters"] + info_cl["iters"] + info_cd["iters"]
        converged = info_T["converged"] & info_cl["converged"] & info_cd["converged"]
        return T1, cl1, cd1, res, iters, resnorm, converged

    def _step_fn_df(self, g: Grid, ops: Ops, at_t0: State, t0, dt):
        """The double-float step: one exact split of each field on entry, the
        state DF inside, one exact hi + lo reconstruction on exit (a DF ↔
        float64 round trip is lossless).  Same sweeps, correctors and
        boundary semantics as :meth:`step_fn`."""
        if ops.sharded:
            raise ValueError(
                "precision='df' runs on a local or batched ops provider, not on a sharded "
                f"one ({type(ops).__name__}); use precision='mixed' with mixed_df=True there"
            )
        ftype = at_t0.T.dtype
        if ftype != torch.float64:
            raise ValueError("precision='df' requires a float64 state (the DF pairs are split "
                             "from and reconstructed to float64 at the step boundary)")
        t0 = torch.as_tensor(t0, dtype=ftype, device=at_t0.T.device)
        t1 = t0 + dt
        s0 = State(*(dfm.df_split(x) for x in at_t0))

        def y_and_preds(s_, t0_, dt_):
            field = self.semi_discrete_field
            YT0 = dt_ * field.FT(g, ops, s_, t0_) + 2.0 * s_.T
            Ycl0 = dt_ * field.Fcl(g, ops, s_, t0_) + 2.0 * s_.cl
            Ycd0 = dt_ * field.Fcd(g, ops, s_, t0_) + 2.0 * s_.cd
            cp1 = self.initial_cp_pred(g, ops, s_, t0_, dt=dt_)
            cs1 = self.initial_cs_pred(g, ops, s_, t0_, dt=dt_)
            return YT0, Ycl0, Ycd0, cp1, cs1

        def correctors(T1_, cl1_, cd1_, s0_, t0_, dt_):
            cp_n = self.corrector_cp_step(g, ops, T1_, cl1_, cd1_, at_t0=s0_, t0=t0_, dt=dt_)
            cs_n, ok = self.corrector_cs_step(g, ops, T1_, cl1_, cd1_, at_t0=s0_, t0=t0_, dt=dt_)
            return cp_n, cs_n, ok

        YT0, Ycl0, Ycd0, cp1, cs1 = df_call_df(y_and_preds, s0, t0, dt)
        Y = (YT0, Ycl0, Ycd0)
        T1, cl1, cd1 = s0.T, s0.cl, s0.cd
        device = at_t0.T.device
        res = (torch.zeros_like(at_t0.T),) * 3
        total_iters = torch.zeros((), dtype=torch.int32, device=device)
        worst_resnorm = torch.zeros((), dtype=ftype, device=device)
        all_converged = torch.ones((), dtype=torch.bool, device=device)
        hcs_ok = torch.ones((), dtype=torch.bool, device=device)
        for _pc in range(self.num_pc_steps):
            for _newton in range(self.num_newton_steps):
                s_df = State(cp=cp1, T=T1, cl=cl1, cd=cd1, cs=cs1)
                T1, cl1, cd1, res, iters, resnorm, converged = self._newton_sweep_df(
                    g, ops, s_df, t1, dt, Y
                )
                total_iters = total_iters + iters
                worst_resnorm = torch.maximum(worst_resnorm, resnorm)
                all_converged = all_converged & converged
            cp1, cs1, ok = df_call_df(correctors, T1, cl1, cd1, s0, t0, dt)
            hcs_ok = hcs_ok & ok

        new_state = State(*(dfm.df_to(x, ftype) for x in (cp1, T1, cl1, cd1, cs1)))
        diag = StepDiagnostics(
            residual_T=res[0],
            residual_cl=res[1],
            residual_cd=res[2],
            krylov_iters=total_iters,
            krylov_resnorm_sq=worst_resnorm,
            krylov_converged=all_converged,
            hcs_denominator_ok=hcs_ok,
        )
        return new_state, diag

    def step_fn(self, g: Grid, ops: Ops, at_t0: State, t0, dt):
        """One PC step from ``at_t0`` at time ``t0`` (a 0-d tensor or float)
        with step ``dt`` (a float).  Returns (State, StepDiagnostics); every
        diagnostic stays a device tensor."""
        if self.precision == "df":
            return self._step_fn_df(g, ops, at_t0, t0, dt)
        field = self.semi_discrete_field
        t0 = torch.as_tensor(t0, dtype=at_t0.T.dtype, device=at_t0.T.device)
        t1 = t0 + dt

        YT0 = dt * field.FT(g, ops, at_t0, t0) + 2.0 * at_t0.T
        Ycl0 = dt * field.Fcl(g, ops, at_t0, t0) + 2.0 * at_t0.cl
        Ycd0 = dt * field.Fcd(g, ops, at_t0, t0) + 2.0 * at_t0.cd
        Y = (YT0, Ycl0, Ycd0)

        cp1 = self.initial_cp_pred(g, ops, at_t0, t0, dt=dt)
        cs1 = self.initial_cs_pred(g, ops, at_t0, t0, dt=dt)
        T1, cl1, cd1 = at_t0.T, at_t0.cl, at_t0.cd

        res = (torch.zeros_like(T1),) * 3
        total_iters = torch.zeros((), dtype=torch.int32, device=T1.device)
        worst_resnorm = torch.zeros((), dtype=T1.dtype, device=T1.device)
        all_converged = torch.ones((), dtype=torch.bool, device=T1.device)
        hcs_ok = torch.ones((), dtype=torch.bool, device=T1.device)

        for _pc in range(self.num_pc_steps):
            for _newton in range(self.num_newton_steps):
                s = State(cp=cp1, T=T1, cl=cl1, cd=cd1, cs=cs1)
                T1, cl1, cd1, res, iters, resnorm, converged = self._newton_sweep(
                    g, ops, s, t1, dt, Y
                )
                total_iters = total_iters + iters
                worst_resnorm = torch.maximum(worst_resnorm, resnorm)
                all_converged = all_converged & converged
            cp1 = self.corrector_cp_step(g, ops, T1, cl1, cd1, at_t0=at_t0, t0=t0, dt=dt)
            cs1, ok = self.corrector_cs_step(g, ops, T1, cl1, cd1, at_t0=at_t0, t0=t0, dt=dt)
            hcs_ok = hcs_ok & ok

        new_state = State(cp=cp1, T=T1, cl=cl1, cd=cd1, cs=cs1)
        diag = StepDiagnostics(
            residual_T=res[0],
            residual_cl=res[1],
            residual_cd=res[2],
            krylov_iters=total_iters,
            krylov_resnorm_sq=worst_resnorm,
            krylov_converged=all_converged,
            hcs_denominator_ok=hcs_ok,
        )
        return new_state, diag


    def step(self, at_t0: State, *, t0, dt) -> State:
        """Eager single step on the field's grid, the reference integrator's
        API: keeps the Newton residuals in ``last_residual`` and raises
        :class:`HCsCorrectorPositivityError` (one host sync) when the HCs
        corrector lost positivity."""
        g = self.semi_discrete_field.grid
        new_state, diag = self.step_fn(g, self._local_ops, at_t0, t0, dt)
        self.last_residual = {
            "T": diag.residual_T,
            "cl": diag.residual_cl,
            "cd": diag.residual_cd,
        }
        if not bool(diag.hcs_denominator_ok):
            raise HCsCorrectorPositivityError(
                "Denominator 2 - dt Kd (Sd - Cd1) (1 + Cl1) below positiveness threshold."
            )
        return new_state


class PCTrapezoidalCsTriple(PCTrapezoidalBase):
    """cs handled linearly: Heun predictor and closed-form trapezoidal
    corrector."""

    def initial_cs_pred(self, g, ops, at_t, t, *, dt):
        return self._heun_cs(g, ops, at_t, t, dt=dt)

    def corrector_cs_step(self, g, ops, _T1, cl1, cd1, *, at_t0, t0, dt):
        m = self._model
        fcs = self.semi_discrete_field.forcing.fcs
        t1 = t0 + dt
        src0 = fcs(g, ops, t0)
        src1 = fcs(g, ops, t1)
        alpha0 = -m.Kd * (m.Sd - at_t0.cd) * (1.0 + at_t0.cl)
        alpha1 = -m.Kd * (m.Sd - cd1) * (1.0 + cl1)
        num = (1.0 + 0.5 * dt * alpha0) * at_t0.cs + 0.5 * dt * (src0 + src1)
        den = 1.0 - 0.5 * dt * alpha1
        ok = torch.ones((), dtype=torch.bool, device=num.device)
        return g.interior_mask * num / den, ok


class PCTrapezoidalHCsTriple(PCTrapezoidalBase):
    """Sharp-Heaviside cs corrector: exact sign-based solve of
    2x - dt R1 H(x) = Y0 with R1 = Kd (Sd - cd1)(1 + cl1); valid only while
    2 - dt R1 stays positive, which the step reports as a device boolean
    (``hcs_denominator_ok``) for the harness to raise on once a run."""

    def initial_cs_pred(self, g, ops, at_t, t, *, dt):
        return self._heun_cs(g, ops, at_t, t, dt=dt) * g.interior_mask

    def corrector_cs_step(self, g, ops, _T1, cl1, cd1, *, at_t0, t0, dt):
        m = self._model
        field = self.semi_discrete_field
        t1 = t0 + dt
        fcs1 = field.forcing.fcs(g, ops, t1)

        R1 = (m.Sd - cd1) * (1.0 + cl1) * m.Kd
        del_Y1 = 2.0 - dt * R1
        # through the ops reduction: the verdict over the whole grid
        ok = ops.amax(-del_Y1) <= -_ESSENTIALLY_ZERO

        Y0 = 2.0 * at_t0.cs + dt * field.Fcs(g, ops, at_t0, t0) + dt * fcs1
        # the divisions only where the sign test picks them, in the JAX
        # package's order
        cs1 = torch.where(
            Y0 > _ESSENTIALLY_ZERO,
            Y0 / del_Y1,
            torch.where(Y0 < -_ESSENTIALLY_ZERO, Y0 / 2.0, torch.zeros_like(Y0)),
        )
        return cs1 * g.interior_mask, ok


class PCTrapezoidalRegHCsTriple(PCTrapezoidalBase):
    """Regularized-Heaviside cs corrector: pointwise scalar Newton on
    2x + (2x - y) e^{-eta x} = y - a.  The paper's headline integrator."""

    def __init__(
        self,
        semi_discrete_field,
        *,
        regularization_factor: float,
        num_newton_iterations: int = 5,
        consec_xs_rtol: float = 1e-6,
        **kwargs,
    ):
        super().__init__(semi_discrete_field, **kwargs)
        # kept as given: a tensor that requires grad carries its gradient
        self._regularization_factor = regularization_factor
        self._num_newton_iterations = int(num_newton_iterations)
        self._consec_xs_rtol = float(consec_xs_rtol)
        # the JAX package runs budgets above 16 as a while_loop, which it
        # cannot differentiate; the same call fails here
        if self.differentiable and self._num_newton_iterations > 16:
            raise ValueError(
                "differentiable=True needs the unrolled pointwise-Newton cs "
                "corrector (num_newton_iterations <= 16)"
            )

    def initial_cs_pred(self, g, ops, at_t, t, *, dt):
        return self._heun_cs(g, ops, at_t, t, dt=dt) * g.interior_mask

    @staticmethod
    def _newton_delta(x, y, a, eta):
        """dx = -f/J for f = 2x + (2x-y)e^{-ηx} - y + a, overflow-free: for
        ηx < -300 both f and J are scaled by e^{ηx}; the double ``where``
        keeps the inactive branch finite."""
        big = eta * x < -300.0
        zero = torch.zeros_like(x)
        x_o = torch.where(big, zero, x)
        e = torch.exp(-eta * x_o)
        f_o = 2.0 * x_o + (2.0 * x_o - y) * e - y + a
        J_o = 2.0 + 2.0 * e - eta * (2.0 * x_o - y) * e
        x_s = torch.where(big, x, zero)
        ep = torch.exp(eta * x_s)
        f_s = (2.0 * x_s - y + a) * ep + (2.0 * x_s - y)
        J_s = 2.0 * ep + 2.0 - eta * (2.0 * x_s - y)
        f = torch.where(big, f_s, f_o)
        J = torch.where(big, J_s, J_o)
        return -f / J

    def _newton_iterations(self, ops, y, a, eta, x0):
        """Pointwise Newton with the reference's early exit (max|dx| below
        rtol·min|x|), as a `done` mask over a fixed budget: equal to
        stopping at that iteration, with no host synchronisation."""
        rtol = self._consec_xs_rtol
        x = x0
        done = torch.zeros((), dtype=torch.bool, device=x0.device)
        for _ in range(self._num_newton_iterations):
            dx = self._newton_delta(x, y, a, eta)
            x_new = x + dx
            max_dx = ops.amax(torch.abs(dx))
            min_abs_x = -ops.amax(-torch.abs(x_new))
            x = torch.where(done, x, x_new)
            done = done | (max_dx < rtol * min_abs_x)
        return x

    def corrector_cs_step(self, g, ops, _T1, cl1, cd1, *, at_t0, t0, dt):
        m = self._model
        field = self.semi_discrete_field
        eta = self._regularization_factor
        t1 = t0 + dt
        fcs0 = field.forcing.fcs(g, ops, t0)
        fcs1 = field.forcing.fcs(g, ops, t1)
        H0 = heaviside_regularized(at_t0.cs, eta)
        y = (
            2.0 * at_t0.cs
            - dt * m.Kd * (m.Sd - at_t0.cd) * (at_t0.cl + 1.0) * H0
            + dt * (fcs0 + fcs1)
        )
        a = dt * m.Kd * (m.Sd - cd1) * (cl1 + 1.0)
        cs1 = self._newton_iterations(ops, y, a, eta, at_t0.cs)
        return cs1 * g.interior_mask, torch.ones((), dtype=torch.bool, device=cs1.device)
