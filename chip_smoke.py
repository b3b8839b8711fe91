#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (na_dd_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``na_dd_tpu_torch/csrc`` with nvcc (one
nvcc per source, all in parallel), holds each against its plain PyTorch
version on the card, and drives the port's paths:

* 2-D: the MMSCasePol RegHCs spatial study, N=2..256, dt = h^1.5,
  Tf = 0.01, eta = 50, through ``MMSTrial.run_for_errors`` in float64 and
  float32 (kernels K1 ``bicgstab_solve`` and K2 ``stencil5_apply``);
* 2-D, analytic couplings: the same study with
  ``coupling_source="analytic"``, N=8..256, whose Newton sweep is one launch
  of K4 ``triple_solve`` (and, with ``fused_triple=False``, three of K1);
* 2-D, large grid: the scale_probe protocol (pol, N=1024, dt = 0.25/N, 5
  steps), where the 5-point apply runs at 1025 x 1025 (the TPU's K3);
* 3-D: the three_d_study protocol (MMSCaseExpSin3, RegHCs, eta = 50,
  Tf = 0.02, two Newton sweeps, dt = 1e-2/2^k), N=64 and N=128 in float64
  (N=4..16 through the 3-D study CLI, below) and N=32 in float32,
  through ``make_setup3`` and ``run_trial3`` (kernels K5
  ``bicgstab_solve3`` and K6/K7 ``stencil7_apply``);
* 2-D, ExpSin: the ExpSin notebook's N=256 level on the jvp route (K1/K2)
  and fused through K4, held to the notebook and to CPU-x64 (the ladder
  below it and its rate are the study CLI's run, below);
* the goldens: every case of ``tests/test_parity_golden.py`` (the Cs, HCs,
  RegHCs and forward-Euler variants, the case families, a non-uniform grid)
  at that file's tolerances; and the 3-D Cs/HCs/RegHCs variants on
  MMSCasePol3 and through MMSCaseCsZeroCrossing3 against the CPU plain
  versions (K5/K6);
* the JAX package's production modes on the pol N=256 level, built by the
  studies module's ``_make_trial``: ``precision="mixed"`` (float32 K1 under
  f64 refinement), ``mixed_fast`` (refine 1, no final check, the float32
  error tail, time tables), ``mixed`` with fused analytic couplings (float32
  K4 under block refinement), float32 and f64 with time tables; the study
  module's spatial and temporal pol ladders against CPU-x64; and the 3-D
  ExpSin3 N=64 level with ``precision="mixed"`` (float32 K5);
* the modeller's path on the drug-release scenario at N=256 (no forcing,
  against the JAX package's CPU-x64 values): ``simulate`` (K1/K2; and the
  3-D sin bump at N=64 through K5/K6), ``simulate_adaptive``,
  ``run_checkpointed`` and its resume (bit for bit the straight run), IFT
  gradients through ``build_simulator`` (K1 forward, recomputed and on the
  transposed planes; mixed and direct at N=64), the pol N=256 level with
  ``linear_solver="direct"``, and ``fit_parameters`` at N=64.
* the batch axis: the pol spatial ladder N=2..256 as one batch of 8 levels
  padded to 257^2 (``run_spatial_ladder_batched``), the notebook's eta sweep
  as one batch of 7 (``run_eta_study_batched``), the 3-D ladder N=4..64 as
  one batch of 5 volumes padded to 65^3 (``run_spatial_ladder3_batched``)
  and the 3-D eta sweep at N=32 (``run_eta_sweep3``, through the 3-D study
  CLI below), each against CPU-x64
  and, where it has one, the serial path on the card, with the batched
  K1/K2/K5/K6 (one launch a stack) against their batched plain versions
  and against the unbatched kernels system by system;
* the solver options: the pol N=256 level with colour-probed planes
  (``stencil_source="probe"``, K1/K2) and with the while form
  (``krylov_unroll=None``: K1 at a budget of 300, bit for bit the default
  level); the matrix-free route (``assemble_stencil=False``, no kernel) at
  N=64; the first 8 steps of the 3-D ExpSin3 N=64 level with 7-colour
  probed volumes (K5/K6),
  N=32 with ``linear_solver="direct"`` (x-plane BCR, the K6 verdict);
  ``heat_mms_error`` at N=16..128 (Crank-Nicolson: K5 a step, K6 for the
  rhs); ``differentiable=True`` on the 3-D sin bump (the adjoints by K5 on
  transposed volumes) against CPU-x64 ``jax.grad``; both batched ladders in
  ``precision="mixed"`` (float32 batched K1/K5 under per-level f64
  refinement), each route's steady wall-clock in turns with the one it
  mirrors;
* K4 with a batch dimension: the pol ladder N=2..256 as one batch and the
  eta sweep with ``coupling_source="analytic"`` (each Newton sweep of the
  whole batch one launch of batched K4; the ladder also in
  ``precision="mixed"``), against CPU-x64 and the per-solve batched routes,
  with batched K4 against its plain version on their step-1 stacks, an edge
  stack and a batch of one (the single-system kernel, bit for bit);
* the parallel layer (``na_dd_tpu_torch.parallel``): 4 gloo ranks on the one
  card run the pol level N=255 sharded over rows (5 steps; the Krylov
  matvec K2 on halo-padded blocks) and, on a 2 x 2 mesh, the 2-D step,
  mixed, direct, value-and-grad and 2 steps of ExpSin3 N=31 (K6 on
  halo-padded volumes), each against the local run on the card; a sharded
  checkpoint saved by 4 ranks restored on 2 and on 1; the ensemble at
  B = 8, 32 and 128 (batched K1/K2; 128 in four parts), every member to
  CPU-x64, and dp=2 against dp=1;
* the user entry points (``na_dd_tpu_torch.studies``), each run as a user runs
  it, in a process of its own: the six-notebook reproduction of the pol
  study in its fast mode (``run_all --only pol``: the batched mixed ladder,
  the mixed temporal ladder and the mixed eta sweep, every level held to
  CPU-x64 and the report's rows read PASS) and the study CLI on the ExpSin
  spatial ladder (``run_study``, every level to the notebook, and its rate);
* double-float (``precision="df"``, ``mixed_df``): the error-free
  transformations on CUDA tensors, each DF function against its CPU run,
  the lifted field evaluation, the df pol ladder N=8..64 (float32 K1) and
  the main level in bench.py's df_fast mode (float32 K4) against the JAX
  package's CPU-x64 df record and CPU-x64, ``mixed_df`` per-solve and fused
  at N=256, one 3-D ExpSin3 N=64 df step (float32 K5) against the float64
  step, and the 33-eta analytic sweep in batches of at most 32;
* the other study CLIs, called in process: the 3-D study's ladder
  N=4..16 and its eta sweep at N=32 (K5/K6), the eta-gradient study at N=16
  (K1 forward and on transposed planes) and the ensemble screen at B = 1
  and 32 (batched K1/K2), each held to the JAX package's CPU-x64 values.

It checks the errors against the reference values and the launch counts of
each path's main level (counts set to 0 just before it, read just after),
times the kernels (torch.profiler and CUDA events; K4 also beside the
per-solve route on the same systems), prints each kernel's registers and spills from
ptxas, profiles five steps of the 2-D main level and one df step, and prints
one JSON line with every kernel's numbers, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
Every check that fails stops the script with a nonzero exit code; without a
card it exits nonzero at once.  Imports nothing of JAX.

``--only PHASE[,PHASE...]`` runs a subset of the phases (for debugging) and
then prints no result line.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# The pol notebook's saved spatial-study errors (6 digits), N = 2..256, and
# the repo's archived values the port is held to (bench.py MODE_REFERENCE,
# studies/results/pol_spatial.json "adjudication", ROADMAP.md).
POL_REFERENCE = {
    2: 4.93452e-05, 4: 1.59616e-05, 8: 4.28269e-06, 16: 1.08800e-06,
    32: 2.75006e-07, 64: 6.96085e-08, 128: 1.74802e-08, 256: 4.38284e-09,
}
# CPU-x64 runs of the JAX package: the pol spatial level N=128 and the pol
# temporal level N=256, dt=5e-3 (2 steps) — studies/results/pol_spatial.json
# and pol_temporal.json, "adjudication" blocks.
N128_CPU_X64 = 1.748023286554424e-08
N256_DT5E3_CPU_X64 = 8.49853547270653e-09
# The archived f64 value of the main level (bench.py MODE_REFERENCE, measured
# on a TPU with emulated f64; bench.py gates it at 1e-7 relative).
N256_F64 = 4.382843255135883e-09
# The port's own value of the main level (the card and the CPU plain versions
# agree to 7e-15); the kernels of later slices must leave it bit for bit.
N256_F64_PORT = 4.3828432027479154e-09
N256_F32 = 3.7049e-07  # f32 + kernel error floor
# The JAX package's CPU-x64 values of the pol study (exact f64 arithmetic;
# studies/results/pol_cpu_x64.json, made by studies/pol_cpu_x64.py): the
# spatial ladder N=2..256 at dt = h^1.5 and the temporal ladder at N=256,
# dt = 1e-2/2^k.
POL_SPATIAL_CPU_X64 = {
    2: 4.934519423367602e-05, 4: 1.596157861382319e-05, 8: 4.282692732192525e-06,
    16: 1.087998167311069e-06, 32: 2.750060013224652e-07, 64: 6.960848974797674e-08,
    128: 1.7480232865543962e-08, 256: 4.382843202899936e-09,
}
POL_TEMPORAL_CPU_X64 = {
    0.01: 3.601005705979531e-08, 0.005: 8.498535472736817e-09,
    0.0025: 4.019800984460384e-09, 0.00125: 4.181994727996142e-09,
}
N256_CPU_X64 = POL_SPATIAL_CPU_X64[256]
# bench.py MODE_REFERENCE: the JAX package's production modes on a TPU
# (emulated f64), printed beside the port's values and never gated on.
BENCH_TPU = {
    "f64": 4.382843255135883e-09, "mixed": 4.382843255135106e-09,
    "mixed_pallas": 4.382843255136001e-09, "mixed_fast": 4.382843254823708e-09,
    "f32_pallas_fast": 3.704867759636057e-07,
}
TF, ETA, MAIN_N = 0.01, 50.0, 256
# CPU-x64 runs of the JAX package with coupling_source="analytic" (pol,
# dt = h^1.5, Tf = 0.01, krylov_unroll=8).
POL_ANALYTIC_CPU_X64 = {
    8: 4.282692732192525e-06, 16: 1.087998167311069e-06,
    32: 2.750060013224652e-07, 64: 6.960848974797674e-08,
}
SCALE_N, SCALE_STEPS = 1024, 5  # studies/scale_probe.py: dt = 0.25/N, Tf = 5 dt

# The ExpSin notebook's spatial study (cell 9; studies/reference_values.py,
# ("expsin", "spatial"), 13 digits), N = 2..256, and the JAX package's CPU-x64
# value of its finest level (studies/results/expsin_cpu_check.json).
EXPSIN_REFERENCE = {
    2: 1.942652829989e-05, 4: 5.197056624911e-06, 8: 1.322695968641e-06,
    16: 3.372248813359e-07, 32: 8.344194130557e-08, 64: 2.052209700229e-08,
    128: 5.119616858484e-09, 256: 1.278782670173e-09,
}
EXPSIN_N256_CPU_X64 = 1.2787826717343696e-09
# tests/test_parity_golden.py: the reference's own runs (16 digits)
GOLDEN_EXPSIN = {
    2: 1.9426528299885707e-05, 4: 5.1970566249110085e-06,
    8: 1.3226959686374811e-06, 16: 3.3722488132093435e-07,
}
GOLDEN_CSTRIPLE = {8: 1.3027694406570663e-06, 16: 3.2704272907552362e-07}
GOLDEN_HCS_ZERO_CROSSING = 3.5029545962258690e-03
GOLDEN_NFSP = 7.7437919308797556e-07
GOLDEN_FE = 5.4271963227677798e-06
GOLDEN_FE_PER_VAR = {
    "cp": 9.0169225197585734e-11, "T": 6.4097681890801875e-07,
    "cl": 1.2030623521024432e-07, "cd": 5.3878692490357578e-06,
    "cs": 2.0507711164165844e-11,
}
GOLDEN_NONUNIFORM = 1.1814023749544314e-05
PARITY_RTOL = 1e-8

# The 3-D study (studies/three_d_study.py protocol): CPU-x64 errors of the
# JAX package's build_runner3 at N = 4..64, dt = 1e-2/2^k; N=128 has none (its
# CPU run needs more memory than was at hand) and is held by its rate.  The
# TPU f32 value at N=32 is studies/results/three_d_study_tpu_f32_pallas.json.
THREE_D_CPU_X64 = {
    4: 0.0005209171734887429, 8: 0.000133542682516219, 16: 3.359630772779315e-05,
    32: 8.412298784898419e-06, 64: 2.1039020003257464e-06,
}
THREE_D_TPU_F32_N32 = 9.11504957912257e-06
TF3, MAIN_N3 = 0.02, 64
N128, DT128 = 128, 3.125e-4  # the rate level: 129^3 nodes, 64 steps
THREE_D_CONSTS = dict(K1=1e-3, K2=1e-3, K3=1e-3, K4=1e-3, Dl_max=1e-5, Kd=1e-2, Sd=1.0, Dd_max=1e-6)
# The batched sweeps' CPU-x64 values (studies/batched_cpu_x64.py, into
# studies/results/batched_cpu_x64.json): the pol notebook's cell-13 sweep
# (N=32, dt=5e-4, Tf=0.01, eta in ETA_LADDER) and the 3-D study's sweep at the
# ladder's N=32 step (eta = logspace(1, 3, 7), one Newton sweep a step as
# run_eta_sweep3's integrator makes).
ETA_BATCHED_CPU_X64 = [
    2.787588142094822e-07, 2.787588142086098e-07, 2.7875881420842784e-07,
    2.7875881420839597e-07, 2.7875881420838924e-07, 2.787588142083843e-07,
    2.787588142083802e-07,
]
ETA3 = dict(N=32, Tf=0.02, dt=1.25e-3)
ETA3_CPU_X64 = [
    8.412298781497131e-06, 8.412298781475884e-06, 8.412298781474295e-06,
    8.412298781474214e-06, 8.412298781474215e-06, 8.412298781474215e-06,
    8.412298781474217e-06,
]
BATCH_LEVELS = 8  # the pol ladder N=2..256 as one batch
BATCH_LEVELS3 = 5  # the 3-D ladder N=4..64 as one batch

# H100 SXM published peaks (NVIDIA data sheet): HBM rate and the non-tensor
# f64 / f32 rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_to_max(a, b) -> float:
    """max|a - b| / max|b| (relative to the plain version's max-norm)."""
    return float((a - b).abs().max() / b.abs().max())


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_trial(N: int, dtype, device, dt=None, **integrator_kw):
    """The pol level N; ``integrator_kw`` (coupling_source, fused_triple,
    stencil_source, krylov_unroll, ...) goes to the integrator, over the
    protocol's Krylov budget."""
    from na_dd_tpu_torch.core.fields import FieldRegHCsTriple
    from na_dd_tpu_torch.core.forcing import MMSForcingRegHCsTriple
    from na_dd_tpu_torch.harness.studies import choose_krylov_unroll
    from na_dd_tpu_torch.harness.trial import MMSTrial
    from na_dd_tpu_torch.integrators.pc_trapezoidal import PCTrapezoidalRegHCsTriple
    from na_dd_tpu_torch.mms.cases import MMSCasePol
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import POL_PEAKS_CONSTS
    from na_dd_tpu_torch.ops.grid import make_uniform_grid

    dt = (1.0 / N) ** 1.5 if dt is None else dt
    trial = MMSTrial(
        make_uniform_grid(N, N, dtype=dtype, device=device),
        Model02(POL_PEAKS_CONSTS),
        MMSCasePol,
        FieldRegHCsTriple,
        MMSForcingRegHCsTriple,
        PCTrapezoidalRegHCsTriple,
        forcing_terms_params=dict(regularization_factor=ETA),
        field_params=dict(regularization_factor=ETA),
        integrator_params={
            "regularization_factor": ETA,
            "track_residuals": False,
            "krylov_unroll": choose_krylov_unroll(N, dt, POL_PEAKS_CONSTS),
            **integrator_kw,
        },
    )
    return trial, dt


def random_planes(rng, shape, dtype, device, dominant: bool):
    """Random Stencil5 planes (2-D shape) or Stencil7 volumes (3-D shape) and
    an operand; diagonally dominant when asked."""
    import torch

    from na_dd_tpu_torch.ops.linsolve import Stencil5
    from na_dd_tpu_torch.three_d.diffusion import Stencil7

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    n_offs = 2 * len(shape)
    if dominant:
        c0 = 4.5 + 2.0 * (len(shape) - 2) + rng.random(shape)
        offs = [-rng.random(shape) for _ in range(n_offs)]
    else:
        c0 = rng.standard_normal(shape)
        offs = [rng.standard_normal(shape) for _ in range(n_offs)]
    cls = Stencil5 if len(shape) == 2 else Stencil7
    return cls(t(c0), *(t(o) for o in offs)), t(rng.standard_normal(shape))


class RecordingSolver:
    """Solver backend that records each Newton system before solving it."""

    def __init__(self, inner):
        self.inner = inner
        self.systems = []
        self.triples = []

    def solve(self, st, rhs, mask, *noise_sq):
        self.systems.append((st, rhs * mask, mask))
        return self.inner.solve(st, rhs, mask, *noise_sq)

    def solve_triple(self, *args):
        self.triples.append(args)
        return self.inner.solve_triple(*args)


def jacobi(st, mask):
    import torch

    return torch.where(
        mask > 0,
        1.0 / torch.where(st.c0 == 0, torch.ones_like(st.c0), st.c0),
        torch.zeros_like(st.c0),
    )


def step1_systems(dtype, device, N=MAIN_N, dt=None):
    """The T, cl and cd Newton systems of step 1 of the pol level N (the
    main level unless asked)."""
    import torch

    trial, dt = make_trial(N, dtype, device, dt)
    integ = trial.integrator
    rec = RecordingSolver(integ.solver)
    integ.solver = rec
    t0 = torch.zeros((), dtype=dtype, device=device)
    integ.step_fn(trial.grid, trial.ops, trial.initial_state, t0, dt)
    integ.solver = rec.inner
    check(len(rec.systems) == 3, "step 1 should make three Newton solves")
    return rec.systems, rec.inner


def step1_triple(dtype, device):
    """The operands of K4 in step 1 of the pol N=256 run with analytic
    couplings, as :func:`kernels.triple_solve` takes them (the three Jacobi
    inverse diagonals filled in), and the solver backend."""
    import torch

    trial, dt = make_trial(MAIN_N, dtype, device, coupling_source="analytic")
    integ = trial.integrator
    rec = RecordingSolver(integ.solver)
    integ.solver = rec
    t0 = torch.zeros((), dtype=dtype, device=device)
    integ.step_fn(trial.grid, trial.ops, trial.initial_state, t0, dt)
    integ.solver = rec.inner
    check(len(rec.triples) == 1 and not rec.systems,
          "step 1 with analytic couplings should make one fused triple solve")
    *planes, mask, dt_ = rec.triples[0][:11]  # less the rhs noise floors
    J_T, J_cl, J_cd = planes[:3]
    operands = (*planes, jacobi(J_T, mask), jacobi(J_cl, mask), jacobi(J_cd, mask), mask, dt_)
    return operands, rec.inner


def random_triple(rng, shape, dtype, device):
    """Random operands of K4 on an interior-masked plane: three diagonally
    dominant Newton operators, two unstructured coupling operators, a random
    diagonal coupling and right-hand sides, dt = 0.05."""
    from na_dd_tpu_torch.ops.grid import make_uniform_grid

    mask = make_uniform_grid(shape[0] - 1, shape[1] - 1, dtype=dtype, device=device).interior_mask
    Js = []
    for _ in range(3):
        st, _u = random_planes(rng, shape, dtype, device, dominant=True)
        Js.append(type(st)(*(c * mask for c in st)))
    Cs = [random_planes(rng, shape, dtype, device, dominant=False)[0] for _ in range(2)]
    d_cdcl, rhs_T, base_cl, base_cd = (
        random_planes(rng, shape, dtype, device, dominant=False)[1] for _ in range(4))
    return (*Js, *Cs, d_cdcl, rhs_T, base_cl, base_cd,
            *(jacobi(J, mask) for J in Js), mask, 0.05)


def compare_triple(operands, *, tol, iters, xtol, stol, label):
    """K4 against its plain version on one set of operands: identical
    iteration counts and convergence flags, each increment within ``xtol`` of
    the plain version's max-norm, tol_sq within ``stol`` relative and
    resnorm_sq within ``stol`` relative plus its rounding floor.  Returns (max abs error, kernel's converged flags)."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    *xk, ik = kernels.triple_solve(*operands, tol=tol, iters=iters)
    *xp, ip = kernels.triple_solve_plain(*operands, tol=tol, iters=iters)
    torch.cuda.synchronize()
    tiny = torch.finfo(xk[0].dtype).tiny  # an increment that is 0 must come out 0
    rels = [float((a - b).abs().max() / b.abs().max().clamp_min(tiny)) for a, b in zip(xk, xp)]
    itk, itp = ik["iters"].tolist(), ip["iters"].tolist()
    # The recurrence residual of a converged solve is what cancellation left
    # of r: once it nears the rounding floor (eps |b|)^2 of the iteration its
    # own relative difference is noise (79 % in float32 after one iteration
    # on the step-1 systems).  It is held to ``stol`` relative plus 16 times
    # that floor; tol_sq to ``stol`` relative.
    floor = 16.0 * torch.finfo(xk[0].dtype).eps ** 2 * ip["tol_sq"] / (tol * tol)
    res_diff = (ik["resnorm_sq"] - ip["resnorm_sq"]).abs()
    raw = float((res_diff / ip["resnorm_sq"].abs().clamp_min(1e-300)).max())
    res_ok = bool((res_diff <= stol * ip["resnorm_sq"] + floor).all())
    tol_rel = float(((ik["tol_sq"] - ip["tol_sq"]).abs() / ip["tol_sq"].abs().clamp_min(1e-300)).max())
    log(f"[k4] {label}: iters kernel {itk} plain {itp}, max rel diff dT/dcl/dcd "
        + "/".join(f"{r:.3e}" for r in rels) + f" (limit {xtol:g}), resnorm_sq rel {raw:.3e} "
        f"({'within' if res_ok else 'OUTSIDE'} {stol:g} relative + 16 eps^2 b.b), tol_sq rel "
        f"{tol_rel:.3e} (limit {stol:g}), converged {ik['converged'].tolist()}")
    check(all(bool(torch.isfinite(x).all()) for x in xk), f"K4 {label}: output not finite")
    check(itk == itp, f"K4 {label}: iteration counts differ")
    check(max(rels) <= xtol, f"K4 {label}: an increment disagrees with the plain version")
    check(ik["converged"].tolist() == ip["converged"].tolist(),
          f"K4 {label}: convergence flags differ")
    check(tol_rel <= stol, f"K4 {label}: tol_sq disagrees")
    check(res_ok, f"K4 {label}: resnorm_sq disagrees")
    return max(float((a - b).abs().max()) for a, b in zip(xk, xp)), ik["converged"].tolist()


def phase_k4(device):
    import torch

    from na_dd_tpu_torch.integrators.pc_trapezoidal import default_krylov_tol

    rng = np.random.default_rng(4)
    for dtype, xtol, stol in ((torch.float64, 1e-12, 1e-10), (torch.float32, 1e-5, 1e-4)):
        name = str(dtype)[6:]
        for shape in ((257, 257), (130, 257)):
            operands = random_triple(rng, shape, dtype, device)
            _, conv = compare_triple(operands, tol=default_krylov_tol(dtype), iters=40,
                                     xtol=xtol, stol=stol, label=f"{name} random {shape}")
            check(all(conv), f"K4 {name} random {shape}: a solve did not converge")
            if shape == (257, 257):
                _, conv = compare_triple(operands, tol=default_krylov_tol(dtype), iters=1,
                                         xtol=xtol, stol=stol,
                                         label=f"{name} random {shape}, budget cut to 1")
                check(not all(conv), "K4 budget cut: one iteration should not converge")
    # the T solve ends before its first iteration and writes dT after its
    # only barrier: cl's rhs must still see dT = 0 at every neighbour
    operands = list(random_triple(rng, (257, 257), torch.float64, device))
    operands[6] = torch.zeros_like(operands[6])  # rhs_T
    _, conv = compare_triple(tuple(operands), tol=1e-13, iters=40, xtol=1e-12, stol=1e-10,
                             label="float64 random (257, 257), rhs_T = 0")
    check(all(conv), "K4 rhs_T = 0: a solve did not converge")
    main_err = None
    for dtype, xtol, stol in ((torch.float64, 1e-12, 1e-10), (torch.float32, 1e-5, 1e-4)):
        operands, solver = step1_triple(dtype, device)
        err, conv = compare_triple(operands, tol=default_krylov_tol(dtype), iters=solver.iters,
                                   xtol=xtol, stol=stol,
                                   label=f"{str(dtype)[6:]} step-1 systems of N={MAIN_N}")
        check(all(conv), "K4 step-1 systems: a solve did not converge")
        if dtype == torch.float64:
            main_err = err
    return dict(main=main_err, batched=phase_k4_batched(device))


K2_SHAPES = ((257, 257), (257, 130))
# the large-grid plane, the TPU tiled kernel's ragged test shapes and a plane
# twice as tall
K3_SHAPES = ((1025, 1025), (33, 33), (40, 17), (9, 129), (129, 65), (2049, 1025))


def phase_apply5(device, tag, shapes, seed):
    """The 5-point apply against its plain version at ``shapes`` (K2: the
    main path's planes; K3: the shapes where the TPU used its row-tiled
    kernel).  Returns the float64 max abs error at the first shape."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    rng = np.random.default_rng(seed)
    worst = {}
    for dtype, tol in ((torch.float64, 1e-14), (torch.float32, 1e-6)):
        for shape in shapes:
            st, u = random_planes(rng, shape, dtype, device, dominant=False)
            k = kernels.stencil5_apply(st, u)
            p = kernels.stencil5_apply_plain(st, u)
            torch.cuda.synchronize()
            rel = rel_to_max(k, p)
            log(f"[{tag}] {str(dtype)[6:]} {shape}: max rel diff {rel:.3e} (limit {tol:g}), "
                f"max abs {float((k - p).abs().max()):.3e}")
            check(bool(torch.isfinite(k).all()), f"{tag.upper()} output not finite")
            check(rel <= tol, f"{tag.upper()} {dtype} {shape} disagrees with its plain version")
            worst[(dtype, shape)] = float((k - p).abs().max())
            del st, u, k, p
    return worst[(torch.float64, shapes[0])]


def compare_solve(st, b, inv_diag, mask, *, tol, iters, xtol, label):
    """K1 (a plane) or K5 (a volume) against its plain version on one
    system: identical iteration counts, x within ``xtol`` of the plain
    version's max-norm.  Returns (max abs error, iterations)."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    if b.dim() == 2:
        tag, solve, plain = "k1", kernels.bicgstab_solve, kernels.bicgstab_solve_plain
    else:
        tag, solve, plain = "k5", kernels.bicgstab_solve3, kernels.bicgstab_solve3_plain
    xk, ik = solve(st, b, inv_diag, mask, tol=tol, iters=iters)
    xp, ip = plain(st, b, inv_diag, mask, tol=tol, iters=iters)
    torch.cuda.synchronize()
    rel = rel_to_max(xk, xp)
    itk, itp = int(ik["iters"]), int(ip["iters"])
    log(f"[{tag}] {label}: iters kernel {itk} plain {itp}, max rel diff x {rel:.3e} "
        f"(limit {xtol:g}), resnorm_sq {float(ik['resnorm_sq']):.3e}, "
        f"converged {bool(ik['converged'])}")
    check(bool(torch.isfinite(xk).all()), f"{tag.upper()} {label}: x not finite")
    check(itk == itp, f"{tag.upper()} {label}: iteration counts differ")
    check(rel <= xtol, f"{tag.upper()} {label}: x disagrees with the plain version")
    return float((xk - xp).abs().max()), itk


def solve_edge_cases(device, cases):
    """K1 (planes) or K5 (volumes) against its plain version where the
    solve's schedule branches (csrc/bicgstab.cuh): b = 0 (no iteration,
    x = 0), A = c0 I (an exit on s_conv in iteration 1), grids smaller than one
    block and ragged ones, each with a budget of 40, past convergence.
    ``cases``: (case, shape) pairs, case "zero rhs", "diagonal" or
    "dominant"."""
    import torch

    from na_dd_tpu_torch.integrators.pc_trapezoidal import default_krylov_tol
    from na_dd_tpu_torch.ops import kernels

    rng = np.random.default_rng(8)
    budget = 40
    for dtype, xtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        tol = default_krylov_tol(dtype)
        for case, shape in cases:
            label = f"{str(dtype)[6:]} {case} {shape}, budget {budget}"
            m = np.zeros(shape)
            m[(slice(1, -1),) * len(shape)] = 1.0
            mask = torch.as_tensor(m, dtype=dtype, device=device)
            st, b = random_planes(rng, shape, dtype, device, dominant=True)
            st, b = type(st)(*(c * mask for c in st)), b * mask
            if case == "zero rhs":
                b = torch.zeros_like(b)
            elif case == "diagonal":
                st = type(st)(st[0], *(torch.zeros_like(c) for c in st[1:]))
            inv = jacobi(st, mask)
            if case == "zero rhs":
                solve = kernels.bicgstab_solve if len(shape) == 2 else kernels.bicgstab_solve3
                x, info = solve(st, b, inv, mask, tol=tol, iters=budget)
                used, zero = int(info["iters"]), float(x.abs().max()) == 0.0
                log(f"[edge] {label}: iters {used}, x == 0 {zero}")
                check(used == 0 and zero, f"{label}: expected 0 iterations and x = 0")
                continue
            _, used = compare_solve(st, b, inv, mask, tol=tol, iters=budget, xtol=xtol,
                                    label=label)
            if case == "diagonal":
                check(used == 1, f"{label}: expected the exit on s_conv in iteration 1")
            else:
                check(0 < used < budget, f"{label}: expected convergence inside the budget")


def phase_k1(device):
    import torch

    from na_dd_tpu_torch.integrators.pc_trapezoidal import default_krylov_tol
    from na_dd_tpu_torch.ops.grid import make_uniform_grid

    rng = np.random.default_rng(1)
    for dtype, xtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        mask = make_uniform_grid(256, 256, dtype=dtype, device=device).interior_mask
        st, b = random_planes(rng, (257, 257), dtype, device, dominant=True)
        st = type(st)(*(c * mask for c in st))
        compare_solve(st, b * mask, jacobi(st, mask), mask,
                      tol=default_krylov_tol(dtype), iters=40, xtol=xtol,
                      label=f"{str(dtype)[6:]} random dominant 257x257")
    solve_edge_cases(device, (("zero rhs", (257, 257)), ("diagonal", (257, 257)),
                              ("dominant", (9, 9)), ("dominant", (130, 257))))
    main_err = None
    for dtype, xtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        systems, solver = step1_systems(dtype, device)
        for name, (st, b, mask) in zip(("T", "cl", "cd"), systems):
            err, _ = compare_solve(st, b, jacobi(st, mask), mask,
                                   tol=default_krylov_tol(dtype), iters=solver.iters,
                                   xtol=xtol, label=f"{str(dtype)[6:]} step-1 {name} plane")
            if dtype == torch.float64:
                main_err = max(err, main_err or 0.0)
    return main_err


def run_level(N, dtype, device, dt=None, **integrator_kw):
    trial, dt = make_trial(N, dtype, device, dt, **integrator_kw)
    summary = trial.run_for_errors(Tf=TF, dt=dt)
    return trial, dt, summary


def phase_slice_f64(device):
    import torch

    from na_dd_tpu_torch.ops import kernels

    for N in (2, 4, 8, 16, 32, 64, 128):
        _, _, s = run_level(N, torch.float64, device)
        err = s.overall_combined_error
        rel = abs(err - POL_REFERENCE[N]) / POL_REFERENCE[N]
        log(f"[f64] N={N}: error {err!r}, vs reference {POL_REFERENCE[N]:g} rel {rel:.3e}")
        check(math.isfinite(err) and rel <= 1e-5, f"N={N} off the reference")
        check(bool(s.series.krylov_converged.all()), f"N={N}: a solve did not converge")
        if N == 128:
            rel128 = abs(err - N128_CPU_X64) / N128_CPU_X64
            log(f"[f64] N=128 vs CPU-x64 {N128_CPU_X64!r}: rel {rel128:.3e}")
            check(rel128 <= 1e-8, "N=128 off the CPU-x64 value")

    _, _, s = run_level(MAIN_N, torch.float64, device, dt=5e-3)
    err = s.overall_combined_error
    rel = abs(err - N256_DT5E3_CPU_X64) / N256_DT5E3_CPU_X64
    log(f"[f64] N=256 dt=5e-3: error {err!r}, vs CPU-x64 {N256_DT5E3_CPU_X64!r} rel {rel:.3e}")
    check(math.isfinite(err) and rel <= 1e-8, "N=256 dt=5e-3 off the CPU-x64 value")

    # the main path: counts set to 0 just before, read just after
    trial, dt = make_trial(MAIN_N, torch.float64, device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    s = trial.run_for_errors(Tf=TF, dt=dt)
    launches = dict(kernels.LAUNCHES)
    err = s.overall_combined_error
    nsteps = len(s.series.krylov_iters)
    rel = abs(err - N256_F64) / N256_F64
    log(f"[f64] N=256: error {err!r}, vs archived {N256_F64!r} rel {rel:.3e}; steps "
        f"{nsteps}; launches {launches}; Krylov iterations "
        f"{int(s.series.krylov_iters.sum())} (per step {s.series.krylov_iters.tolist()})")
    check(math.isfinite(err) and rel <= 1e-7, "N=256 f64 off the archived value")
    check(err == N256_F64_PORT, f"N=256 f64 moved from the port's {N256_F64_PORT!r}")
    rel_x64 = abs(err - N256_CPU_X64) / N256_CPU_X64
    log(f"[f64] N=256 vs CPU-x64 {N256_CPU_X64!r}: rel {rel_x64:.3e} (limit 1e-8)")
    check(rel_x64 <= 1e-8, "N=256 f64 off the CPU-x64 value")

    check(nsteps == 41, "N=256 should take 41 steps")
    for name in ("bicgstab_solve", "stencil5_apply"):
        check(launches[name] == 3 * nsteps,
              f"{name} launched {launches[name]} times, expected {3 * nsteps}")
    for name in ("bicgstab_solve3", "stencil7_apply"):
        check(launches[name] == 0, f"the 2-D path launched the 3-D kernel {name}")
    check(bool(s.series.krylov_converged.all()), "N=256: a solve did not converge")

    runs = steady_in_turns({"jvp": (trial, err)}, dt)["jvp"]
    steady = min(runs)
    log(f"[f64] N=256 steady wall-clock {steady:.6f} s (one run after the gate's)")
    return launches, steady, err, s.series.krylov_iters.tolist()


def steady_in_turns(routes, dt, repeats=1, cold=()):
    """``repeats`` timed runs of each ``{name: (trial, error[, run
    kwargs])}``, taken in turns (a, b, c, a, b, c, ...) so that drift of the
    host falls on all alike; each run must repeat its error.  Each route has
    run once for its gate, its warm-up; those in ``cold`` have not, and run
    once more first."""
    import torch

    routes = {name: (r + ({},))[:3] for name, r in routes.items()}
    for name in cold:
        trial, _, run_kw = routes[name]
        trial.run_for_errors(Tf=TF, dt=dt, **run_kw)
    runs = {name: [] for name in routes}
    for _ in range(repeats):
        for name, (trial, err, run_kw) in routes.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = trial.run_for_errors(Tf=TF, dt=dt, **run_kw)
            runs[name].append(time.perf_counter() - t0)
            check(s.overall_combined_error == err, f"repeat {name} run changed the error")
    return runs


def phase_analytic(device, jvp_iters=None):
    """The pol study with analytic couplings: the ladder and the main level
    through K4 (one launch a step), the main level through three K1 solves a
    step (``fused_triple=False``) and in float32; the level is held to the
    jvp route's value, which the ``slice`` phase holds to CPU-x64 and bit
    for bit to ``N256_F64_PORT``, and K4 to its plain version in ``k4``.
    ``jvp_iters``: the per-step Krylov iterations of the jvp route's main
    level (run here when not given)."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    for N, ref in POL_ANALYTIC_CPU_X64.items():
        _, _, s = run_level(N, torch.float64, device, coupling_source="analytic")
        err = s.overall_combined_error
        rel = abs(err - ref) / ref
        log(f"[analytic] N={N}: error {err!r}, vs CPU-x64 {ref!r} rel {rel:.3e}")
        check(math.isfinite(err) and rel <= 1e-8, f"analytic N={N} off the CPU-x64 value")
        check(bool(s.series.krylov_converged.all()), f"analytic N={N}: a solve did not converge")

    if jvp_iters is None:
        _, _, s_jvp = run_level(MAIN_N, torch.float64, device)
        jvp_iters = s_jvp.series.krylov_iters.tolist()

    # the main path of this route: counts set to 0 just before, read just after
    trial, dt = make_trial(MAIN_N, torch.float64, device, coupling_source="analytic")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s = trial.run_for_errors(Tf=TF, dt=dt)
    steady = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    err = s.overall_combined_error
    nsteps = len(s.series.krylov_iters)
    rel = abs(err - N256_F64_PORT) / N256_F64_PORT
    iters = s.series.krylov_iters.tolist()
    log(f"[analytic] N=256 fused: error {err!r}, vs the jvp route's {N256_F64_PORT!r} rel "
        f"{rel:.3e} (limit 1e-8); steps {nsteps}; launches {launches}; Krylov iterations "
        f"{sum(iters)} (per step {iters})")
    check(math.isfinite(err) and rel <= 1e-8, "analytic N=256 off the jvp route's value")
    check(nsteps == 41, "N=256 should take 41 steps")
    check(launches["triple_solve"] == nsteps,
          f"triple_solve launched {launches['triple_solve']} times, expected {nsteps}")
    for name in ("bicgstab_solve", "stencil5_apply", "bicgstab_solve3", "stencil7_apply"):
        check(launches[name] == 0, f"the fused analytic path launched {name}")
    check(bool(s.series.krylov_converged.all()), "analytic N=256: a solve did not converge")
    check(iters == jvp_iters, "analytic N=256: per-step Krylov iterations differ from the jvp route")

    # the same level with three separate solves a step
    trial_ps, _ = make_trial(MAIN_N, torch.float64, device,
                             coupling_source="analytic", fused_triple=False)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s_ps = trial_ps.run_for_errors(Tf=TF, dt=dt)
    steady_ps = time.perf_counter() - t0
    launches_ps = dict(kernels.LAUNCHES)
    err_ps = s_ps.overall_combined_error
    rel_ps = abs(err_ps - err) / err
    log(f"[analytic] N=256 per-solve: error {err_ps!r}, vs fused rel {rel_ps:.3e} (limit 1e-9); "
        f"launches {launches_ps}")
    check(rel_ps <= 1e-9, "analytic N=256: per-solve and fused routes disagree")
    check(launches_ps["bicgstab_solve"] == 3 * nsteps and launches_ps["triple_solve"] == 0,
          "analytic per-solve route: expected 3 K1 launches a step and no K4")
    check(bool(s_ps.series.krylov_converged.all()), "analytic per-solve: a solve did not converge")

    log(f"[analytic] N=256 wall-clock of the gated runs (kernels warm): fused {steady:.6f} s, "
        f"per-solve {steady_ps:.6f} s")

    # float32, fused
    kernels.reset_launch_counts()
    _, _, s32 = run_level(MAIN_N, torch.float32, device, coupling_source="analytic")
    err32 = s32.overall_combined_error
    rel32 = abs(err32 - N256_F32) / N256_F32
    log(f"[analytic] N=256 f32 fused: error {err32!r}, vs {N256_F32:g} rel {rel32:.3e}; "
        f"triple_solve launches {kernels.LAUNCHES['triple_solve']}; converged "
        f"{bool(s32.series.krylov_converged.all())}")
    check(math.isfinite(err32) and rel32 <= 1e-2, "analytic N=256 f32 off its error floor")
    check(kernels.LAUNCHES["triple_solve"] == nsteps, "analytic f32: expected one K4 launch a step")
    return launches, steady, err, steady_ps


def phase_scale(device):
    """The large-grid level (studies/scale_probe.py's protocol): pol, N=1024,
    dt = 0.25/N, 5 steps, default jvp couplings, float64 and float32 on the
    card, each held against the CPU plain versions of the same level."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    N, dt = SCALE_N, 0.25 / SCALE_N
    Tf = SCALE_STEPS * dt
    out = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype)[6:]
        trial, _ = make_trial(N, dtype, device, dt=dt)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        s = trial.run_for_errors(Tf=Tf, dt=dt)
        cold = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        s2 = trial.run_for_errors(Tf=Tf, dt=dt)
        steady = time.perf_counter() - t0
        nsteps = len(s.series.krylov_iters)
        err = s.overall_combined_error
        log(f"[scale] {name} N={N}: error {err!r}; steps {nsteps}; budget "
            f"{trial.integrator.solver.iters}; launches {launches}; Krylov iterations per step "
            f"{s.series.krylov_iters.tolist()}; wall first {cold:.3f} s, second {steady:.3f} s "
            f"({1e3 * steady / nsteps:.1f} ms a step); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(math.isfinite(err), f"scale {name}: error not finite")
        check(s2.overall_combined_error == err, f"scale {name}: repeat run changed the error")
        check(nsteps == SCALE_STEPS, f"scale: expected {SCALE_STEPS} steps, took {nsteps}")
        check(bool(s.series.krylov_converged.all()), f"scale {name}: a solve did not converge")
        for k in ("bicgstab_solve", "stencil5_apply"):
            check(launches[k] == 3 * nsteps,
                  f"scale {name}: {k} launched {launches[k]} times, expected {3 * nsteps}")
        for k in ("triple_solve", "bicgstab_solve3", "stencil7_apply"):
            check(launches[k] == 0, f"scale {name}: launched {k}")
        out[name] = (err, launches, steady)
        del trial, s, s2
        torch.cuda.empty_cache()

    trial, _ = make_trial(N, torch.float64, device, dt=dt)
    wall, found = profile_device(lambda: trial.run_for_errors(Tf=Tf, dt=dt))
    busy_us = sum(us for _, us in found.values())
    n_launch = sum(c for c, _ in found.values())
    log(f"[scale] {SCALE_STEPS} steps of f64 N={N} under the profiler: wall {wall:.6f} s, device "
        f"busy {busy_us / 1e6:.6f} s ({100 * busy_us / 1e6 / wall:.2f} %), idle "
        f"{100 * (1 - busy_us / 1e6 / wall):.2f} %, {n_launch} kernel launches "
        f"({busy_us / max(n_launch, 1):.2f} us each on average)")
    for kname in ("bicgstab_kernel", "stencil5_apply_kernel"):
        hits = [(c, us) for k, (c, us) in found.items() if kname in k]
        if hits:
            log(f"[scale]   {kname}: {sum(c for c, _ in hits)} launches, "
                f"{sum(us for _, us in hits) / sum(c for c, _ in hits):.2f} us each on the device")
    del trial
    torch.cuda.empty_cache()

    # scale_probe's own gate: agreement between backends, here the card
    # against the CPU plain versions of the same level in the same dtype
    for dtype, limit in ((torch.float64, 1e-8), (torch.float32, 1e-2)):
        name = str(dtype)[6:]
        t0 = time.perf_counter()
        trial, _ = make_trial(N, dtype, "cpu", dt=dt)
        err_cpu = trial.run_for_errors(Tf=Tf, dt=dt).overall_combined_error
        rel = abs(out[name][0] - err_cpu) / err_cpu
        log(f"[scale] {name} N={N} on the CPU (plain versions): error {err_cpu!r} "
            f"({time.perf_counter() - t0:.1f} s); card vs CPU rel {rel:.3e} (limit {limit:g})")
        check(rel <= limit, f"scale {name}: the card and the CPU disagree")
    return out["float64"][1], out["float64"][2], out["float64"][0]


# ---------------------------------------------------------------------------
# the golden-parity family: ExpSin, the Cs/HCs/forward-Euler variants, 3-D
# ---------------------------------------------------------------------------
def study_model():
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import STUDY_MODEL_CONSTS

    return Model02(STUDY_MODEL_CONSTS)


def make_expsin_trial(N: int, dtype, device, **integrator_kw):
    """The ExpSin notebook's spatial level N (cell 9): RegHCs, eta = 50,
    Tf = 0.01, dt = h^1.5, the study constants and the budget
    ``choose_krylov_unroll`` gives them."""
    from na_dd_tpu_torch.core import FieldRegHCsTriple, MMSForcingRegHCsTriple
    from na_dd_tpu_torch.harness.studies import choose_krylov_unroll
    from na_dd_tpu_torch.harness.trial import MMSTrial
    from na_dd_tpu_torch.integrators import PCTrapezoidalRegHCsTriple
    from na_dd_tpu_torch.mms.cases import MMSCaseExpSin
    from na_dd_tpu_torch.models.consts import STUDY_MODEL_CONSTS
    from na_dd_tpu_torch.ops.grid import make_uniform_grid

    dt = (1.0 / N) ** 1.5
    trial = MMSTrial(
        make_uniform_grid(N, N, dtype=dtype, device=device), study_model(), MMSCaseExpSin,
        FieldRegHCsTriple, MMSForcingRegHCsTriple, PCTrapezoidalRegHCsTriple,
        forcing_terms_params=dict(regularization_factor=ETA),
        field_params=dict(regularization_factor=ETA),
        integrator_params=dict(
            regularization_factor=ETA, track_residuals=False,
            krylov_unroll=choose_krylov_unroll(N, dt, STUDY_MODEL_CONSTS), **integrator_kw,
        ),
    )
    return trial, dt


def expsin_main_level(device, route, **integrator_kw):
    """The ExpSin N=256 level through one route, launch counts set to 0 just
    before and read just after; held to the notebook and to CPU-x64."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    trial, dt = make_expsin_trial(MAIN_N, torch.float64, device, **integrator_kw)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s = trial.run_for_errors(Tf=TF, dt=dt)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    err = s.overall_combined_error
    nsteps = len(s.series.krylov_iters)
    rel = abs(err - EXPSIN_REFERENCE[MAIN_N]) / EXPSIN_REFERENCE[MAIN_N]
    rel_cpu = abs(err - EXPSIN_N256_CPU_X64) / EXPSIN_N256_CPU_X64
    iters = s.series.krylov_iters.tolist()
    log(f"[expsin] N={MAIN_N} {route}: error {err!r}, vs notebook {EXPSIN_REFERENCE[MAIN_N]!r} rel "
        f"{rel:.3e}, vs CPU-x64 {EXPSIN_N256_CPU_X64!r} rel {rel_cpu:.3e} (limits 1e-8); steps "
        f"{nsteps}; budget {trial.integrator.solver.iters}; launches {launches}; Krylov "
        f"iterations {sum(iters)} (per step {iters}); {wall:.6f} s (kernels warm)")
    check(math.isfinite(err) and rel <= PARITY_RTOL, f"ExpSin N=256 {route} off the notebook")
    check(rel_cpu <= PARITY_RTOL, f"ExpSin N=256 {route} off the CPU-x64 value")
    check(nsteps == 41, "ExpSin N=256 should take 41 steps")
    check(bool(s.series.krylov_converged.all()), f"ExpSin N=256 {route}: a solve did not converge")
    for name in ("bicgstab_solve3", "stencil7_apply"):
        check(launches[name] == 0, f"ExpSin N=256 {route} launched the 3-D kernel {name}")
    return trial, dt, err, launches, nsteps, wall


def phase_expsin(device):
    """The ExpSin notebook's N=256 level (cell 9) on the card, to the notebook
    at 1e-8 and to CPU-x64 (the ladder below it and its rate are the
    ``studies`` phase's CLI run); then through the fused analytic route (one
    K4 launch a step), each route's wall-clock that of its gated run (the
    kernels warm), and five jvp steps under the profiler."""
    trial, dt, err, launches, nsteps, wall = expsin_main_level(device, "jvp")
    for name in ("bicgstab_solve", "stencil5_apply"):
        check(launches[name] == 3 * nsteps,
              f"ExpSin N=256: {name} launched {launches[name]} times, expected {3 * nsteps}")
    check(launches["triple_solve"] == 0, "ExpSin N=256 jvp launched K4")

    trial_an, _, err_an, launches_an, _, wall_an = expsin_main_level(
        device, "analytic fused", coupling_source="analytic")
    check(launches_an["triple_solve"] == nsteps,
          f"ExpSin analytic: triple_solve launched {launches_an['triple_solve']} times, expected {nsteps}")
    for name in ("bicgstab_solve", "stencil5_apply"):
        check(launches_an[name] == 0, f"ExpSin analytic fused launched {name}")

    steps = 5
    wall, found = profile_device(lambda: trial.run_for_errors(Tf=steps * dt, dt=dt))
    busy_us = sum(us for _, us in found.values())
    n_launch = sum(c for c, _ in found.values())
    log(f"[expsin] {steps} steps of f64 N={MAIN_N} (jvp) under the profiler: wall {wall:.6f} s, device "
        f"busy {busy_us / 1e6:.6f} s ({100 * busy_us / 1e6 / wall:.2f} %), idle "
        f"{100 * (1 - busy_us / 1e6 / wall):.2f} %, {n_launch} kernel launches "
        f"({n_launch / steps:.0f} per step)")
    return {"jvp": (launches, wall, err), "analytic": (launches_an, wall_an, err_an)}


def run_golden(label, trial, golden, rtol, solves=True, **run_kw):
    """One golden of tests/test_parity_golden.py on the card, with the launch
    counts of its run."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s = trial.run_for_errors(**run_kw)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    err = s.overall_combined_error
    rel = abs(err - golden) / golden
    log(f"[golden] {label}: error {err!r}, vs golden {golden!r} rel {rel:.3e} (limit {rtol:g}); "
        f"{len(s.series.krylov_iters)} steps in {wall:.2f} s; launches {launches}")
    check(math.isfinite(err) and rel <= rtol, f"golden {label} missed")
    check(bool(s.series.krylov_converged.all()), f"golden {label}: a solve did not converge")
    if solves:
        check(launches.get("bicgstab_solve", 0) > 0, f"golden {label}: K1 was launched no time")
    else:
        check(not launches, f"golden {label}: a solve-free run launched {launches}")
    return s


def phase_golden(device):
    """Every case of tests/test_parity_golden.py through the port on the
    card, at that file's own goldens and tolerances."""
    from na_dd_tpu_torch.core import (
        FieldCsTriple, FieldHCsTriple, FieldRegHCsTriple, MMSForcingCsTriple,
        MMSForcingHCsTriple, MMSForcingRegHCsTriple,
    )
    from na_dd_tpu_torch.harness import MMSTrial, calculate_observed_rates
    from na_dd_tpu_torch.integrators import (
        ForwardEulerIntegrator, PCTrapezoidalCsTriple, PCTrapezoidalHCsTriple,
        PCTrapezoidalRegHCsTriple,
    )
    from na_dd_tpu_torch.mms import cases
    from na_dd_tpu_torch.ops.grid import make_grid, make_uniform_grid

    model = study_model()
    reg = dict(forcing_terms_params=dict(regularization_factor=ETA),
               field_params=dict(regularization_factor=ETA),
               integrator_params=dict(regularization_factor=ETA))

    def grid(N):
        return make_uniform_grid(N, N, device=device)

    errors = []
    for N, golden in GOLDEN_EXPSIN.items():
        trial = MMSTrial(grid(N), model, cases.MMSCaseExpSin, FieldRegHCsTriple,
                         MMSForcingRegHCsTriple, PCTrapezoidalRegHCsTriple, **reg)
        s = run_golden(f"RegHCs ExpSin N={N}", trial, golden, PARITY_RTOL,
                       Tf=0.01, dt=(1.0 / N) ** 1.5)
        errors.append(s.overall_combined_error)
    rate = calculate_observed_rates(errors)[-1][0]
    log(f"[golden] RegHCs ExpSin rate {rate!r} (the test's 2 ± 0.35)")
    check(abs(rate - 2.0) <= 0.35, "golden ExpSin ladder: rate off 2")

    for N, golden in GOLDEN_CSTRIPLE.items():
        trial = MMSTrial(grid(N), model, cases.MMSCaseExpSin, FieldCsTriple,
                         MMSForcingCsTriple, PCTrapezoidalCsTriple)
        run_golden(f"CsTriple ExpSin N={N}", trial, golden, PARITY_RTOL, Tf=0.01, dt=2e-3)

    trial = MMSTrial(grid(8), model, cases.MMSCaseCsZeroCrossing, FieldHCsTriple,
                     MMSForcingHCsTriple, PCTrapezoidalHCsTriple)
    run_golden("HCsTriple zero crossing N=8", trial, GOLDEN_HCS_ZERO_CROSSING, PARITY_RTOL,
               Tf=0.8, dt=1e-3)

    trial = MMSTrial(grid(8), model, cases.MMSCaseNonFullySmoothPol_cpcsH2_TclcdH3,
                     FieldRegHCsTriple, MMSForcingRegHCsTriple, PCTrapezoidalRegHCsTriple, **reg)
    run_golden("NFSP |.|^gamma N=8", trial, GOLDEN_NFSP, PARITY_RTOL, Tf=0.05, dt=1e-3)

    trial = MMSTrial(grid(8), model, cases.MMSCaseExpSin, FieldRegHCsTriple,
                     MMSForcingRegHCsTriple, ForwardEulerIntegrator,
                     forcing_terms_params=dict(regularization_factor=ETA),
                     field_params=dict(regularization_factor=ETA))
    s = run_golden("forward Euler ExpSin N=8", trial, GOLDEN_FE, PARITY_RTOL, solves=False,
                   Tf=0.005, dt=1e-4)
    for var, ref in GOLDEN_FE_PER_VAR.items():
        got = s.per_variable_sup_errors[var]
        rel = abs(got - ref) / ref
        log(f"[golden]   forward Euler {var}: {got!r} vs {ref!r} rel {rel:.3e} (limit 1e-7)")
        check(rel <= 1e-7, f"golden forward Euler {var} missed")

    families = (
        ("oscillating time", cases.make_MMSCasePolWithOscilatingTime_cls(ampl=0.8, speed=7.0), {},
         dict(Tf=0.05, dt=2e-3), 7.7323703261406674e-05),
        ("peaks Slow1e2", cases.MMSCaseSlowlyChangingPeaks_Slow1e2, {}, dict(Tf=0.02, dt=2e-3),
         1.0868065366384929e-05),
        ("stiff exp decay", cases.MMSCaseStiffExpDecay, dict(a_base=20.0),
         dict(Tf=0.05, dt=1e-3), 8.7727711888787948e-07),
    )
    for label, case_cls, case_params, run_kw, golden in families:
        trial = MMSTrial(grid(10), model, case_cls, FieldRegHCsTriple, MMSForcingRegHCsTriple,
                         PCTrapezoidalRegHCsTriple, mms_case_params=case_params, **reg)
        run_golden(f"{label} N=10", trial, golden, PARITY_RTOL, **run_kw)

    rng = np.random.RandomState(77)
    x = np.sort(np.concatenate([[0.0, 1.0], rng.rand(9)]))
    y = np.sort(np.concatenate([[0.0, 1.0], rng.rand(7)]))
    trial = MMSTrial(make_grid(x, y, device=device), model, cases.MMSCaseExpSin,
                     FieldRegHCsTriple, MMSForcingRegHCsTriple, PCTrapezoidalRegHCsTriple, **reg)
    run_golden("non-uniform grid (seed 77)", trial, GOLDEN_NONUNIFORM, 1e-7, Tf=0.01, dt=2e-3)


def phase_variants3(device):
    """The 3-D Cs and HCs variants on MMSCasePol3 (N=4..16, the 3-D study's
    Tf and dt) and the HCs and RegHCs runs through MMSCaseCsZeroCrossing3
    (cs_A = 0.005, Tf = 0.01, dt = 1e-3), each through K5/K6 on the card and
    held to the port's CPU plain run of the same level at 1e-10."""
    import torch

    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.three_d import (
        MMSCaseCsZeroCrossing3, MMSCasePol3, make_setup3, run_trial3,
    )
    from na_dd_tpu_torch.three_d.harness import KRYLOV_BUDGET3

    model = Model02(default_model_consts._replace(**THREE_D_CONSTS))
    runs = [(f"{v} Pol3 N={N}", v, MMSCasePol3, N, {}, dict(Tf=TF3, dt=dt3(N)))
            for v in ("cs", "hcs") for N in (4, 8, 16)]
    runs += [(f"{v} zero crossing3 N={N}", v, MMSCaseCsZeroCrossing3, N, dict(cs_A=0.005),
              dict(Tf=0.01, dt=1e-3)) for v in ("hcs", "reghcs") for N in (8, 16)]
    for label, variant, case_cls, N, case_params, run_kw in runs:
        out = {}
        for dev in (device, "cpu"):
            g, case, _, integ = make_setup3(
                case_cls, N=N, model=model, variant=variant, eta=ETA, case_params=case_params,
                integrator_params=dict(krylov_unroll=KRYLOV_BUDGET3, track_residuals=False),
                device=dev)
            if dev == device:
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
            out[dev] = run_trial3(g, case, integ, **run_kw)
            if dev == device:
                launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        card, cpu = out[device], out["cpu"]
        state_rel = max(rel_to_max(getattr(card["state"], v).cpu(), getattr(cpu["state"], v))
                        if getattr(cpu["state"], v).abs().max() > 0 else
                        float(getattr(card["state"], v).abs().max())
                        for v in ("cp", "T", "cl", "cd", "cs"))
        # an error at the rounding floor (the RegHCs zero crossing integrates
        # its solution to ~1e-20) is held by the state alone
        if cpu["error"] > 1e-12:
            err_ok = abs(card["error"] - cpu["error"]) <= 1e-10 * cpu["error"]
        else:
            err_ok = card["error"] <= 1e-12
        log(f"[variants3] {label}: error {card['error']!r}, CPU plain {cpu['error']!r}; final state "
            f"card vs CPU {state_rel:.3e} (limit 1e-10); launches {launches}")
        check(err_ok and state_rel <= 1e-10, f"3-D {label}: the card and the CPU disagree")
        check(card["krylov_converged"] and cpu["krylov_converged"],
              f"3-D {label}: a solve did not converge")
        check(launches.get("bicgstab_solve3", 0) > 0 and launches.get("stencil7_apply", 0) > 0,
              f"3-D {label}: K5/K6 were launched no time")
        check(not launches.get("bicgstab_solve") and not launches.get("triple_solve"),
              f"3-D {label} launched a 2-D kernel")


def phase_slice_f32(device):
    import torch

    _, _, s = run_level(MAIN_N, torch.float32, device)
    err = s.overall_combined_error
    rel = abs(err - N256_F32) / N256_F32
    log(f"[f32] N=256: error {err!r}, vs {N256_F32:g} rel {rel:.3e}; "
        f"Krylov iterations {int(s.series.krylov_iters.sum())}")
    check(math.isfinite(err) and rel <= 1e-2, "N=256 f32 off its error floor")
    return err


def time_ms(fn, reps: int) -> float:
    """Mean time per call by CUDA events around ``reps`` back-to-back calls
    (for a call made of small launches this includes its host cost)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def traced(fn):
    """Run ``fn`` once as a warm-up, then once under torch.profiler; return
    (wall_s, the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof


def device_kernels(prof):
    """{kernel name: (calls, device_us)} of a trace, read from the
    profiler's raw events: ``prof.events()`` builds the host operator tree
    too, at ~70 us an event, seconds for a traced run of tens of thousands
    of launches (``phase_profile`` holds this reader to it)."""
    kernels = {}
    for evt in prof.profiler.kineto_results.events():
        if (str(evt.device_type()).endswith("CUDA") and not evt.is_async()
                and evt.duration_ns() > 0):
            calls, us = kernels.get(evt.name(), (0, 0.0))
            kernels[evt.name()] = (calls + 1, us + evt.duration_ns() / 1e3)
    return kernels


def profile_device(fn):
    """Run ``fn`` under torch.profiler; return (wall_s, {kernel name:
    (calls, device_us)}) over the device kernels it launched."""
    wall, prof = traced(fn)
    return wall, device_kernels(prof)


def kernel_device_ms(fn, reps: int, name: str):
    """Mean device time of the CUDA kernel whose name contains ``name``: the
    profiler's, or, when the profiler reports no device time for it (it
    drops a session's device events now and then), by CUDA events around
    each of its launches (:func:`launch_event_ms`).  None when ``fn`` did
    not launch it."""
    _, found = profile_device(lambda: [fn() for _ in range(reps)])
    hits = [(c, us) for k, (c, us) in found.items() if name in k]
    if not hits:
        ms = launch_event_ms(fn, reps, name)
        log(f"[time] the profiler saw no device time for {name}; CUDA events around its "
            f"launches: {'none' if ms is None else f'{ms * 1e3:.2f} us'}")
        return ms
    calls = sum(c for c, _ in hits)
    return sum(us for _, us in hits) / calls / 1e3


# The ctypes launchers (na_dd_tpu_torch/ops/kernels.py's libraries, then the
# launcher's name less its _f64/_f32 suffix) of each kernel the profiler names.
LAUNCHERS = {
    "bicgstab_kernel": (("bicgstab", "bicgstab_solve"), ("bicgstab3", "bicgstab3_solve")),
    "stencil5_apply_kernel": (("stencil5", "stencil5_apply"),),
    "stencil7_apply_kernel": (("stencil7", "stencil7_apply"),),
    "triple_solve_kernel": (("triple_solve", "triple_solve"),),
}
SPIN_CYCLES = 200_000  # ~100 us at the H100's clock: longer than one launch's host cost


def launch_event_ms(fn, reps: int, name: str):
    """Mean device time of the kernel ``name`` over ``reps`` calls of ``fn``,
    by a pair of CUDA events recorded just before and just after each of its
    launches.  A spin kernel queued ahead of each start event keeps the
    stream busy while the host launches, so the pair holds the kernel alone.
    None when ``fn`` did not launch it."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    pairs, saved = [], []

    def timed(launch):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            code = launch(*args)
            end.record()
            pairs.append((start, end))
            return code
        return run

    for lib_name, prefix in LAUNCHERS[name]:
        lib = kernels._lib(lib_name)
        for attr in (f"{prefix}_f64", f"{prefix}_f32"):
            launch = getattr(lib, attr)
            saved.append((lib, attr, launch))
            setattr(lib, attr, timed(launch))
    try:
        fn()
        pairs.clear()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        for lib, attr, launch in saved:
            setattr(lib, attr, launch)
    if not pairs:
        return None
    return sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)


# Arrays a solve touches per pass sweep (csrc/bicgstab.cu, bicgstab3.cu):
# iteration 0 and each later iteration, planes (2-D) or volumes (3-D).
PASSES = {2: (27, 32), 3: (31, 36)}


def timings_k1_1025(device):
    """K1 at 1025 x 1025 on the step-1 T system of the large-grid level
    (pol N=1024, dt = 0.25/N).  float64."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    systems, solver = step1_systems(torch.float64, device, SCALE_N, 0.25 / SCALE_N)
    st, b, mask = systems[0]
    del systems
    inv = jacobi(st, mask)
    n, item, tol = b.numel(), b.element_size(), 1e-13
    err, iters = compare_solve(st, b, inv, mask, tol=tol, iters=solver.iters, xtol=1e-12,
                               label=f"f64 N={SCALE_N} step-1 T plane")

    def k1():
        return kernels.bicgstab_solve(st, b, inv, mask, tol=tol, iters=solver.iters)

    row = kernel_row(
        "bicgstab_solve", b.dtype, label=f"f64 {b.shape[0]}x{b.shape[1]} ({iters} iterations)",
        device_ms=kernel_device_ms(k1, 20, "bicgstab_kernel"), wrapper_ms=time_ms(k1, 50),
        plain_ms=time_ms(lambda: kernels.bicgstab_solve_plain(
            st, b, inv, mask, tol=tol, iters=solver.iters), 5),
        nbytes=9 * n * item, ops=(2 * 9 + 6 * 2 + 14) * n * max(iters, 1))
    row["max_abs_err"] = err
    return row


def phase_timings(device):
    import torch

    from na_dd_tpu_torch.ops import kernels

    systems, solver = step1_systems(torch.float64, device)
    st, b, mask = systems[0]  # the T system of step 1, f64 257x257
    inv = jacobi(st, mask)
    n = b.numel()
    item = b.element_size()
    tol = 1e-13
    iters = int(kernels.bicgstab_solve(st, b, inv, mask, tol=tol, iters=solver.iters)[1]["iters"])

    def k1():
        return kernels.bicgstab_solve(st, b, inv, mask, tol=tol, iters=solver.iters)

    def k2():
        return kernels.stencil5_apply(st, b)

    label = f"f64 {b.shape[0]}x{b.shape[1]}"
    res = {
        # reads u and 5 planes, writes out; 9 operations per point
        "stencil5_apply": kernel_row(
            "stencil5_apply", b.dtype, label=label,
            device_ms=kernel_device_ms(k2, 200, "stencil5_apply_kernel"),
            wrapper_ms=time_ms(k2, 2000),
            plain_ms=time_ms(lambda: kernels.stencil5_apply_plain(st, b), 500),
            nbytes=7 * n * item, ops=9 * n),
        # reads b, 5 planes, inv_diag, mask; writes x (the true-residual
        # apply is K2's, counted there).  Per iteration taken: two applies
        # (9 each), six dots (2 each), the p/s/x/r updates and the two
        # Jacobi scalings (~14).
        "bicgstab_solve": kernel_row(
            "bicgstab_solve", b.dtype, label=label,
            device_ms=kernel_device_ms(k1, 100, "bicgstab_kernel"),
            wrapper_ms=time_ms(k1, 500),
            plain_ms=time_ms(lambda: kernels.bicgstab_solve_plain(
                st, b, inv, mask, tol=tol, iters=solver.iters), 50),
            nbytes=9 * n * item, ops=(2 * 9 + 6 * 2 + 14) * n * max(iters, 1)),
    }
    log(f"[time] bicgstab_solve iterations in the timed solve: {iters}; cooperative grid "
        f"{kernels._BLOCKS.get(('bicgstab', b.dtype, n))} blocks of 256 threads")
    first, later = PASSES[2]
    passes = (first + later * (max(iters, 1) - 1)) * n * item
    log(f"[time] bicgstab_solve: {iters} iterations touch {first} + {later} x {max(iters, 1) - 1} "
        f"planes = {passes / 1e6:.2f} MB, {passes / HBM_BYTES_PER_S * 1e6:.2f} us at the HBM "
        f"rate; measured {res['bicgstab_solve']['ms'] * 1e3:.2f} us")
    # the timing kernel_device_ms falls back to, held against the profiler's
    for name, fn, row in (("bicgstab_kernel", k1, "bicgstab_solve"),
                          ("stencil5_apply_kernel", k2, "stencil5_apply")):
        ms = launch_event_ms(fn, 100, name)
        check(ms is not None and ms > 0, f"CUDA events saw no launch of {name}")
        log(f"[time] {name} {label} by CUDA events around its launches: {ms * 1e3:.2f} us "
            f"(its timing row's {res[row]['ms'] * 1e3:.2f} us)")
    del systems, st, b, mask, inv
    res["bicgstab_solve_1025"] = timings_k1_1025(device)
    torch.cuda.empty_cache()
    res.update(timings_k4_k3(device))
    return res


def per_solve_route(operands, *, tol, iters):
    """What K4 computes, the way the integrator's per-solve route does it:
    three K1 wrapper calls with the coupling planes applied between them by
    plain tensor operations."""
    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.ops.shifts import LOCAL_OPS

    (J_T, J_cl, J_cd, C_clT, C_cdT, d_cdcl, rhs_T, base_cl, base_cd,
     invd_T, invd_cl, invd_cd, mask, dt) = operands
    dT, _ = kernels.bicgstab_solve(J_T, rhs_T * mask, invd_T, mask, tol=tol, iters=iters)
    rhs_cl = (base_cl + dt * C_clT.apply(LOCAL_OPS, dT)) * mask
    dcl, _ = kernels.bicgstab_solve(J_cl, rhs_cl, invd_cl, mask, tol=tol, iters=iters)
    rhs_cd = (base_cd + dt * (C_cdT.apply(LOCAL_OPS, dT) + d_cdcl * dcl)) * mask
    dcd, _ = kernels.bicgstab_solve(J_cd, rhs_cd, invd_cd, mask, tol=tol, iters=iters)
    return dT, dcl, dcd


def cast_triple(operands, dtype):
    """K4's operands in another dtype."""
    return tuple(
        type(o)(*(c.to(dtype) for c in o)) if isinstance(o, tuple)
        else (o.to(dtype) if hasattr(o, "to") else o)
        for o in operands)


def timings_k4_k3(device):
    """K4 on the step-1 systems of the N=256 level and on random systems at
    1025 x 1025, each beside the per-solve route on the same operands; K3 (the
    5-point apply) at 1025 x 1025.  float64."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    tol = 1e-13
    res = {}
    step1, solver = step1_triple(torch.float64, device)
    big = random_triple(np.random.default_rng(44), (SCALE_N + 1, SCALE_N + 1), torch.float64, device)
    for key, operands, budget, reps in (("triple_solve", step1, solver.iters, 20),
                                        ("triple_solve_1025", big, 40, 1)):
        rhs_T = operands[6]
        n, item = rhs_T.numel(), rhs_T.element_size()
        its = kernels.triple_solve(*operands, tol=tol, iters=budget)[3]["iters"].tolist()
        fused = per_solve_route(operands, tol=tol, iters=budget)
        k4_out = kernels.triple_solve(*operands, tol=tol, iters=budget)[:3]
        check(max(rel_to_max(a, b) for a, b in zip(k4_out, fused)) <= 1e-10,
              "the per-solve route and K4 disagree on the timed operands")

        def k4():
            return kernels.triple_solve(*operands, tol=tol, iters=budget)

        label = f"f64 {rhs_T.shape[0]}x{rhs_T.shape[1]} (iterations {its})"
        # reads 33 planes, writes 3.  Per iteration taken as K1 (44 operations
        # a point); the two coupling applies (9 each), the diagonal term and
        # the three rhs forms (~3 each).
        res[key] = kernel_row(
            "triple_solve", rhs_T.dtype, label=label,
            device_ms=kernel_device_ms(k4, 5 * reps, "triple_solve_kernel"),
            wrapper_ms=time_ms(k4, 10 * reps),
            plain_ms=time_ms(lambda: kernels.triple_solve_plain(
                *operands, tol=tol, iters=budget), 2),
            nbytes=36 * n * item, ops=(44 * max(sum(its), 1) + 29) * n)
        route_ms = time_ms(lambda: per_solve_route(operands, tol=tol, iters=budget), 10 * reps)
        res[key]["per_solve_route_ms"] = route_ms
        blocks = kernels._BLOCKS.get(("triple_solve", rhs_T.dtype, n))
        log(f"[time] triple_solve {label}: the per-solve route (3 K1 calls, 3 residual applies, "
            f"the couplings as tensor operations) {route_ms * 1e3:.2f} us a call by CUDA events, "
            f"{route_ms / res[key]['wrapper_ms']:.2f}x the K4 wrapper call; cooperative grid "
            f"{blocks} blocks of 256 threads; {res[key]['ms'] * 1e3 / max(sum(its), 1):.2f} us "
            "an iteration")
    del big, step1, operands, fused, k4_out

    st, u = random_planes(np.random.default_rng(33), (SCALE_N + 1, SCALE_N + 1), torch.float64,
                          device, dominant=False)

    def k3():
        return kernels.stencil5_apply(st, u)

    res["stencil5_apply_1025"] = kernel_row(
        "stencil5_apply", u.dtype, label=f"f64 {u.shape[0]}x{u.shape[1]}",
        device_ms=kernel_device_ms(k3, 100, "stencil5_apply_kernel"),
        wrapper_ms=time_ms(k3, 500),
        plain_ms=time_ms(lambda: kernels.stencil5_apply_plain(st, u), 100),
        nbytes=7 * u.numel() * u.element_size(), ops=9 * u.numel())
    st32 = type(st)(*(c.float() for c in st))
    u32 = u.float()
    ms32 = kernel_device_ms(lambda: kernels.stencil5_apply(st32, u32), 100, "stencil5_apply_kernel")
    if ms32 is not None:
        log(f"[time] stencil5_apply f32 1025x1025: kernel (device) {ms32 * 1e3:.2f} us, bound "
            f"{7 * u32.numel() * 4 / HBM_BYTES_PER_S * 1e6:.3f} us (bytes)")
    return res


def phase_profile(device):
    """Where a main-level step's time goes: 5 steps of the f64 N=256 level
    under torch.profiler — device busy share and the busiest kernels; and
    the script's trace reader (:func:`device_kernels`) held to
    ``prof.events()`` on one step."""
    import torch

    trial, dt = make_trial(MAIN_N, torch.float64, device)
    steps = 5
    wall, found = profile_device(lambda: trial.run_for_errors(Tf=steps * dt, dt=dt))
    busy_us = sum(us for _, us in found.values())
    launches = sum(c for c, _ in found.values())
    log(f"[profile] {steps} steps of f64 N=256: wall {wall:.6f} s, device busy "
        f"{busy_us / 1e6:.6f} s ({100 * busy_us / 1e6 / wall:.2f} %), idle "
        f"{100 * (1 - busy_us / 1e6 / wall):.2f} %, {launches} kernel launches "
        f"({launches / steps:.0f} per step, {busy_us / max(launches, 1):.2f} us each on average)")
    top = sorted(found.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (calls, us) in top:
        log(f"[profile]   {us / 1e3:9.3f} ms in {calls:6d} calls: {name[:90]}")

    # the raw reader held to the profiler's own event list, on a one-step trace
    _, prof = traced(lambda: trial.run_for_errors(Tf=dt, dt=dt))
    t0 = time.perf_counter()
    raw = device_kernels(prof)
    t_raw = time.perf_counter() - t0
    t0 = time.perf_counter()
    listed = {}
    for evt in prof.events():
        if str(evt.device_type).endswith("CUDA") and evt.device_time_total > 0:
            calls, us = listed.get(evt.name, (0, 0.0))
            listed[evt.name] = (calls + 1, us + evt.device_time_total)
    t_listed = time.perf_counter() - t0
    busy_raw = sum(us for _, us in raw.values())
    busy_listed = sum(us for _, us in listed.values())
    log(f"[profile] one step read raw: {sum(c for c, _ in raw.values())} kernel launches, "
        f"{busy_raw:.3f} us busy, in {t_raw:.3f} s; by prof.events(): "
        f"{sum(c for c, _ in listed.values())} launches, {busy_listed:.3f} us, in {t_listed:.3f} s")
    check({k: c for k, (c, _) in raw.items()} == {k: c for k, (c, _) in listed.items()}
          and abs(busy_raw - busy_listed) <= 1e-9 * busy_listed,
          "the raw trace reader disagrees with prof.events()")

    from na_dd_tpu_torch.harness.trial import _collect_errors

    g, ops, s0 = trial.grid, trial.ops, trial.initial_state
    t0 = torch.zeros((), dtype=torch.float64, device=device)
    step_launches, breakdown = step_launch_breakdown(
        lambda: trial.integrator.step_fn(g, ops, s0, t0, dt), trial.forcing_terms, g, ops, t0)
    collect = launches_of(lambda: _collect_errors(
        g, ops, trial.mms_case, s0, t0, trial.variable_names, trial.integral_vars))
    log(f"[profile] one step_fn: {step_launches} launches; {breakdown}"
        f"; one error collection: {collect} launches")
    for label, kw in (("fused", {}), ("per-solve", {"fused_triple": False})):
        trial_an, _ = make_trial(MAIN_N, torch.float64, device, coupling_source="analytic", **kw)
        n_an = launches_of(lambda: trial_an.integrator.step_fn(g, ops, s0, t0, dt))
        log(f"[profile] one step_fn with analytic couplings, {label}: {n_an} launches")


def launches_of(fn) -> int:
    return sum(c for c, _ in profile_device(fn)[1].values())


def step_launch_breakdown(step, forcing, g, ops, t0):
    """Where one step's launches come from: the launches of ``step()``, and
    how many of them the MMS forcing terms make (calls of each term in one
    step times the launches of one call)."""
    terms = ("fcp", "fT", "fcl", "fcd", "fcs")
    per_call = {k: launches_of(lambda k=k: getattr(forcing, k)(g, ops, t0)) for k in terms}
    calls = dict.fromkeys(terms, 0)

    def counting(term, fn):
        def wrapped(*args):
            calls[term] += 1
            return fn(*args)
        return wrapped

    for k in terms:
        setattr(forcing, k, counting(k, getattr(forcing, k)))
    step()
    for k in terms:
        delattr(forcing, k)
    step_launches = launches_of(step)
    in_forcing = sum(calls[k] * per_call[k] for k in terms)
    text = (f"forcing terms {in_forcing} of them ({100 * in_forcing / max(step_launches, 1):.1f} %) "
            "from calls " + ", ".join(f"{k} {calls[k]}x{per_call[k]}" for k in terms))
    return step_launches, text


# ---------------------------------------------------------------------------
# the 3-D path
# ---------------------------------------------------------------------------
def dt3(N: int) -> float:
    return 1e-2 / (N // 4)


def make_trial3(N: int, dtype, device, **integrator_kw):
    """The three_d_study level N through the user entry point make_setup3;
    ``integrator_kw`` (precision, ...) goes to the integrator."""
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.three_d.harness import KRYLOV_BUDGET3, make_setup3
    from na_dd_tpu_torch.three_d.mms import MMSCaseExpSin3

    model = Model02(default_model_consts._replace(**THREE_D_CONSTS))
    params = dict(num_newton_steps=2, krylov_unroll=KRYLOV_BUDGET3, track_residuals=False)
    g, case, _field, integ = make_setup3(
        MMSCaseExpSin3, N=N, model=model, eta=ETA, integrator_params={**params, **integrator_kw},
        dtype=dtype, device=device,
    )
    return g, case, integ


class IterTally:
    """Solver backend that keeps each solve's iteration count (on the
    device) for the log."""

    def __init__(self, inner):
        self.inner = inner
        self.iters = []

    def solve(self, st, rhs, mask, *noise_sq):
        x, info = self.inner.solve(st, rhs, mask, *noise_sq)
        self.iters.append(info["iters"])
        return x, info

    def summary(self) -> str:
        import torch

        its = torch.stack([torch.as_tensor(i).reshape(()) for i in self.iters]).cpu().tolist()
        return f"{len(its)} solves, {sum(its)} Krylov iterations (max {max(its)} a solve)"


def run_level3(N, dtype, device, dt=None):
    from na_dd_tpu_torch.three_d.harness import run_trial3

    g, case, integ = make_trial3(N, dtype, device)
    tally = integ.solver = IterTally(integ.solver)
    r = run_trial3(g, case, integ, Tf=TF3, dt=dt3(N) if dt is None else dt)
    return r, tally


def step1_systems3(N, dtype, device):
    """The six Newton systems (two sweeps of T, cl, cd) of step 1 of the
    3-D level N."""
    import torch

    from na_dd_tpu_torch.three_d.mms import state_from_mms_when3
    from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

    g, case, integ = make_trial3(N, dtype, device)
    rec = integ.solver = RecordingSolver(integ.solver)
    s0 = state_from_mms_when3(mms_case=case, t=0.0, grid=g)
    integ.step_fn(g, LOCAL_OPS3, s0, torch.zeros((), dtype=dtype, device=device), dt3(N))
    check(len(rec.systems) == 6, "a 3-D step should make six Newton solves")
    return rec.systems, rec.inner


def phase_k6(device):
    import torch

    from na_dd_tpu_torch.ops import kernels

    rng = np.random.default_rng(6)
    worst = {}
    for dtype, tol in ((torch.float64, 1e-14), (torch.float32, 1e-6)):
        for shape in ((33, 33, 33), (65, 65, 65), (129, 129, 129), (50, 65, 33)):
            st, u = random_planes(rng, shape, dtype, device, dominant=False)
            k = kernels.stencil7_apply(st, u)
            p = kernels.stencil7_apply_plain(st, u)
            torch.cuda.synchronize()
            rel = rel_to_max(k, p)
            log(f"[k6] {str(dtype)[6:]} {shape}: max rel diff {rel:.3e} (limit {tol:g}), "
                f"max abs {float((k - p).abs().max()):.3e}")
            check(bool(torch.isfinite(k).all()), "K6 output not finite")
            check(rel <= tol, f"K6 {dtype} {shape} disagrees with its plain version")
            worst[(dtype, shape)] = float((k - p).abs().max())
    return worst[(torch.float64, (65, 65, 65))]


def phase_k5(device):
    import torch

    from na_dd_tpu_torch.integrators.pc_trapezoidal import default_krylov_tol
    from na_dd_tpu_torch.three_d.grid import make_uniform_grid3

    rng = np.random.default_rng(5)
    for dtype, xtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        mask = make_uniform_grid3(64, 64, 64, dtype=dtype, device=device).interior_mask
        st, b = random_planes(rng, (65, 65, 65), dtype, device, dominant=True)
        st = type(st)(*(c * mask for c in st))
        compare_solve(st, b * mask, jacobi(st, mask), mask,
                      tol=default_krylov_tol(dtype), iters=24, xtol=xtol,
                      label=f"{str(dtype)[6:]} random dominant 65^3")
    solve_edge_cases(device, (("zero rhs", (65, 65, 65)), ("diagonal", (65, 65, 65)),
                              ("dominant", (5, 5, 5)), ("dominant", (33, 20, 41))))
    main_err = 0.0
    for dtype, xtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        systems, solver = step1_systems3(MAIN_N3, dtype, device)
        for name, (st, b, mask) in zip(("T", "cl", "cd"), systems[:3]):
            err, _ = compare_solve(st, b, jacobi(st, mask), mask,
                                   tol=default_krylov_tol(dtype), iters=solver.iters,
                                   xtol=xtol, label=f"{str(dtype)[6:]} N={MAIN_N3} step-1 {name} volume")
            if dtype == torch.float64:
                main_err = max(err, main_err)
    return main_err


def phase_three_d_f64(device):
    """The 3-D study's N=64 level (the ladder N=4..16 below it is the
    ``drivers`` phase's 3-D study run, each level held to CPU-x64 there; N=32
    is the ``direct3`` phase's Krylov run)."""
    import torch

    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.three_d.harness import run_trial3

    # the 3-D main path: counts set to 0 just before, read just after
    N, dt = MAIN_N3, dt3(MAIN_N3)
    g, case, integ = make_trial3(N, torch.float64, device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    r = run_trial3(g, case, integ, Tf=TF3, dt=dt)
    launches = dict(kernels.LAUNCHES)
    err = r["error"]
    nsteps = round(TF3 / dt)
    ref = THREE_D_CPU_X64[N]
    rel = abs(err - ref) / ref
    log(f"[3d f64] N={N}: error {err!r}, vs CPU-x64 {ref!r} rel {rel:.3e}; steps {nsteps}; "
        f"launches {launches}")
    check(math.isfinite(err) and rel <= 1e-8, f"3-D N={N} off the CPU-x64 value")
    check(r["krylov_converged"], f"3-D N={N}: a solve did not converge")
    for name in ("bicgstab_solve3", "stencil7_apply"):
        check(launches[name] == 6 * nsteps,
              f"{name} launched {launches[name]} times, expected {6 * nsteps}")
    for name in ("bicgstab_solve", "stencil5_apply"):
        check(launches[name] == 0, f"the 3-D path launched the 2-D kernel {name}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r2 = run_trial3(g, case, integ, Tf=TF3, dt=dt)
    steady = time.perf_counter() - t0
    check(r2["error"] == err, "repeat 3-D run changed the error")
    log(f"[3d f64] N={N} steady wall-clock {steady:.6f} s (one run after the gate's; "
        f"{1e3 * steady / nsteps:.3f} ms a step)")
    return launches, steady, err


def phase_three_d_n128(device, err64):
    import torch

    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.three_d.harness import run_trial3

    N, dt = N128, DT128
    g, case, integ = make_trial3(N, torch.float64, device)
    tally = integ.solver = IterTally(integ.solver)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    r = run_trial3(g, case, integ, Tf=TF3, dt=dt)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    err = r["error"]
    nsteps = round(TF3 / dt)
    rate = math.log2(err64 / err)
    log(f"[3d f64] N={N}: error {err!r}, rate log2(err{MAIN_N3}/err{N}) {rate:.6f}; steps {nsteps}; "
        f"wall {wall:.3f} s (one run, cold); launches {launches}; {tally.summary()}; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(math.isfinite(err) and abs(rate - 2.0) <= 0.05, f"3-D N={N}: rate not 2 +- 0.05")
    check(r["krylov_converged"], f"3-D N={N}: a solve did not converge")
    for name in ("bicgstab_solve3", "stencil7_apply"):
        check(launches[name] == 6 * nsteps,
              f"N={N}: {name} launched {launches[name]} times, expected {6 * nsteps}")
    return err


def phase_three_d_f32(device):
    import torch

    N = 32
    r, tally = run_level3(N, torch.float32, device)
    err = r["error"]
    rel_tpu = abs(err - THREE_D_TPU_F32_N32) / THREE_D_TPU_F32_N32
    rel_x64 = abs(err - THREE_D_CPU_X64[N]) / THREE_D_CPU_X64[N]
    # The TPU's f32 value is reported, not gated: it sits 8.4 % above the f64
    # CPU-x64 error, the port's f32 (card and CPU plain versions alike) 0.6 %
    # above it; the excess is platform rounding noise (PERF.md, Findings).
    # The gate holds f32 to 1e-2 of the exact-arithmetic error of the level.
    log(f"[3d f32] N=32: error {err!r}; vs the TPU f32 value {THREE_D_TPU_F32_N32!r} rel "
        f"{rel_tpu:.3e} ({'within' if rel_tpu <= 1e-2 else 'MISSES'} 1e-2); vs the f64 "
        f"CPU-x64 value {THREE_D_CPU_X64[N]!r} rel {rel_x64:.3e} (limit 1e-2); converged "
        f"{r['krylov_converged']}; {tally.summary()}")
    check(math.isfinite(err) and rel_x64 <= 1e-2, "3-D f32 N=32 off the CPU-x64 error")
    check(r["krylov_converged"], "3-D f32 N=32: a solve did not converge")
    return err


def kernel_row(name, dtype, *, device_ms, wrapper_ms, plain_ms, nbytes, ops, label):
    """One kernel's timing row: kernel time (its device time by
    :func:`kernel_device_ms`, else the wrapper call by CUDA events) beside the
    bound (bytes over the HBM rate or operations over the peak rate)."""
    row = dict(device_ms=device_ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms,
               bytes=nbytes, ops=ops)
    row["ms"] = device_ms if device_ms is not None else wrapper_ms
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[str(dtype)[6:]] * 1e3
    row["bound_ms"] = max(t_bytes, t_ops)
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    log(f"[time] {name} {label}: kernel (device) {row['ms'] * 1e3:.2f} us, wrapper call "
        f"{wrapper_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
        f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']}, {nbytes / 1e6:.2f} MB)")
    return row


def phase_timings3(device):
    """K5 and K6/K7 at N=64 and N=128 on the step-1 T system of each level."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    res = {}
    for N, reps in ((MAIN_N3, 1), (N128, 4)):
        systems, solver = step1_systems3(N, torch.float64, device)
        st, b, mask = systems[0]
        del systems
        inv = jacobi(st, mask)
        n = b.numel()
        item = b.element_size()
        tol = 1e-13
        iters = int(kernels.bicgstab_solve3(st, b, inv, mask, tol=tol, iters=solver.iters)[1]["iters"])

        def k5():
            return kernels.bicgstab_solve3(st, b, inv, mask, tol=tol, iters=solver.iters)

        def k6():
            return kernels.stencil7_apply(st, b)

        label = f"f64 {N + 1}^3"
        res[N] = {
            # reads u and 7 volumes, writes out; 13 operations a point
            "stencil7_apply": kernel_row(
                "stencil7_apply", b.dtype, label=label,
                device_ms=kernel_device_ms(k6, 200 // reps, "stencil7_apply_kernel"),
                wrapper_ms=time_ms(k6, 1000 // reps),
                plain_ms=time_ms(lambda: kernels.stencil7_apply_plain(st, b), 200 // reps),
                nbytes=9 * n * item, ops=13 * n),
            # reads b, 7 volumes, inv_diag, mask; writes x (the true-residual
            # apply is K6's, counted there).  Per iteration taken: two applies
            # (13 each), six dots (2 each), the updates and scalings (~14).
            "bicgstab_solve3": kernel_row(
                "bicgstab_solve3", b.dtype, label=f"{label} ({iters} iterations)",
                device_ms=kernel_device_ms(k5, 50 // reps, "bicgstab_kernel"),
                wrapper_ms=time_ms(k5, 200 // reps),
                plain_ms=time_ms(lambda: kernels.bicgstab_solve3_plain(
                    st, b, inv, mask, tol=tol, iters=solver.iters), 20 // reps),
                nbytes=11 * n * item, ops=(2 * 13 + 6 * 2 + 14) * n * max(iters, 1)),
        }
        # the per-iteration cost on a system that takes many iterations
        st_r, b_r = random_planes(np.random.default_rng(N), tuple(b.shape), b.dtype, device,
                                  dominant=True)
        st_r = type(st_r)(*(c * mask for c in st_r))
        b_r = b_r * mask
        inv_r = jacobi(st_r, mask)
        it_r = int(kernels.bicgstab_solve3(st_r, b_r, inv_r, mask, tol=tol, iters=40)[1]["iters"])
        ms_r = kernel_device_ms(lambda: kernels.bicgstab_solve3(
            st_r, b_r, inv_r, mask, tol=tol, iters=40), 20 // reps, "bicgstab_kernel")
        if ms_r is not None:
            log(f"[time] bicgstab_solve3 {label} random dominant system: {it_r} iterations in "
                f"{ms_r * 1e3:.2f} us on the device, {ms_r * 1e3 / it_r:.2f} us an iteration")
        del st_r, b_r, inv_r
        first, later = PASSES[3]
        passes = (first + later * (max(iters, 1) - 1)) * n * item
        blocks = kernels._BLOCKS.get(("bicgstab3", b.dtype, n), 0)
        log(f"[time] bicgstab_solve3 {label}: cooperative grid {blocks} blocks of 256 threads "
            f"({n / max(blocks * 256, 1):.1f} points a thread); {iters} iterations touch {first} + "
            f"{later} x {max(iters, 1) - 1} volumes = {passes / 1e6:.1f} MB, "
            f"{passes / HBM_BYTES_PER_S * 1e6:.1f} us at the HBM rate; measured "
            f"{res[N]['bicgstab_solve3']['ms'] * 1e3:.1f} us")
        del st, b, mask, inv
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the JAX package's production modes and the convergence studies
# ---------------------------------------------------------------------------
def production_modes():
    """The pol N=256 level in each production mode: {name: (dtype,
    integrator kwargs, run kwargs, expected launches a run of (K1, K2, K4),
    of those on float32 operands)}.  41 steps of three solves: the
    per-solve mixed route makes refine + 1 float32 K1 solves a solve, each
    with its wrapper's K2 residual, and refine f64 K2 residuals plus one
    for the final check; the fused mixed route one float32 K4 launch a pass
    and five f64 K2 applies a residual (refine passes and the check)."""
    import torch

    f64, f32 = torch.float64, torch.float32
    mixed_fast = dict(precision="mixed", mixed_refine=1, mixed_final_check=False)
    tables = dict(collect_precompute=True)
    return {
        "f64": (f64, {}, {}, (123, 123, 0), (0, 0, 0)),
        "mixed": (f64, dict(precision="mixed"), {}, (369, 738, 0), (369, 369, 0)),
        "mixed_fast": (f64, mixed_fast, dict(collect_tail="f32", **tables),
                       (246, 369, 0), (246, 246, 0)),
        "mixed fused": (f64, dict(precision="mixed", coupling_source="analytic"), {},
                        (0, 615, 123), (0, 0, 123)),
        "f32_fast": (f32, {}, tables, (123, 123, 0), (123, 123, 0)),
        "f64 + tables": (f64, {}, tables, (123, 123, 0), (0, 0, 0)),
    }


def make_study_trial(N, dtype, device, **integrator_kw):
    """The pol level N through the studies module's ``_make_trial``, the
    budget its ``_study_unroll`` gives."""
    from na_dd_tpu_torch.harness import studies
    from na_dd_tpu_torch.mms.cases import MMSCasePol

    cfg, mc = studies.STUDIES["pol"], studies.study_consts("pol")
    dt = (1.0 / N) ** 1.5
    trial = studies._make_trial(
        MMSCasePol, N, ETA, mc=mc, dtype=dtype, device=device,
        krylov_unroll=studies._study_unroll(cfg, N, dt, mc), **integrator_kw)
    return trial, dt


def phase_production(device):
    """The pol N=256 level in the JAX package's production modes: each
    mode's launch counts (set to 0 just before its run, read just after),
    its error against the f64 level and CPU-x64 (bench.py's TPU values
    printed beside), the time tables' build time, the wall-clock of each
    mode's gated run (the kernels warm), five steps of mixed_fast and of f64 + tables under
    the profiler; then the studies module's spatial ladder N=2..256 and the
    temporal ladder at N=256 against CPU-x64."""
    import torch

    from na_dd_tpu_torch.harness import studies
    from na_dd_tpu_torch.harness.trial import build_time_tables
    from na_dd_tpu_torch.ops import kernels

    names = ("bicgstab_solve", "stencil5_apply", "triple_solve")
    routes, counts, steady = {}, {}, {}
    for mode, (dtype, integ_kw, run_kw, want, want32) in production_modes().items():
        trial, dt = make_study_trial(MAIN_N, dtype, device, **integ_kw)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        s = trial.run_for_errors(Tf=TF, dt=dt, **run_kw)
        first = time.perf_counter() - t0
        launches, launches32 = dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_F32)
        err = s.overall_combined_error
        got = tuple(launches[k] for k in names)
        got32 = tuple(launches32[k] for k in names)
        iters = s.series.krylov_iters.tolist()
        if dtype == torch.float32:
            ref, limit, what = N256_F32, 1e-2, f"{N256_F32:g}"
        elif mode == "f64 + tables":
            ref, limit, what = N256_F64_PORT, 1e-10, "the f64 level"
        else:
            ref, limit, what = N256_F64_PORT, 1e-8, "the f64 level"
        rel = abs(err - ref) / ref
        rel_x64 = abs(err - N256_CPU_X64) / N256_CPU_X64
        tpu = BENCH_TPU.get("f32_pallas_fast" if mode == "f32_fast" else mode.split(" ")[0])
        log(f"[production] {mode}: error {err!r}, vs {what} rel {rel:.3e} (limit {limit:g}), vs "
            f"CPU-x64 rel {rel_x64:.3e}; bench.py's TPU value {tpu!r} (rel "
            f"{abs(err - tpu) / tpu:.3e}, not gated); first run {first:.3f} s; K1/K2/K4 launches "
            f"{got} (float32 {got32}); Krylov iterations {sum(iters)}; converged "
            f"{bool(s.series.krylov_converged.all())}")
        check(math.isfinite(err) and rel <= limit, f"production {mode} off {what}")
        if dtype == torch.float64 and mode != "f64 + tables" and mode != "f64":
            check(rel_x64 <= 1e-8, f"production {mode} off the CPU-x64 value")
        if mode in ("mixed", "mixed fused", "f64", "f64 + tables"):
            check(bool(s.series.krylov_converged.all()), f"production {mode}: a solve did not converge")
        check(len(iters) == 41, "N=256 should take 41 steps")
        check(got == want and got32 == want32,
              f"production {mode}: K1/K2/K4 launches {got} (float32 {got32}), expected {want} "
              f"(float32 {want32})")
        for name in ("bicgstab_solve3", "stencil7_apply"):
            check(launches[name] == 0, f"production {mode} launched the 3-D kernel {name}")
        routes[mode] = (trial, err, run_kw)
        counts[mode] = (launches, launches32)
        steady[mode] = first

    # the time tables' build alone (exact states and forcing at the 42 grid times)
    trial, _, run_kw = routes["mixed_fast"]
    nsteps = 41
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tabled, exact = build_time_tables(
        grid=trial.grid, forcing=trial.integrator.semi_discrete_field.forcing,
        exact_sol_pack=trial.mms_case, ops=trial.ops, t0=0.0, dt=TF / nsteps, num=nsteps)
    torch.cuda.synchronize()
    build = time.perf_counter() - t0
    nbytes = sum(t.numel() * t.element_size() for t in (*tabled._tables.values(), *exact))
    log(f"[production] time tables of the N=256 level (f64): built in {build:.3f} s, "
        f"{nbytes / 1e6:.1f} MB on the card")
    del tabled, exact

    dt = (1.0 / MAIN_N) ** 1.5
    steps = 5
    for mode in ("mixed_fast", "f64 + tables"):
        trial, _, run_kw = routes[mode]
        wall, found = profile_device(lambda: trial.run_for_errors(Tf=steps * dt, dt=dt, **run_kw))
        busy_us = sum(us for _, us in found.values())
        n_launch = sum(c for c, _ in found.values())
        log(f"[production] {steps} steps of {mode} under the profiler: wall {wall:.6f} s, device "
            f"busy {busy_us / 1e6:.6f} s ({100 * busy_us / 1e6 / wall:.2f} %), idle "
            f"{100 * (1 - busy_us / 1e6 / wall):.2f} %, {n_launch} kernel launches "
            f"({n_launch / steps:.0f} per step)")
        top = sorted(found.items(), key=lambda kv: -kv[1][1])[:4]
        for name, (calls, us) in top:
            log(f"[production]   {us / 1e3:9.3f} ms in {calls:6d} calls: {name[:90]}")
    del routes

    t0 = time.perf_counter()
    sp = studies.run_spatial_study("pol", levels=8, verbose=False, device=device)
    for N, err in zip(sp["Ns"], sp["errors"]):
        rel = abs(err - POL_REFERENCE[N]) / POL_REFERENCE[N]
        rel_x64 = abs(err - POL_SPATIAL_CPU_X64[N]) / POL_SPATIAL_CPU_X64[N]
        log(f"[studies] spatial pol N={N}: error {err!r}, vs notebook rel {rel:.3e} (limit 1e-5), "
            f"vs CPU-x64 rel {rel_x64:.3e} (limit 1e-8)")
        check(math.isfinite(err) and rel <= 1e-5, f"spatial study N={N} off the notebook")
        check(rel_x64 <= 1e-8, f"spatial study N={N} off the CPU-x64 value")
    log(f"[studies] run_spatial_study('pol', levels=8): {time.perf_counter() - t0:.1f} s; rates "
        f"{sp['rates']}")
    t0 = time.perf_counter()
    tp = studies.run_temporal_study("pol", verbose=False, device=device)
    for dt_k, err in zip(tp["dts"], tp["errors"]):
        ref = POL_TEMPORAL_CPU_X64[dt_k]
        rel = abs(err - ref) / ref
        log(f"[studies] temporal pol N=256 dt={dt_k:g}: error {err!r}, vs CPU-x64 rel {rel:.3e} "
            "(limit 1e-8)")
        check(math.isfinite(err) and rel <= 1e-8, f"temporal study dt={dt_k} off the CPU-x64 value")
    log(f"[studies] run_temporal_study('pol'): {time.perf_counter() - t0:.1f} s")
    return counts, steady


def phase_mixed3(device, err64=None):
    """The 3-D ExpSin3 N=64 level with precision="mixed" (float32 K5 under
    f64 refinement on Stencil7 planes): error against the port's f64 value
    and CPU-x64, K5's float32 launches, steady wall-clock beside f64."""
    import torch

    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.three_d.harness import run_trial3

    N, dt = MAIN_N3, dt3(MAIN_N3)
    nsteps = round(TF3 / dt)
    g, case, integ = make_trial3(N, torch.float64, device, precision="mixed")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    r = run_trial3(g, case, integ, Tf=TF3, dt=dt)
    launches, launches32 = dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_F32)
    err = r["error"]
    g64, case64, integ64 = make_trial3(N, torch.float64, device)
    r64 = run_trial3(g64, case64, integ64, Tf=TF3, dt=dt)
    if err64 is not None:
        check(r64["error"] == err64, "3-D f64 N=64 changed between phases")
    err64 = r64["error"]
    rel = abs(err - err64) / err64
    rel_x64 = abs(err - THREE_D_CPU_X64[N]) / THREE_D_CPU_X64[N]
    want = 3 * 6 * nsteps  # three passes of six solves a step
    log(f"[mixed3] N={N}: error {err!r}, vs the port's f64 {err64!r} rel {rel:.3e} (limit 1e-8), "
        f"vs CPU-x64 rel {rel_x64:.3e}; launches {launches} (float32 {launches32}); converged "
        f"{r['krylov_converged']}")
    check(math.isfinite(err) and rel <= 1e-8, "3-D mixed N=64 off the f64 level")
    check(rel_x64 <= 1e-8, "3-D mixed N=64 off the CPU-x64 value")
    check(r["krylov_converged"], "3-D mixed N=64: a solve did not converge")
    check(launches["bicgstab_solve3"] == launches32["bicgstab_solve3"] == want,
          f"3-D mixed: K5 launched {launches['bicgstab_solve3']} times "
          f"({launches32['bicgstab_solve3']} float32), expected {want} float32")
    check(launches["stencil7_apply"] == 2 * want and launches32["stencil7_apply"] == want,
          "3-D mixed: expected one float32 K6 residual a K5 solve and one f64 K6 residual a pass")
    for name in ("bicgstab_solve", "stencil5_apply", "triple_solve"):
        check(launches[name] == 0, f"the 3-D mixed path launched the 2-D kernel {name}")
    runs = {"f64": [], "mixed": []}
    for name, (g_, c_, i_) in (("f64", (g64, case64, integ64)), ("mixed", (g, case, integ))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_ = run_trial3(g_, c_, i_, Tf=TF3, dt=dt)
        runs[name].append(time.perf_counter() - t0)
        check(r_["error"] == (err if name == "mixed" else err64), f"repeat 3-D {name} changed")
    for name, times in runs.items():
        log(f"[mixed3] N={N} {name} steady wall-clock {min(times):.6f} s (one run after its "
            "gate's, in turns)")
    return launches32, min(runs["mixed"]), err


def timings_mixed(device):
    """The float32 solves of the mixed path, each against its plain version
    and timed: K1 on the first inner solve of the step-1 T system of the
    N=256 level (its f64 inverse diagonal downcast), K4 on the step-1
    operands of the fused route in float32 (the inverse diagonals of the
    float32 planes), K5 on the first inner solve of the step-1 T system of
    the 3-D N=64 level; the inner tolerance MIXED_INNER_TOL."""
    import torch

    from na_dd_tpu_torch.integrators.pc_trapezoidal import MIXED_INNER_TOL
    from na_dd_tpu_torch.ops import kernels

    f32, tol = torch.float32, MIXED_INNER_TOL
    res = {}
    systems, solver = step1_systems(torch.float64, device)
    st, b, mask = systems[0]
    st32, b32 = type(st)(*(c.to(f32) for c in st)), b.to(f32)
    inv32, m32 = jacobi(st, mask).to(f32), mask.to(f32)
    del systems
    err, iters = compare_solve(st32, b32, inv32, m32, tol=tol, iters=solver.iters, xtol=1e-4,
                               label="f32 mixed inner solve, step-1 T plane")
    n = b32.numel()

    def k1():
        return kernels.bicgstab_solve(st32, b32, inv32, m32, tol=tol, iters=solver.iters)

    res["bicgstab_solve"] = kernel_row(
        "bicgstab_solve", f32, label=f"f32 257x257 mixed inner ({iters} iterations)",
        device_ms=kernel_device_ms(k1, 100, "bicgstab_kernel"), wrapper_ms=time_ms(k1, 500),
        plain_ms=time_ms(lambda: kernels.bicgstab_solve_plain(
            st32, b32, inv32, m32, tol=tol, iters=solver.iters), 50),
        nbytes=9 * n * 4, ops=(2 * 9 + 6 * 2 + 14) * n * max(iters, 1))
    res["bicgstab_solve"]["max_abs_err"] = err

    operands, solver = step1_triple(torch.float64, device)
    ops32 = cast_triple(operands, f32)
    mask32 = ops32[12]
    ops32 = (*ops32[:9], *(jacobi(J, mask32) for J in ops32[:3]), *ops32[12:])
    err4, _ = compare_triple(ops32, tol=tol, iters=solver.iters, xtol=1e-4, stol=1e-4,
                             label="f32 mixed fused, step-1 operands")
    its = kernels.triple_solve(*ops32, tol=tol, iters=solver.iters)[3]["iters"].tolist()

    def k4():
        return kernels.triple_solve(*ops32, tol=tol, iters=solver.iters)

    res["triple_solve"] = kernel_row(
        "triple_solve", f32, label=f"f32 257x257 mixed fused (iterations {its})",
        device_ms=kernel_device_ms(k4, 100, "triple_solve_kernel"), wrapper_ms=time_ms(k4, 200),
        plain_ms=time_ms(lambda: kernels.triple_solve_plain(*ops32, tol=tol, iters=solver.iters), 5),
        nbytes=36 * n * 4, ops=(44 * max(sum(its), 1) + 29) * n)
    res["triple_solve"]["max_abs_err"] = err4
    del operands, ops32

    systems, solver = step1_systems3(MAIN_N3, torch.float64, device)
    st, b, mask = systems[0]
    st32, b32 = type(st)(*(c.to(f32) for c in st)), b.to(f32)
    inv32, m32 = jacobi(st, mask).to(f32), mask.to(f32)
    del systems
    err5, iters5 = compare_solve(st32, b32, inv32, m32, tol=tol, iters=solver.iters, xtol=1e-4,
                                 label="f32 mixed inner solve, 3-D N=64 step-1 T volume")
    n3 = b32.numel()

    def k5():
        return kernels.bicgstab_solve3(st32, b32, inv32, m32, tol=tol, iters=solver.iters)

    res["bicgstab_solve3"] = kernel_row(
        "bicgstab_solve3", f32, label=f"f32 65^3 mixed inner ({iters5} iterations)",
        device_ms=kernel_device_ms(k5, 50, "bicgstab_kernel"), wrapper_ms=time_ms(k5, 200),
        plain_ms=time_ms(lambda: kernels.bicgstab_solve3_plain(
            st32, b32, inv32, m32, tol=tol, iters=solver.iters), 20),
        nbytes=11 * n3 * 4, ops=(2 * 13 + 6 * 2 + 14) * n3 * max(iters5, 1))
    res["bicgstab_solve3"]["max_abs_err"] = err5
    return res


# ---------------------------------------------------------------------------
# double-float: precision="df" and mixed_df on the float32 K1/K4/K5
# ---------------------------------------------------------------------------
#: the JAX package's eager CPU-x64 df record (studies/df_cpu_x64.py)
DF_RECORD = REPO / "studies" / "results" / "df_cpu_x64.json"
DF_KW = dict(precision="df", mixed_refine=1, mixed_final_check=False)
DF_STEPS3 = 1  # steps of the 3-D ExpSin3 N=64 df run (~11 s a step, launch-bound)
#: each DF function's inputs (seeded) and its gate on the card against the
#: CPU, in DF ulps (2^-48) of the value's magnitude (at least 1): the float32
#: log/division estimates may round differently, the DF correction not
DF_FUNCTIONS = {
    "df_add": (lambda r: (r.standard_normal(1 << 16), r.standard_normal(1 << 16) * 1e-3), 0),
    "df_mul": (lambda r: (r.standard_normal(1 << 16), r.standard_normal(1 << 16)), 0),
    "df_div": (lambda r: (r.standard_normal(1 << 16), r.uniform(0.5, 2.0, 1 << 16)), 4),
    "df_exp": (lambda r: (r.uniform(-40.0, 40.0, 1 << 16),), 8),
    "df_logistic": (lambda r: (r.uniform(-30.0, 30.0, 1 << 16),), 8),
    "df_log": (lambda r: (r.uniform(1e-3, 1e3, 1 << 16),), 8),
    "df_pow": (lambda r: (r.uniform(0.05, 2.0, 1 << 16), r.uniform(0.5, 4.5, 1 << 16)), 32),
    "df_sqrt": (lambda r: (r.uniform(0.0, 10.0, 1 << 16),), 8),
    "df_rsqrt": (lambda r: (r.uniform(0.01, 10.0, 1 << 16),), 8),
    "df_sin": (lambda r: (r.uniform(-20.0, 20.0, 1 << 16),), 8),
    "df_cos": (lambda r: (r.uniform(-20.0, 20.0, 1 << 16),), 8),
    "df_tanh": (lambda r: (r.uniform(-10.0, 10.0, 1 << 16),), 8),
}


def df_record():
    with open(DF_RECORD) as f:
        return json.load(f)


def df_eft_checks(device):
    """The error-free transformations on CUDA tensors: s + e == a op b
    exactly in float64 (a multiply-add fused into one operation would break
    two_prod's split), and bit for bit the CPU's pairs."""
    import torch

    from na_dd_tpu_torch.ops import doublefloat as dfm

    rng = np.random.default_rng(16)
    n = 1 << 20
    a = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(n) * 1e-3, dtype=torch.float32)
    # fast_two_sum's precondition |a| >= |b|
    a, b = torch.where(a.abs() >= b.abs(), a, b), torch.where(a.abs() >= b.abs(), b, a)
    for name, exact in (("two_sum", lambda x, y: x + y), ("fast_two_sum", lambda x, y: x + y),
                        ("two_prod", lambda x, y: x * y)):
        fn = getattr(dfm, name)
        s, e = fn(a.to(device), b.to(device))
        torch.cuda.synchronize()
        ok = bool(torch.equal(s.double() + e.double(), exact(a.to(device).double(),
                                                             b.to(device).double())))
        s_cpu, e_cpu = fn(a, b)
        same = torch.equal(s.cpu(), s_cpu) and torch.equal(e.cpu(), e_cpu)
        log(f"[df] {name} on {n} CUDA pairs: hi + lo exact {ok}; bit for bit the CPU's {same}")
        check(ok, f"{name} is not error-free on the card")
        check(same, f"{name} differs between the card and the CPU")
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float64, device=device)
    d = dfm.df_split(x)
    rel = float(((dfm.df_to(d, torch.float64) - x).abs() / x.abs().max()).max())
    log(f"[df] df_split round trip on the card: max rel {rel:.3e} (limit 2e-14)")
    check(rel < 2e-14, "df_split loses more than the DF precision on the card")


def df_function_checks(device):
    """Each DF function on the card against its CPU run on the same inputs.
    Returns {name: deviation in DF ulps}."""
    import torch

    from na_dd_tpu_torch.ops import doublefloat as dfm

    out = {}
    for k, (name, (make, limit)) in enumerate(DF_FUNCTIONS.items()):
        xs = [torch.as_tensor(x, dtype=torch.float64) for x in make(np.random.default_rng(k))]
        fn = getattr(dfm, name)
        cpu = dfm.df_to(fn(*(dfm.df_split(x) for x in xs)), torch.float64)
        gpu = dfm.df_to(fn(*(dfm.df_split(x.to(device)) for x in xs)), torch.float64).cpu()
        ulps = float(((gpu - cpu).abs() / cpu.abs().clamp_min(1.0)).max()) / 2.0 ** -48
        out[name] = ulps
        check(bool(torch.isfinite(gpu).all()), f"{name} not finite on the card")
        check(ulps <= limit, f"{name} on the card is {ulps:.2f} DF ulps off the CPU (limit {limit})")
    log("[df] DF functions, card vs CPU (DF ulps): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def capture_first(name):
    """Record the arguments of the first call of ``kernels.<name>`` while
    the context is open (the wrapper runs as usual)."""
    from contextlib import contextmanager

    from na_dd_tpu_torch.ops import kernels

    @contextmanager
    def ctx():
        fn, seen = getattr(kernels, name), []

        def wrapped(*args, **kw):
            if not seen:
                seen.append((args, kw))
            return fn(*args, **kw)

        setattr(kernels, name, wrapped)
        try:
            yield seen
        finally:
            setattr(kernels, name, fn)

    return ctx()


def df_main_level(device):
    """The pol main level in df_fast (fused: one float32 K4 a refinement
    pass), timed warm, with its launch counts and one profiled step."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    trial, dt = make_study_trial(MAIN_N, torch.float64, device, coupling_source="analytic", **DF_KW)
    run_kw = dict(collect_tail="f32", collect_precompute=True)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with capture_first("triple_solve") as seen:
        s = trial.run_for_errors(Tf=TF, dt=dt, **run_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, launches32 = dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_F32)
    err = s.overall_combined_error
    nsteps = len(s.series.krylov_iters)
    dev = abs(err - N256_CPU_X64) / N256_CPU_X64
    want = nsteps * (DF_KW["mixed_refine"] + 1)
    log(f"[df] pol N=256 df_fast (fused, refine 1, no final check, time tables, float32 tail): "
        f"error {err!r}, vs CPU-x64 {N256_CPU_X64!r} deviation {dev:.3e} (limit 1e-5); "
        f"{nsteps} steps in {wall:.3f} s warm ({1e3 * wall / nsteps:.1f} ms a step); launches "
        f"{launches} (float32 {launches32}); converged {bool(s.series.krylov_converged.all())}")
    check(math.isfinite(err) and dev <= 1e-5, "df N=256 off the CPU-x64 value")
    check(nsteps == 41, "N=256 should take 41 steps")
    check(launches["triple_solve"] == launches32["triple_solve"] == want,
          f"df N=256: K4 launched {launches['triple_solve']} times, expected {want} float32")
    for name in ("bicgstab_solve", "stencil5_apply", "bicgstab_solve3", "stencil7_apply"):
        check(launches[name] == 0, f"df N=256 launched {name}")
    step_wall, found = profile_device(lambda: trial.run_for_errors(Tf=dt, dt=dt, **run_kw))
    busy_us = sum(us for _, us in found.values())
    n_launch = sum(c for c, _ in found.values())
    idle = 100 * (1 - busy_us / 1e6 / step_wall)
    log(f"[df] one df_fast step under the profiler: wall {step_wall:.6f} s, device busy "
        f"{busy_us / 1e6:.6f} s, idle {idle:.2f} %, {n_launch} kernel launches")
    return dict(err=err, dev=dev, wall=wall, launches32=launches32, per_step=n_launch,
                idle=idle, k4=seen[0], budget=trial.integrator.solver.iters)


def phase_df(device):
    """precision="df" and mixed_df on the card: the EFTs on CUDA tensors,
    each DF function against its CPU run, the lifted field evaluation (no
    float64 passthrough), the df ladder N=8..64 on the per-solve route (K1)
    and the main level fused (K4) against the JAX package's CPU-x64 df
    record and values, mixed_df per-solve and fused at N=256, 3-D ExpSin3
    N=64 df through K5 against the port's f64 run of the same steps, and the
    33-eta analytic sweep in batches of at most 32; then K1/K4/K5 on the
    float32 operands of these paths against their plain versions, timed."""
    import torch

    from na_dd_tpu_torch.harness import studies
    from na_dd_tpu_torch.integrators.pc_trapezoidal import MIXED_INNER_TOL
    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.ops.df_lift import df_call, df_lift_report
    from na_dd_tpu_torch.three_d.harness import build_runner3

    rec = df_record()
    df_eft_checks(device)
    ulps = df_function_checks(device)

    # the lifted field evaluation on the card, no passthrough: at N=24 (the
    # JAX test's setup) against float64 at its gate; at N=256 its distance
    # from float64, which grows with the 1/h^2 cancellation of the diffusion
    # terms on either device (3.760e-13 on both, PERF.md), is printed
    from na_dd_tpu_torch.mms.engine import state_from_mms_when

    def lifted(N, dev):
        trial, _ = make_study_trial(N, torch.float64, dev)
        g, field = trial.grid, trial.integrator.semi_discrete_field
        s_t = state_from_mms_when(mms_case=trial.mms_case, t=0.011, grid=g)
        ref = field.all_fields(g, trial.ops, s_t, 0.011)
        got = df_call(lambda s, t: field.all_fields(g, trial.ops, s, t), s_t, 0.011)
        return got, ref

    df_lift_report(reset=True)
    got, ref = lifted(24, device)
    lift = max(rel_to_max(getattr(got, k), getattr(ref, k)) for k in ref._fields)
    got, ref = lifted(MAIN_N, device)
    lift256 = max(rel_to_max(getattr(got, k), getattr(ref, k)) for k in ref._fields)
    report = df_lift_report()
    log(f"[df] lifted all_fields on the card: N=24 max dev {lift:.3e} of each field's scale "
        f"from float64 (limit 3e-13); N={MAIN_N} {lift256:.3e} (not gated); passthroughs "
        f"{report}")
    check(lift <= 3e-13 and report == {}, "the lifted field evaluation is off or passes through")
    del got, ref

    # the df ladder on the per-solve route (float32 K1) against the record
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ladder = {}
    for N in (8, 16, 32, 64):
        tr, dt = make_study_trial(N, torch.float64, device, fused_triple=False, **DF_KW)
        ladder[N] = tr.run_for_errors(Tf=TF, dt=dt).overall_combined_error
    launches_ladder = dict(kernels.LAUNCHES_F32)
    for N, err in ladder.items():
        ref_n = rec["df"][str(N)]["error"]
        rel = abs(err - ref_n) / ref_n
        log(f"[df] ladder N={N} (per-solve): error {err!r}, vs the JAX CPU-x64 df record "
            f"{ref_n!r} rel {rel:.3e} (limit 1e-8)")
        check(math.isfinite(err) and rel <= 1e-8, f"df ladder N={N} off the CPU-x64 df record")
    log(f"[df] ladder float32 launches {launches_ladder}")
    check(launches_ladder["bicgstab_solve"] > 0 and launches_ladder["triple_solve"] == 0,
          "the per-solve df ladder did not go through float32 K1 alone")

    main = df_main_level(device)

    # mixed_df at N=256, per-solve (float32 K1) and fused (float32 K4)
    mixed = {}
    for mode, kw, want, want32 in (
        ("per-solve", {}, (369, 492, 0), (369, 369, 0)),
        ("fused", dict(coupling_source="analytic"), (0, 205, 123), (0, 0, 123)),
    ):
        tr, dt = make_study_trial(MAIN_N, torch.float64, device, precision="mixed",
                                  mixed_df=True, **kw)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with capture_first("bicgstab_solve") as seen:
            s = tr.run_for_errors(Tf=TF, dt=dt)
        names = ("bicgstab_solve", "stencil5_apply", "triple_solve")
        got = tuple(kernels.LAUNCHES[k] for k in names)
        got32 = tuple(kernels.LAUNCHES_F32[k] for k in names)
        err = s.overall_combined_error
        rel = abs(err - N256_CPU_X64) / N256_CPU_X64
        log(f"[df] mixed_df {mode} N=256: error {err!r}, vs CPU-x64 rel {rel:.3e} (limit 1e-8); "
            f"K1/K2/K4 launches {got} (float32 {got32}); converged "
            f"{bool(s.series.krylov_converged.all())}")
        check(math.isfinite(err) and rel <= 1e-8, f"mixed_df {mode} off the CPU-x64 value")
        check(bool(s.series.krylov_converged.all()), f"mixed_df {mode}: a solve did not converge")
        check(got == want and got32 == want32,
              f"mixed_df {mode}: launches {got} (float32 {got32}), expected {want} ({want32})")
        mixed[mode] = dict(launches32=dict(kernels.LAUNCHES_F32), budget=tr.integrator.solver.iters)
        if mode == "per-solve":
            mixed[mode]["k1"] = seen[0]

    # 3-D: ExpSin3 N=64 df (float32 K5) against the port's f64 run of the same steps
    N3, dt_3 = MAIN_N3, dt3(MAIN_N3)
    finals = {}
    for label, kw in (("f64", {}), ("df", DF_KW)):
        g3, case3, integ3 = make_trial3(N3, torch.float64, device, **kw)
        run, s0 = build_runner3(g3, case3, integ3, Tf=DF_STEPS3 * dt_3, dt=dt_3)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with capture_first("bicgstab_solve3") as seen3:
            s_fin, _worst, ok3, _hcs, _ = run(s0)
        torch.cuda.synchronize()
        finals[label] = (s_fin, bool(ok3), time.perf_counter() - t0, dict(kernels.LAUNCHES),
                         dict(kernels.LAUNCHES_F32), seen3[0], integ3.solver.iters)
    (s64, _, w64, *_), (sdf, ok_df, wdf, l3, l3_32, k5_args, budget3) = finals["f64"], finals["df"]
    dev3 = max(rel_to_max(getattr(sdf, k), getattr(s64, k)) for k in s64._fields)
    want3 = DF_STEPS3 * 2 * 3 * (DF_KW["mixed_refine"] + 1)
    log(f"[df] 3-D ExpSin3 N={N3} df, {DF_STEPS3} steps: max field deviation from the f64 run "
        f"{dev3:.3e} (limit 1e-12); {wdf:.3f} s against {w64:.3f} s in f64; launches {l3} "
        f"(float32 {l3_32})")
    check(dev3 <= 1e-12, "3-D df off the port's f64 run")
    check(ok_df, "3-D df: a solve did not converge")
    check(l3["bicgstab_solve3"] == l3_32["bicgstab_solve3"] == want3,
          f"3-D df: K5 launched {l3['bicgstab_solve3']} times, expected {want3} float32")
    for name in ("bicgstab_solve", "stencil5_apply", "triple_solve"):
        check(l3[name] == 0, f"the 3-D df path launched the 2-D kernel {name}")

    # F3: 33 eta in batches of at most kernels.MAX_BATCH
    eta = rec["eta33"]
    sweep = studies.build_eta_study_batched(
        "pol", N=eta["config"]["N"], dt=eta["config"]["dt"], Tf=eta["config"]["Tf"],
        etas=eta["etas"], coupling_source="analytic", device=device)
    parts = [len(p["etas"]) for p in sweep["parts"]]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    packed = sweep["run"]()
    k4_eta = kernels.LAUNCHES["triple_solve"]
    from na_dd_tpu_torch.harness.trial import (
        ALL_VARIABLES,
        DEFAULT_INTEGRAL_VARS,
        NumericalErrorSummary,
        _error_series,
        _unpack,
    )

    mats, diags = _unpack(packed, len(ALL_VARIABLES), sweep["num_steps"], len(eta["etas"]))
    worst = 0.0
    for i, ref_i in enumerate(eta["errors"]):
        series = _error_series(mats[..., i], diags[..., i], ALL_VARIABLES, 0.0, sweep["dt"])
        e_i = NumericalErrorSummary(sweep["dt"], series, list(ALL_VARIABLES),
                                    list(DEFAULT_INTEGRAL_VARS)).overall_combined_error
        worst = max(worst, abs(e_i - ref_i) / ref_i)
    log(f"[df] F3: {len(eta['etas'])} eta as batches {parts}: max rel to the JAX sweep "
        f"{worst:.3e} (limit 1e-10); K4 launches {k4_eta}")
    check(parts == [kernels.MAX_BATCH, len(eta["etas"]) - kernels.MAX_BATCH],
          "the 33-eta sweep is not split at the batch limit")
    check(worst <= 1e-10, "the 33-eta sweep is off the JAX sweep")
    check(k4_eta == sweep["num_steps"] * len(parts), "the 33-eta sweep's K4 launches")

    # the float32 kernels on this path's operands, against their plain versions
    rows = {}
    args, _ = main["k4"]
    ops4 = args[:14]
    err4, _ = compare_triple(ops4, tol=MIXED_INNER_TOL, iters=main["budget"], xtol=1e-4, stol=1e-4,
                             label="f32 df fused, first pass of step 1")
    its4 = kernels.triple_solve(*ops4, tol=MIXED_INNER_TOL, iters=main["budget"])[3]["iters"]
    n = ops4[6].numel()
    rows["triple_solve"] = kernel_row(
        "triple_solve", torch.float32, label=f"f32 257x257 df fused (iterations {its4.tolist()})",
        device_ms=kernel_device_ms(lambda: kernels.triple_solve(
            *ops4, tol=MIXED_INNER_TOL, iters=main["budget"]), 50, "triple_solve_kernel"),
        wrapper_ms=time_ms(lambda: kernels.triple_solve(
            *ops4, tol=MIXED_INNER_TOL, iters=main["budget"]), 100),
        plain_ms=time_ms(lambda: kernels.triple_solve_plain(
            *ops4, tol=MIXED_INNER_TOL, iters=main["budget"]), 3),
        nbytes=36 * n * 4, ops=(44 * max(int(its4.sum()), 1) + 29) * n)
    rows["triple_solve"]["max_abs_err"] = err4
    for key, (args, _kw), budget, label in (
        ("bicgstab_solve", mixed["per-solve"]["k1"], mixed["per-solve"]["budget"],
         "f32 257x257 mixed_df inner"),
        ("bicgstab_solve3", k5_args, budget3, "f32 65^3 3-D df inner"),
    ):
        st, b, inv, m = args
        errk, itk = compare_solve(st, b, inv, m, tol=MIXED_INNER_TOL, iters=budget, xtol=1e-4,
                                  label=label)
        solve = getattr(kernels, key)
        plain = getattr(kernels, key + "_plain")
        nk, planes = b.numel(), len(st)
        rows[key] = kernel_row(
            key, torch.float32, label=f"{label} ({itk} iterations)",
            device_ms=kernel_device_ms(lambda: solve(st, b, inv, m, tol=MIXED_INNER_TOL,
                                                     iters=budget), 50, "bicgstab_kernel"),
            wrapper_ms=time_ms(lambda: solve(st, b, inv, m, tol=MIXED_INNER_TOL, iters=budget), 200),
            plain_ms=time_ms(lambda: plain(st, b, inv, m, tol=MIXED_INNER_TOL, iters=budget), 10),
            nbytes=(planes + 4) * nk * 4, ops=(2 * (2 * planes - 1) + 26) * nk * max(itk, 1))
        rows[key]["max_abs_err"] = errk
    return dict(main=main, ladder=ladder, mixed=mixed, ulps=ulps, lift=(lift, lift256),
                dev3=dev3,
                wall3=(wdf, w64), launches3_32=l3_32, rows=rows, eta_worst=worst,
                launches_ladder=launches_ladder)


# ---------------------------------------------------------------------------
# the modeller's path: simulate, adaptive steps, checkpoints, the direct
# solver, IFT gradients and calibration
# ---------------------------------------------------------------------------
# The drug-release scenario of tests/test_gradients.py and
# studies/eta_gradient_study.py: a Gaussian drug blob b, State(0.5b, 0.1b,
# 0.2b, 0.05b, b), default_model_consts with Kd = 1e-2, RegHCs, eta = 50, no
# forcing, dt = 2e-3.  The JAX package's CPU-x64 values of each phase
# (studies/results/modeller_cpu_x64.json, made by studies/modeller_cpu_x64.py).
RELEASE_N, RELEASE_STEPS, RELEASE_DT, SMALL_N = 256, 40, 2e-3, 64
RELEASE_BASE = {"Dl_max": 8.01e-4, "Dd_max": 2.46e-6, "Kd": 1e-2, "K3": 1e-2,
                "regularization_factor": 50.0}
DIRECTION_SEED = 8
ADAPTIVE = dict(Tf=0.04, dt0=2e-3, tol=1e-6)
MODELLER_CPU_X64 = {
    "simulate": {
        "times": [0.02, 0.04, 0.06, 0.08],
        "final_norms": {"cp": 0.08082353390990535, "T": 0.016022877189708188, "cl": 0.032041533653632236, "cd": 0.011667270468696773, "cs": 0.15905973020994865},
        "snapshot_norms": [
            {"cp": 0.08088167091612021, "T": 0.01614045722927638, "cl": 0.032280102900124265, "cd": 0.008856689058739986, "cs": 0.1611050950201525},
            {"cp": 0.08086227707063112, "T": 0.016100983447299013, "cl": 0.032200179304800625, "cd": 0.009728178494153103, "cs": 0.16041586309253877},
            {"cp": 0.08084289808962668, "T": 0.016061791209580307, "cl": 0.032120657427549916, "cd": 0.010672745384375052, "cs": 0.15973416885006925},
            {"cp": 0.08082353390990535, "T": 0.016022877189708188, "cl": 0.032041533653632236, "cd": 0.011667270468696773, "cs": 0.15905973020994865},
        ],
        "dissolved": 0.13357586909463523, "released": 7.033858272720295e-06,
    },
    "adaptive": {
        "Tf": 0.04, "dt0": 0.002, "tol": 1e-06,
        "info": {"steps": 11, "rejected": 0, "t": 0.04, "dt": 0.0038885278792152515},
        "final_norms": {"cp": 0.0808622770703687, "T": 0.016100983441671275, "cl": 0.03220017929837852, "cd": 0.009728178744227343, "cs": 0.16041586317333506},
    },
    "gradients": {
        "value": 0.13357586909463523,
        "grads": {"Dl_max": -0.0007805138387873257, "Dd_max": -2.466165808173526, "Kd": 8.297376810549984, "K3": -1.5379742195375267e-13, "regularization_factor": 2.1119258278456296e-05},
        "state_directional": -0.04524900930396015,
    },
    "configs": {
        "mixed": {"value": 0.06926444251893232,
                   "grads": {"Dl_max": -4.2469906237418905e-05, "Dd_max": -0.042296617750844936, "Kd": 2.145635510469809, "K3": -5.988264661803562e-16, "regularization_factor": 1.5638559663086296e-05}},
        "direct": {"value": 0.06926444251893232,
                   "grads": {"Dl_max": -4.246990623741875e-05, "Dd_max": -0.042296617750844936, "Kd": 2.145635510469809, "K3": -5.988264352921891e-16, "regularization_factor": 1.5638559663086296e-05}},
    },
    "fit": {
        "history": [0.09429848881990027, 0.038561954799094654, 0.012146550475022595, 0.002032245981466747, 1.0942790530742323e-05, 0.0015182498993922626, 0.004240799760668226, 0.00708657425466522, 0.009577660783804948, 0.011531084864371549],
        "fitted": {"Kd": 0.010260183641910843},
    },
    "three_d": {"final_norms": {"cp": 0.0707100778437122, "T": 0.03534693250703624, "cl": 8.75945026130695e-06, "cd": 0.01773440800695922, "cs": 0.3534967127556567}},
}
MODELLER_RTOL = 1e-8


def release_consts():
    from na_dd_tpu_torch.models.consts import default_model_consts

    return default_model_consts._replace(Kd=1e-2)


def release_setup(N, device):
    """Grid and initial state of the release scenario at N."""
    import torch

    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.ops.grid import make_uniform_grid

    g = make_uniform_grid(N, N, device=device)
    b = torch.exp(-60.0 * ((g.xx - 0.5) ** 2 + (g.yy - 0.5) ** 2)) * g.interior_mask
    return g, State(cp=0.5 * b, T=0.1 * b, cl=0.2 * b, cd=0.05 * b, cs=b)


def release_integrator(g, **kw):
    from na_dd_tpu_torch.harness import make_integrator
    from na_dd_tpu_torch.models.coefficients import Model02

    return make_integrator(g, Model02(release_consts()), **kw)


class Diagnosed:
    """An integrator whose step_fn keeps each step's krylov_converged (a
    device tensor) in ``converged``."""

    def __init__(self, inner):
        self.inner = inner
        self.converged = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step_fn(self, *args):
        s1, diag = self.inner.step_fn(*args)
        self.converged.append(diag.krylov_converged)
        return s1, diag

    def all_converged(self) -> bool:
        import torch

        return bool(torch.stack(self.converged).all())


def h_norms(ops, g, s):
    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.ops.inner_products import norm_H

    return {v: float(norm_H(ops, g, getattr(s, v))) for v in State._fields}


def check_norms(label, got, ref, rtol=MODELLER_RTOL):
    worst = max(abs(got[v] - ref[v]) / abs(ref[v]) for v in ref)
    log(f"[{label}] H-norms vs CPU-x64: worst rel {worst:.3e} (limit {rtol:g})")
    check(worst <= rtol, f"{label}: H-norms off CPU-x64")


def steady_calls(fn, repeats=1):
    """Host-clock seconds of ``repeats`` calls of ``fn`` after a warm-up,
    each ending in a synchronisation."""
    import torch

    fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    return runs


def phase_simulate(device):
    """simulate() of the release scenario at N=256: 40 steps, a snapshot
    every 10, held to CPU-x64; its exact K1/K2 launches, five steps under
    the profiler, the steady wall-clock; then the 3-D sin bump at N=64
    (K5/K6) against CPU-x64 and the CPU plain run."""
    import torch

    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.harness import dissolved_drug_fraction, released_drug_fraction, simulate
    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.ops.shifts import LOCAL_OPS

    ref = MODELLER_CPU_X64["simulate"]
    g, s0 = release_setup(RELEASE_N, device)
    integ = Diagnosed(release_integrator(g))
    # three solves a step (one PC step, one Newton sweep), each one K1
    # launch and one K2 launch for its true residual
    want = 3 * RELEASE_STEPS
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    fin, times, snaps = simulate(integ, g, s0, dt=RELEASE_DT, num_steps=RELEASE_STEPS,
                                 snapshot_every=10)
    launches = dict(kernels.LAUNCHES)
    log(f"[simulate] N={RELEASE_N}, {RELEASE_STEPS} steps: launches {launches} "
        f"(predicted K1 {want}, K2 {want})")
    for name in ("bicgstab_solve", "stencil5_apply"):
        check(launches[name] == want, f"simulate: {name} launched {launches[name]}, not {want}")
    check(integ.all_converged(), "simulate: a Krylov solve missed its tolerance")
    check(torch.allclose(times.cpu(), torch.tensor(ref["times"], dtype=times.dtype)),
          "simulate: snapshot times")
    check_norms("simulate", h_norms(LOCAL_OPS, g, fin), ref["final_norms"])
    for k in range(4):
        check_norms(f"simulate snapshot {k}", h_norms(LOCAL_OPS, g, State(*(a[k] for a in snaps))),
                    ref["snapshot_norms"][k])
    dissolved = float(dissolved_drug_fraction(LOCAL_OPS, g, fin))
    released = float(released_drug_fraction(LOCAL_OPS, g, fin, s0))
    rel_d = abs(dissolved - ref["dissolved"]) / ref["dissolved"]
    rel_r = abs(released - ref["released"]) / abs(ref["released"])
    log(f"[simulate] dissolved {dissolved!r} (CPU-x64 {ref['dissolved']!r}, rel {rel_d:.3e}); "
        f"released {released!r} (CPU-x64 {ref['released']!r}, rel {rel_r:.3e})")
    check(rel_d <= MODELLER_RTOL and rel_r <= MODELLER_RTOL, "simulate: fractions off CPU-x64")

    steps = 5
    wall, found = profile_device(lambda: simulate(integ, g, s0, dt=RELEASE_DT, num_steps=steps))
    busy_us = sum(us for _, us in found.values())
    n_launch = sum(c for c, _ in found.values())
    log(f"[simulate] {steps} steps under the profiler: wall {wall:.6f} s, device busy "
        f"{busy_us / 1e6:.6f} s, idle {100 * (1 - busy_us / 1e6 / wall):.2f} %, "
        f"{n_launch / steps:.0f} launches a step")
    runs = steady_calls(lambda: simulate(integ, g, s0, dt=RELEASE_DT, num_steps=RELEASE_STEPS))
    steady = min(runs)
    log(f"[simulate] steady wall-clock {steady:.6f} s for {RELEASE_STEPS} steps (one run after "
        "a warm-up)")
    del fin, snaps
    return launches, steady, phase_simulate3(device)


def simulate3(device):
    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.harness import simulate
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.three_d.grid import make_uniform_grid3
    from na_dd_tpu_torch.three_d.harness import make_integrator3
    import torch

    g = make_uniform_grid3(MAIN_N3, MAIN_N3, MAIN_N3, device=device)
    bump = (torch.sin(math.pi * g.xx) * torch.sin(math.pi * g.yy) * torch.sin(math.pi * g.zz)
            ) * g.interior_mask
    s0 = State(cp=0.2 * bump, T=0.1 * bump, cl=0.0 * bump, cd=0.05 * bump, cs=bump)
    mc = default_model_consts._replace(gamma_T=1e-2, **THREE_D_CONSTS)
    integ = Diagnosed(make_integrator3(g, Model02(mc)))
    fin = simulate(integ, g, s0, dt=1e-3, num_steps=8)[0]
    return g, fin, integ


def phase_simulate3(device):
    """The 3-D sin bump of tests/test_three_d_model.py at N=64, 8 steps."""
    import torch

    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    g, fin, integ = simulate3(device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"[simulate3] N={MAIN_N3}, 8 steps in {wall:.3f} s (first run): launches {launches}")
    for name in ("bicgstab_solve3", "stencil7_apply"):
        check(launches[name] == 24, f"simulate3: {name} launched {launches[name]}, not 24")
    check(integ.all_converged(), "simulate3: a Krylov solve missed its tolerance")
    check_norms("simulate3", h_norms(LOCAL_OPS3, g, fin), MODELLER_CPU_X64["three_d"]["final_norms"])
    t0 = time.perf_counter()
    _g, fin_cpu, _ = simulate3("cpu")
    worst = max(rel_to_max(a.cpu(), b) for a, b in zip(fin, fin_cpu) if b.abs().max() > 0)
    log(f"[simulate3] card vs the CPU plain run: worst field rel {worst:.3e} (limit 1e-10; "
        f"CPU {time.perf_counter() - t0:.1f} s)")
    check(worst <= 1e-10, "simulate3: the card and the CPU disagree")
    return launches


def phase_adaptive(device):
    """simulate_adaptive on the release scenario at N=256: the same accepted
    and rejected steps as CPU-x64, t within 1e-15, the state within 1e-8."""
    import torch

    from na_dd_tpu_torch.harness import simulate_adaptive
    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.ops.shifts import LOCAL_OPS

    ref = MODELLER_CPU_X64["adaptive"]
    check(all(ref[k] == v for k, v in ADAPTIVE.items()), "adaptive: the record's settings")
    g, s0 = release_setup(RELEASE_N, device)
    integ = release_integrator(g)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s, info = simulate_adaptive(integ, g, s0, **ADAPTIVE)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    attempts = info["steps"] + info["rejected"]
    log(f"[adaptive] {info} in {wall:.3f} s (first run; {attempts} host reads, one an attempt); "
        f"CPU-x64 {ref['info']}; launches {launches}")
    check((info["steps"], info["rejected"]) == (ref["info"]["steps"], ref["info"]["rejected"]),
          "adaptive: accepted/rejected steps differ from CPU-x64 (a decision flipped)")
    check(abs(info["t"] - ref["info"]["t"]) <= 1e-15, "adaptive: final t off CPU-x64")
    check(launches["bicgstab_solve"] == 3 * attempts, "adaptive: K1 launches")
    check_norms("adaptive", h_norms(LOCAL_OPS, g, s), ref["final_norms"])
    runs = steady_calls(lambda: simulate_adaptive(integ, g, s0, **ADAPTIVE))
    log(f"[adaptive] steady wall-clock {min(runs):.6f} s (one run after a warm-up)")
    return launches, min(runs)


def phase_checkpoint(device):
    """run_checkpointed, 40 steps with a checkpoint every 10, then resumed
    after the last two checkpoints are deleted: both equal the straight
    simulate() run bit for bit (and simulate() repeats its own bits)."""
    import shutil

    import torch

    from na_dd_tpu_torch.harness import simulate
    from na_dd_tpu_torch.harness.checkpoint import latest_checkpoint, run_checkpointed
    from na_dd_tpu_torch.ops.shifts import LOCAL_OPS

    g, s0 = release_setup(RELEASE_N, device)
    integ = release_integrator(g)
    straight = simulate(integ, g, s0, dt=RELEASE_DT, num_steps=RELEASE_STEPS)[0]
    again = simulate(integ, g, s0, dt=RELEASE_DT, num_steps=RELEASE_STEPS)[0]
    check(all(torch.equal(a, b) for a, b in zip(straight, again)),
          "checkpoint: two simulate() runs differ (the kernels are not deterministic)")
    directory = REPO / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(directory, ignore_errors=True)

    def step_fn(s, t, dt):
        return integ.step_fn(g, LOCAL_OPS, s, t, dt)[0]

    t0 = time.perf_counter()
    s_ck, t_fin = run_checkpointed(step_fn, s0, t0=0.0, dt=RELEASE_DT, num_steps=RELEASE_STEPS,
                                   directory=str(directory), every=10)
    wall = time.perf_counter() - t0
    names = sorted(p.name for p in directory.glob("*.npz"))
    log(f"[checkpoint] {RELEASE_STEPS} steps, t = {t_fin!r}, in {wall:.3f} s; files {names}")
    check(len(names) == 4 and abs(t_fin - RELEASE_STEPS * RELEASE_DT) <= 1e-15,
          "checkpoint: four checkpoints and the final t")
    check(all(torch.equal(a, b) for a, b in zip(s_ck, straight)),
          "checkpoint: the checkpointed run is not the straight run bit for bit")
    for name in names[-2:]:
        (directory / name).unlink()
        (directory / f"{name}.meta.json").unlink()
    check(latest_checkpoint(str(directory)).endswith("ckpt_00000020.npz"), "checkpoint: resume point")
    s_res, _ = run_checkpointed(step_fn, s0, t0=0.0, dt=RELEASE_DT, num_steps=RELEASE_STEPS,
                                directory=str(directory), every=10)
    check(all(torch.equal(a, b) for a, b in zip(s_res, straight)),
          "checkpoint: the resumed run is not the straight run bit for bit")
    log("[checkpoint] checkpointed and resumed (from step 20) runs equal simulate() bit for bit")
    shutil.rmtree(directory, ignore_errors=True)
    return wall


def release_leaves(params, device):
    import torch

    return {k: torch.tensor(v, dtype=torch.float64, device=device, requires_grad=True)
            for k, v in params.items()}


def five_gradients(g, s0, num_steps, **kw):
    """The dissolved fraction after ``num_steps`` and its gradient in the
    five BASE parameters: (value, {key: gradient}, launches, launches on
    float32 operands)."""
    import torch

    from na_dd_tpu_torch.harness import build_simulator, dissolved_drug_fraction
    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.ops.shifts import LOCAL_OPS

    sim = build_simulator(g, dt=RELEASE_DT, num_steps=num_steps, base_consts=release_consts(), **kw)
    params = release_leaves(RELEASE_BASE, g.device)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    value = dissolved_drug_fraction(LOCAL_OPS, g, sim(params, s0))
    grads = torch.autograd.grad(value, list(params.values()))
    launches, launches32 = dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_F32)
    return float(value.detach()), {k: float(v) for k, v in zip(params, grads)}, launches, launches32


def check_gradients(label, value, grads, ref):
    rel_v = abs(value - ref["value"]) / abs(ref["value"])
    rels = {k: abs(grads[k] - ref["grads"][k]) / abs(ref["grads"][k]) for k in grads}
    log(f"[{label}] dissolved {value!r} (rel {rel_v:.3e}); gradients "
        + ", ".join(f"{k} {grads[k]!r} (rel {rels[k]:.3e})" for k in grads))
    check(rel_v <= MODELLER_RTOL and max(rels.values()) <= MODELLER_RTOL,
          f"{label}: off the CPU-x64 gradients")


class K1Recorder:
    """Within a ``with`` block, ``kernels.bicgstab_solve`` keeps every
    call's iteration count (a device tensor, read after the block) and the
    operands of its last ``keep`` calls."""

    def __init__(self, keep):
        self.keep, self.iters, self.last = keep, [], []

    def __enter__(self):
        from na_dd_tpu_torch.ops import kernels

        self.kernels, self.inner = kernels, kernels.bicgstab_solve

        def recording(st, b, inv_diag, mask, *, tol, iters):
            x, info = self.inner(st, b, inv_diag, mask, tol=tol, iters=iters)
            self.iters.append(info["iters"])
            self.last = (self.last + [(st, b, inv_diag, mask, tol, iters)])[-self.keep:]
            return x, info

        kernels.bicgstab_solve = recording
        return self

    def __exit__(self, *exc):
        self.kernels.bicgstab_solve = self.inner

    def counts(self):
        return [int(i) for i in self.iters]


def split_iterations(counts, solves_a_step, steps):
    """(forward, recompute, adjoint) K1 iterations of a remat gradient run:
    the forward's solves, then, step by step backwards, the step's
    recomputed solves and its adjoint solves."""
    n, k = solves_a_step * steps, solves_a_step
    back = counts[n:]
    recompute = sum(sum(back[j:j + k]) for j in range(0, len(back), 2 * k))
    adjoint = sum(sum(back[j + k:j + 2 * k]) for j in range(0, len(back), 2 * k))
    return sum(counts[:n]), recompute, adjoint


def check_adjoint(label, operands):
    """K1 on one adjoint system of a gradient run (transposed planes, the
    cotangent as rhs) against its plain version (≤1e-12 relative in f64,
    1e-4 in f32; the same iterations, converged within the budget).
    Returns (K1's solution, the plain one, the iterations)."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    st_t, rhs, inv, m, tol, iters = operands
    xk, ik = kernels.bicgstab_solve(st_t, rhs, inv, m, tol=tol, iters=iters)
    xp, ip = kernels.bicgstab_solve_plain(st_t, rhs, inv, m, tol=tol, iters=iters)
    err = rel_to_max(xk, xp)
    n_it = int(ik["iters"])
    log(f"[gradients] K1 on the transposed planes, {label}: rel to plain {err:.3e}, iterations "
        f"{n_it} (plain {int(ip['iters'])}, budget {iters}), converged {bool(ik['converged'])}")
    check(err <= (1e-12 if rhs.dtype == torch.float64 else 1e-4) and n_it == int(ip["iters"])
          and bool(ik["converged"]) and bool(ip["converged"]) and n_it < iters,
          f"adjoint K1 {label}: off its plain version or unconverged")
    return xk, xp, n_it


def adjoint_row(label, operands):
    """:func:`check_adjoint`, then the timing row of K1 on that system."""
    xk, xp, _ = check_adjoint(label, operands)
    st_t, rhs, inv, m, tol, iters = operands
    row = solve_row(st_t, rhs, m, tol=tol, iters=iters, label=label, inv=inv)
    row["max_abs_err"] = float((xk - xp).abs().max())
    return row


def phase_gradients(device):
    """IFT gradients of the dissolved fraction after 40 steps at N=256
    (full Krylov, krylov_unroll=24, remat): the five BASE parameters and
    the initial state along a seeded direction against CPU-x64, a central
    difference in Kd on the card, the adjoint solves checked directly, the
    launches of one gradient evaluation, its wall-clock and peak memory
    with and without remat; the mixed and direct configurations at N=64."""
    import torch

    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.harness import build_simulator, dissolved_drug_fraction
    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.ops.shifts import LOCAL_OPS

    ref = MODELLER_CPU_X64["gradients"]
    g, s0 = release_setup(RELEASE_N, device)
    # forward, the recomputation of each step under remat, and the adjoint:
    # three solves a step in each, each solve one K1 and one K2 launch
    want = 3 * 3 * RELEASE_STEPS
    with K1Recorder(keep=3) as rec:
        value, grads, grad_launches, _ = five_gradients(g, s0, RELEASE_STEPS, krylov_unroll=24,
                                                        remat=True)
    fwd_it, rec_it, adj_it = split_iterations(rec.counts(), 3, RELEASE_STEPS)
    log(f"[gradients] one value-and-grad at N={RELEASE_N}, {RELEASE_STEPS} steps, remat: launches "
        f"{grad_launches} (predicted K1 {want}, K2 {want}); K1 iterations: forward {fwd_it}, "
        f"recompute {rec_it}, adjoint {adj_it}")
    check(rec_it == fwd_it, "gradients: the recomputed solves took other iterations than the forward")
    adjoint_step1 = rec.last  # the adjoint solves of step 1: cd, cl, T
    for name in ("bicgstab_solve", "stencil5_apply"):
        check(grad_launches[name] == want,
              f"gradients: {name} launched {grad_launches[name]}, not {want}")
    check_gradients("gradients", value, grads, ref)

    sim = build_simulator(g, dt=RELEASE_DT, num_steps=RELEASE_STEPS, base_consts=release_consts(),
                          krylov_unroll=24)
    rng = np.random.default_rng(DIRECTION_SEED)
    direction = [torch.as_tensor(rng.standard_normal(tuple(g.xx.shape)), device=device)
                 * g.interior_mask for _ in range(5)]
    leaves = State(*(u.detach().clone().requires_grad_() for u in s0))
    grad_s = torch.autograd.grad(dissolved_drug_fraction(LOCAL_OPS, g, sim({}, leaves)), list(leaves))
    directional = float(sum(torch.sum(a * b) for a, b in zip(grad_s, direction)))
    rel_s = abs(directional - ref["state_directional"]) / abs(ref["state_directional"])
    log(f"[gradients] initial-state derivative along the seeded direction {directional!r} "
        f"(CPU-x64 {ref['state_directional']!r}, rel {rel_s:.3e})")
    check(rel_s <= MODELLER_RTOL, "gradients: initial-state derivative off CPU-x64")

    kd = RELEASE_BASE["Kd"]
    h = kd * 1e-5
    with torch.no_grad():
        f_p = float(dissolved_drug_fraction(LOCAL_OPS, g, sim({"Kd": kd + h}, s0)))
        f_m = float(dissolved_drug_fraction(LOCAL_OPS, g, sim({"Kd": kd - h}, s0)))
    fd = (f_p - f_m) / (2 * h)
    rel_fd = abs(grads["Kd"] - fd) / abs(fd)
    log(f"[gradients] central difference in Kd (relative step 1e-5) {fd!r}: AD rel {rel_fd:.3e}")
    check(rel_fd <= 1e-5, "gradients: the Kd gradient disagrees with its central difference")

    timings = {}
    for remat in (True, False):
        sim_r = build_simulator(g, dt=RELEASE_DT, num_steps=RELEASE_STEPS,
                                base_consts=release_consts(), krylov_unroll=24, remat=remat)

        def value_and_grad():
            params = release_leaves(RELEASE_BASE, device)
            v = dissolved_drug_fraction(LOCAL_OPS, g, sim_r(params, s0))
            return v, torch.autograd.grad(v, list(params.values()))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        value_and_grad()
        peak = torch.cuda.max_memory_allocated() - base
        runs = steady_calls(value_and_grad)
        timings[remat] = (min(runs), peak)
        log(f"[gradients] value-and-grad, remat={remat}: {min(runs):.6f} s (one run after a "
            f"warm-up), peak memory above the inputs {peak / 1e6:.1f} MB")

    def forward():
        with torch.no_grad():
            return dissolved_drug_fraction(LOCAL_OPS, g, sim(release_leaves(RELEASE_BASE, device), s0))

    fwd = min(steady_calls(forward))
    log(f"[gradients] one forward (no grad) {fwd:.6f} s; value-and-grad / forward "
        f"{timings[True][0] / fwd:.2f} (remat), {timings[False][0] / fwd:.2f} (stored)")

    # all three step-1 adjoints against their plain solves; the T one,
    # whose row is reported, also timed
    rows = {}
    shape = "x".join(str(n) for n in s0.T.shape)
    cd_adjoint, cl_adjoint, t_adjoint = adjoint_step1
    for operands, name in ((cd_adjoint, "cd"), (cl_adjoint, "cl")):
        check_adjoint(f"f64 {shape} step-1 {name} adjoint", operands)
    rows["adjoint"] = adjoint_row(f"f64 {shape} step-1 T adjoint", t_adjoint)
    del adjoint_step1, cd_adjoint, cl_adjoint, t_adjoint

    configs = {}
    for name, kw in (("mixed", dict(precision="mixed", krylov_unroll=24)),
                     ("direct", dict(linear_solver="direct"))):
        g64, s64 = release_setup(SMALL_N, device)
        with K1Recorder(keep=9) as rec:
            value, grads, launches, launches32 = five_gradients(g64, s64, 10, **kw)
        if name == "mixed":
            # the last nine float32 solves: three passes each of the step-1
            # cd, cl and T adjoints; the T adjoint's first pass solves for the
            # whole cotangent
            mixed_t_adjoint = rec.last[-3]
        log(f"[gradients] {name} at N={SMALL_N}, 10 steps: launches {launches}, float32 "
            f"{launches32}")
        ref_cfg = MODELLER_CPU_X64["configs"][name]
        if name == "mixed":
            # The K3 gradient (~6e-16) runs through a tiny T adjoint whose
            # float32 inner solves reach float32's subnormal range.  XLA:CPU
            # flushes subnormals to zero, so the JAX package's mixed K3 is
            # 5.2e-8 off the exact value, its direct record; the card keeps
            # gradual underflow, as the port does on the CPU.  The test
            # test_mixed_k3_gradient_moves_only_by_float32_underflow shows
            # the cause at N=12: with the observable scaled by 2**32 the JAX
            # package's mixed K3 is the port's to 2e-16, and the unscaled
            # port's to 1.3e-11.  So the card's mixed K3 is held to the
            # direct record.
            k3_direct = MODELLER_CPU_X64["configs"]["direct"]["grads"]["K3"]
            log(f"[gradients mixed] K3 held to the direct record {k3_direct!r} (the mixed record "
                f"{ref_cfg['grads']['K3']!r} flushed float32 subnormals)")
            ref_cfg = dict(ref_cfg, grads=dict(ref_cfg["grads"], K3=k3_direct))
        check_gradients(f"gradients {name}", value, grads, ref_cfg)
        configs[name] = (launches, launches32)
    # the mixed gradient: 30 solves in each of forward, recompute and
    # adjoint, each three float32 K1 passes (refine 2)
    check(configs["mixed"][1]["bicgstab_solve"] == 3 * 3 * 30,
          "gradients mixed: float32 K1 launches (270 predicted)")
    check(configs["direct"][0]["bicgstab_solve"] == 0, "gradients direct: K1 launched")
    rows["adjoint_f32"] = adjoint_row(
        f"f32 {SMALL_N + 1}x{SMALL_N + 1} step-1 T adjoint, first pass (mixed)", mixed_t_adjoint)
    return grad_launches, configs["mixed"][1], timings, fwd, rows


def phase_direct(device):
    """The pol N=256 main level with linear_solver="direct" against CPU-x64;
    the step-1 BCR solutions against K1's; steady wall-clock in turns with
    the Krylov level."""
    import torch

    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.ops.direct_solve import stencil5_solve_direct

    systems, solver = step1_systems(torch.float64, device)
    for (st, b, mask), name in zip(systems, ("T", "cl", "cd")):
        x_bcr = stencil5_solve_direct(st, b, mask)
        x_k1, info = kernels.bicgstab_solve(st, b, jacobi(st, mask), mask, tol=1e-13,
                                            iters=solver.iters)
        rel = rel_to_max(x_bcr, x_k1)
        res = float(torch.linalg.norm((b - kernels.stencil5_apply(st, x_bcr)) * mask)
                    / torch.linalg.norm(b))
        log(f"[direct] step-1 {name}: BCR vs K1 rel {rel:.3e} (limit 1e-10), BCR true residual "
            f"{res:.3e} of |b| (limit 1e-12); K1 {int(info['iters'])} iterations")
        check(rel <= 1e-10 and res <= 1e-12, f"direct: step-1 {name} BCR solve")
    st, b, mask = systems[0]
    bcr_ms = time_ms(lambda: stencil5_solve_direct(st, b, mask), 5)
    k1_ms = time_ms(lambda: kernels.bicgstab_solve(st, b, jacobi(st, mask), mask, tol=1e-13,
                                                   iters=solver.iters), 20)
    log(f"[direct] one BCR solve of the step-1 T system {bcr_ms:.3f} ms against the K1 call "
        f"{k1_ms:.3f} ms (CUDA events, calls back to back)")
    del systems, st, b, mask

    trial, dt = make_trial(MAIN_N, torch.float64, device, linear_solver="direct")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    s = trial.run_for_errors(Tf=TF, dt=dt)
    first = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    err = s.overall_combined_error
    rel = abs(err - N256_CPU_X64) / N256_CPU_X64
    log(f"[direct] pol N=256 direct: error {err!r} (CPU-x64 {N256_CPU_X64!r}, rel {rel:.3e}); "
        f"launches {launches}; first run {first:.3f} s")
    check(rel <= 1e-8, "direct: the N=256 level off CPU-x64")
    check(bool(s.series.krylov_converged.all()), "direct: a true-residual verdict failed")
    check(launches["bicgstab_solve"] == 0 and launches["stencil5_apply"] == 123,
          "direct: launches (0 K1, 123 K2 for the verdicts)")
    trial_k, _ = make_trial(MAIN_N, torch.float64, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trial_k.run_for_errors(Tf=TF, dt=dt)
    krylov = time.perf_counter() - t0
    log(f"[direct] wall-clock, kernels warm: direct {first:.6f} s, Krylov {krylov:.6f} s")
    return launches, first, krylov, err


def phase_fit(device):
    """fit_parameters at N=64, 10 steps: Kd 2e-2 → 1e-2 in 25 iterations of
    Adam (lr 0.2); the loss falls by 1e-2, Kd within 5 %, the first 10
    losses within 1e-6 of CPU-x64's."""
    import torch

    from na_dd_tpu_torch.harness import build_simulator, dissolved_drug_fraction, fit_parameters
    from na_dd_tpu_torch.ops.shifts import LOCAL_OPS

    ref = MODELLER_CPU_X64["fit"]
    g, s0 = release_setup(SMALL_N, device)
    sim = build_simulator(g, dt=RELEASE_DT, num_steps=10, base_consts=release_consts(),
                          krylov_unroll=24)

    def obs(s):
        return dissolved_drug_fraction(LOCAL_OPS, g, s)

    with torch.no_grad():
        target = obs(sim({"Kd": 1e-2}, s0))
    t0 = time.perf_counter()
    fitted, history = fit_parameters(sim, obs, target, {"Kd": 2e-2}, s0, num_iterations=25,
                                     learning_rate=0.2)
    wall = time.perf_counter() - t0
    worst = max(abs(a - b) / b for a, b in zip(history[:10], ref["history"][:10]))
    log(f"[fit] {wall:.3f} s for 25 iterations; Kd {fitted['Kd']!r} (CPU-x64 {ref['fitted']['Kd']!r});"
        f" loss {history[0]:.6e} -> {history[-1]:.6e}; first 10 losses vs CPU-x64 worst rel "
        f"{worst:.3e} (limit 1e-6)")
    check(history[-1] < history[0] * 1e-2, "fit: the loss did not fall by 1e-2")
    check(abs(fitted["Kd"] - 1e-2) <= 0.05 * 1e-2, "fit: Kd not within 5 % of 1e-2")
    check(worst <= 1e-6, "fit: the first 10 losses off CPU-x64")
    return wall


# ---------------------------------------------------------------------------
# the batch axis: the ladders and the eta sweeps as one batch
# ---------------------------------------------------------------------------
def compare_batched_solve(st, b, inv_diag, mask, *, tol, iters, xtol, label):
    """K1 (planes) or K5 (volumes) on a stack of systems: ONE launch against
    the batched plain version (each system's iteration count equal, x within
    ``xtol`` of the plain stack's max-norm) and each system against the
    unbatched kernel on it alone (equal iterations, x within ``xtol``: the
    blocks split the sums differently, so not bit for bit).  Returns (max abs
    error against the plain version, the iteration counts)."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    planes = b.dim() == 3
    tag = "k1" if planes else "k5"
    solve = kernels.bicgstab_solve if planes else kernels.bicgstab_solve3
    plain = kernels.bicgstab_solve_plain if planes else kernels.bicgstab_solve3_plain
    name = "bicgstab_solve" if planes else "bicgstab_solve3"
    before = kernels.LAUNCHES[name]
    xk, ik = solve(st, b, inv_diag, mask, tol=tol, iters=iters)
    check(kernels.LAUNCHES[name] == before + 1, f"{label}: a batched solve made more than one launch")
    xp, ip = plain(st, b, inv_diag, mask, tol=tol, iters=iters)
    torch.cuda.synchronize()
    itk, itp = ik["iters"].tolist(), ip["iters"].tolist()
    rel = rel_to_max(xk, xp)
    worst_one = 0.0
    for k in range(b.shape[0]):
        x1, i1 = solve(type(st)(*(c[k] for c in st)), b[k], inv_diag[k], mask[k], tol=tol,
                       iters=iters)
        check(int(i1["iters"]) == itk[k], f"{tag.upper()} {label}: system {k} took "
              f"{int(i1['iters'])} iterations alone and {itk[k]} in the batch")
        if float(x1.abs().max()) > 0:
            worst_one = max(worst_one, rel_to_max(xk[k], x1))
        else:
            check(float(xk[k].abs().max()) == 0.0, f"{label}: system {k} should be x = 0")
    log(f"[{tag} batched] {label}: iters kernel {itk} plain {itp}, max rel diff x {rel:.3e} "
        f"to the plain stack, {worst_one:.3e} to each system alone (limit {xtol:g})")
    check(bool(torch.isfinite(xk).all()), f"{tag.upper()} {label}: x not finite")
    check(itk == itp, f"{tag.upper()} {label}: iteration counts differ")
    check(rel <= xtol and worst_one <= xtol, f"{tag.upper()} {label}: x disagrees")
    return float((xk - xp).abs().max()), itk


def compare_batched_apply(st, u, *, tol, label):
    """K2 (planes) or K6 (volumes) on a stack against its plain version."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    planes = u.dim() == 3
    apply = kernels.stencil5_apply if planes else kernels.stencil7_apply
    plain = kernels.stencil5_apply_plain if planes else kernels.stencil7_apply_plain
    k, p = apply(st, u), plain(st, u)
    torch.cuda.synchronize()
    rel = rel_to_max(k, p)
    tag = "k2" if planes else "k6"
    log(f"[{tag} batched] {label}: max rel diff {rel:.3e} (limit {tol:g})")
    check(bool(torch.isfinite(k).all()) and rel <= tol, f"{tag.upper()} {label} disagrees")
    return float((k - p).abs().max())


def batched_edge_cases(device, shapes):
    """A stack of b = 0 (done at iteration 0), a dominant system that the
    budget of 3 cuts, and A = c0 I (one iteration), at each shape (grids
    under one block and ragged ones), float64 and float32."""
    import torch

    from na_dd_tpu_torch.integrators.pc_trapezoidal import default_krylov_tol

    rng = np.random.default_rng(9)
    for dtype, xtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        for shape in shapes:
            m = np.zeros(shape)
            m[(slice(1, -1),) * len(shape)] = 1.0
            mask = torch.as_tensor(m, dtype=dtype, device=device)
            systems = []
            for case in ("zero rhs", "dominant", "diagonal"):
                st, b = random_planes(rng, shape, dtype, device, dominant=True)
                st, b = type(st)(*(c * mask for c in st)), b * mask
                if case == "zero rhs":
                    b = torch.zeros_like(b)
                elif case == "diagonal":
                    st = type(st)(st[0], *(torch.zeros_like(c) for c in st[1:]))
                systems.append((st, b))
            st = type(systems[0][0])(*(torch.stack(c) for c in zip(*(s for s, _ in systems))))
            b = torch.stack([b for _, b in systems])
            masks = mask.expand(3, *shape).contiguous()
            _, used = compare_batched_solve(
                st, b, jacobi(st, masks), masks, tol=default_krylov_tol(dtype), iters=3,
                xtol=xtol, label=f"{str(dtype)[6:]} b=0 / budget-cut / diagonal {shape}")
            check(used == [0, 3, 1], f"batched edge cases {shape}: iterations {used}, "
                  "expected [0, 3, 1]")


def batched_kernel_checks(systems, iters, label):
    """The batched solve and apply on a path's step-1 stacks (the T, cl and cd
    systems of every level): float64 at 1e-12 and float32 at 1e-4 (the solve)
    and 1e-14 / 1e-6 (the apply).  Returns the float64 solve's and apply's max
    abs errors against the plain versions."""
    import torch

    from na_dd_tpu_torch.integrators.pc_trapezoidal import default_krylov_tol

    err_solve = err_apply = 0.0
    for dtype, xtol, atol in ((torch.float64, 1e-12, 1e-14), (torch.float32, 1e-4, 1e-6)):
        for name, (st, b, mask) in zip(("T", "cl", "cd"), systems):
            st_d = type(st)(*(c.to(dtype) for c in st))
            b_d, mask_d = b.to(dtype), mask.to(dtype)
            e, _ = compare_batched_solve(st_d, b_d, jacobi(st_d, mask_d), mask_d,
                                         tol=default_krylov_tol(dtype), iters=iters, xtol=xtol,
                                         label=f"{str(dtype)[6:]} {label} step-1 {name}")
            a = compare_batched_apply(st_d, b_d, tol=atol,
                                      label=f"{str(dtype)[6:]} {label} step-1 {name}")
            if dtype == torch.float64:
                err_solve, err_apply = max(err_solve, e), max(err_apply, a)
    return err_solve, err_apply


def batched_step1(build, ops):
    """The batch's three Newton stacks of its first sweep of step 1, as
    RecordingSolver keeps them."""
    import torch

    integ = build["integrator"]
    rec = integ.solver = RecordingSolver(integ.solver)
    integ.step_fn(build["grid"], ops, build["state"], torch.zeros_like(build["dt"]), build["dt"])
    integ.solver = rec.inner
    return rec.systems[:3], rec.inner.iters


def batched_timing_rows(st, b, mask, iters, label):
    """Timing rows of the batched solve and apply on one step-1 stack."""
    name_s, name_a = (("bicgstab_solve", "stencil5_apply") if len(st) == 5
                      else ("bicgstab_solve3", "stencil7_apply"))
    return {name_a: apply_row(st, b, label),
            name_s: solve_row(st, b, mask, tol=1e-13, iters=iters, label=label)}


def steady_pair(runs, repeats=3):
    """``repeats`` wall-clock times of each ``{name: callable}`` (each ends
    in its own host transfer), after a warm-up of each, in turns."""
    for fn in runs.values():
        fn()
    return turns(runs, repeats)[1]


def profile_batched(label, run_steps, steps):
    """``steps`` batched steps under torch.profiler: launches a step and the
    device's idle share."""
    wall, found = profile_device(run_steps)
    busy_us = sum(us for _, us in found.values())
    launches = sum(c for c, _ in found.values())
    log(f"[profile] {steps} steps of {label}: wall {wall:.6f} s, device busy "
        f"{busy_us / 1e6:.6f} s ({100 * busy_us / 1e6 / wall:.2f} %), idle "
        f"{100 * (1 - busy_us / 1e6 / wall):.2f} %, {launches} kernel launches "
        f"({launches / steps:.0f} per step)")
    return launches / steps, 100 * (1 - busy_us / 1e6 / wall)


def phase_batched(device):
    """The pol spatial ladder N=2..256 as ONE batch of 8 levels padded to
    257^2 (run_spatial_ladder_batched), float64: the batched K1/K2 against
    their plain versions and against the unbatched kernels on the ladder's
    step-1 stacks and on edge-case stacks; the main path with its launch
    counts (the finest level's 41 steps: 123 K1 and 123 K2); every level
    against CPU-x64 (1e-8) and the port's serial ladder on the card (1e-10;
    the serial ladder runs once, untimed: its wall-clock, 3.71-5.14 s, is
    on record in PERF.md); the batched ladder's steady wall-clock; five
    batched steps under the profiler; the timing rows at 8 x 257^2."""
    import torch

    from na_dd_tpu_torch.harness.batched_ladder import (
        build_spatial_ladder_batched,
        run_spatial_ladder_batched,
    )
    from na_dd_tpu_torch.harness.trial import ALL_VARIABLES, DEFAULT_INTEGRAL_VARS, _simulate
    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.ops.shifts import BATCHED_OPS

    ladder = build_spatial_ladder_batched("pol", levels=BATCH_LEVELS, device=device)
    systems, iters = batched_step1(ladder, BATCHED_OPS)
    check(tuple(systems[0][1].shape) == (8, 257, 257), "the ladder's stack should be 8 x 257^2")
    err_solve, err_apply = batched_kernel_checks(systems, iters, "8x257^2 ladder")
    batched_edge_cases(device, ((9, 9), (130, 257)))

    # the main path: counts set to 0 just before, read just after
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = run_spatial_ladder_batched("pol", levels=BATCH_LEVELS, device=device, verbose=False)
    launches = dict(kernels.LAUNCHES)
    nsteps = max(ladder["nsteps"])
    log(f"[batched] pol ladder N={res['Ns'][0]}..{res['Ns'][-1]} in one batch: {nsteps} steps, "
        f"launches {launches}, Krylov budget {res['krylov_unroll']}, first run "
        f"{res['compile_plus_run_s']:.3f} s")
    check(nsteps == 41, "the batched ladder should run the finest level's 41 steps")
    for name in ("bicgstab_solve", "stencil5_apply"):
        check(launches[name] == 3 * nsteps,
              f"{name} launched {launches[name]} times, expected {3 * nsteps}")
    for name in ("bicgstab_solve3", "stencil7_apply", "triple_solve"):
        check(launches[name] == 0, f"the batched 2-D ladder launched {name}")

    # the serial ladder on the card, once and untimed
    serial_err = {}
    for N in res["Ns"]:
        tr, dt = make_study_trial(N, torch.float64, device)
        serial_err[N] = tr.run_for_errors(Tf=TF, dt=dt).overall_combined_error
    for N, err in zip(res["Ns"], res["errors"]):
        ref = POL_SPATIAL_CPU_X64[N]
        rel_x64, rel_s = abs(err - ref) / ref, abs(err - serial_err[N]) / serial_err[N]
        log(f"[batched] N={N}: error {err!r}, vs CPU-x64 rel {rel_x64:.3e} (limit 1e-8), vs the "
            f"serial ladder {serial_err[N]!r} rel {rel_s:.3e} (limit 1e-10)")
        check(math.isfinite(err) and rel_x64 <= 1e-8, f"batched N={N} off the CPU-x64 value")
        check(rel_s <= 1e-10, f"batched N={N} off the serial ladder")

    times = steady_pair({"batched": ladder["run"]}, repeats=1)
    steady = {k: min(v) for k, v in times.items()}
    log("[batched] steady wall-clock (one run after a warm-up): batched ladder "
        f"{steady['batched']:.6f} s")

    steps = 5
    per_step, idle = profile_batched("the batched pol ladder (8 x 257^2)", lambda: _simulate(
        grid=ladder["grid"], integrator=ladder["integrator"], exact_sol_pack=ladder["case"],
        exact_stack=None, initial_state=ladder["state"], t0=0.0, dt=ladder["dt"],
        num_steps=steps, variable_names=ALL_VARIABLES, integral_vars=DEFAULT_INTEGRAL_VARS,
        ops=BATCHED_OPS, tail_grid=None, nsys=len(ladder["Ns"])).cpu(), steps)

    st, b, mask = systems[0]
    rows = batched_timing_rows(st, b, mask, iters, "f64 8x257^2 step-1 T")
    return dict(launches=launches, steady=steady, errors=res["errors"], rows=rows,
                err_solve=err_solve, err_apply=err_apply, per_step=per_step, idle=idle)


def phase_eta_batched(device):
    """The pol notebook's cell-13 sweep, 7 eta at N=32 and 20 steps, as ONE
    batch (run_eta_study_batched, which runs it twice as the JAX function
    does: 60 K1 and 60 K2 a run); every eta against CPU-x64 (1e-8) and the
    port's serial sweep on the card (1e-10; the serial sweep runs once,
    untimed: its wall-clock, 8.46 s, is on record in PERF.md); the batched
    sweep's steady wall-clock."""
    import torch

    from na_dd_tpu_torch.harness import studies
    from na_dd_tpu_torch.mms.cases import MMSCasePol
    from na_dd_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = studies.run_eta_study_batched("pol", device=device, verbose=False)
    launches = dict(kernels.LAUNCHES)
    nsteps = round(res["Tf"] / res["dt"])
    log(f"[eta batched] {len(res['etas'])} eta at N={res['N']} in one batch: {nsteps} steps, "
        f"two runs (first {res['wallclock_s'][0]:.3f} s, steady {res['steady_s'][0]:.3f} s), "
        f"launches {launches}")
    check(nsteps == 20, "the eta sweep should take 20 steps")
    for name in ("bicgstab_solve", "stencil5_apply"):
        check(launches[name] == 2 * 3 * nsteps,
              f"{name} launched {launches[name]} times, expected 2 runs x {3 * nsteps}")

    # the serial sweep on the card, once and untimed
    cfg, mc = studies.STUDIES["pol"], studies.study_consts("pol")
    dt = 5e-4  # the sweep's (notebook cell 13)
    serial = [studies._make_trial(MMSCasePol, 32, eta, mc=mc, dtype=torch.float64, device=device,
                                  krylov_unroll=studies._study_unroll(cfg, 32, dt, mc))
              .run_for_errors(Tf=0.01, dt=dt).overall_combined_error for eta in res["etas"]]
    for eta, err, ref, s in zip(res["etas"], res["errors"], ETA_BATCHED_CPU_X64, serial):
        rel_x64, rel_s = abs(err - ref) / ref, abs(err - s) / s
        log(f"[eta batched] eta={eta:g}: error {err!r}, vs CPU-x64 rel {rel_x64:.3e} (limit "
            f"1e-8), vs the serial run rel {rel_s:.3e} (limit 1e-10)")
        check(math.isfinite(err) and rel_x64 <= 1e-8, f"eta={eta} off the CPU-x64 value")
        check(rel_s <= 1e-10, f"eta={eta} off the serial run")

    sweep = studies.build_eta_study_batched("pol", device=device)
    times = steady_pair({"batched": sweep["run"]}, repeats=1)
    steady = {k: min(v) for k, v in times.items()}
    log(f"[eta batched] steady wall-clock (one run after a warm-up): batched "
        f"{steady['batched']:.6f} s")

    # K1 on the sweep's step-1 T stack (7 x 33^2: one grid, seven states)
    from na_dd_tpu_torch.integrators.pc_trapezoidal import _one_shape
    from na_dd_tpu_torch.ops.shifts import BATCHED_OPS

    integ = sweep["integrator"]
    rec = integ.solver = RecordingSolver(integ.solver)
    integ.step_fn(sweep["grid"], BATCHED_OPS, sweep["state"],
                  torch.zeros((), dtype=torch.float64, device=device), sweep["dt"])
    integ.solver = rec.inner
    st, b, mask = _one_shape(*rec.systems[0])
    err, _ = compare_batched_solve(st, b, jacobi(st, mask), mask, tol=1e-13, iters=rec.inner.iters,
                                   xtol=1e-12, label="f64 7x33^2 eta sweep step-1 T")
    row = solve_row(st, b, mask, tol=1e-13, iters=rec.inner.iters, label="f64 7x33^2 eta sweep")
    row["max_abs_err"] = err
    return dict(launches=launches, steady=steady, errors=res["errors"], row=row)


def phase_batched3(device):
    """The 3-D study ladder N=4..64 (ExpSin3, dt = 1e-2/2^k, two Newton sweeps)
    as ONE batch of 5 levels padded to 65^3 (run_spatial_ladder3_batched):
    the batched K5/K6 against their plain versions and the unbatched kernels
    on its step-1 stacks and on edge-case stacks; the main path (the finest
    level's 32 steps: 192 K5 and 192 K6); every level against CPU-x64 (1e-8),
    every solve converged; the batched ladder's steady wall-clock (the
    serial run_trial3 ladder's, 10.41-11.30 s, is on record in PERF.md and
    is no longer run); five batched steps under the profiler; the timing
    rows at 5 x 65^3."""
    import torch

    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.three_d.batched_ladder import (
        build_spatial_ladder3_batched,
        run_spatial_ladder3_batched,
    )
    from na_dd_tpu_torch.three_d.mms import MMSCaseExpSin3
    from na_dd_tpu_torch.three_d.shifts import BATCHED_OPS3

    model = Model02(default_model_consts._replace(**THREE_D_CONSTS))
    kw = dict(model=model, levels=BATCH_LEVELS3, base_N=4, dt0=1e-2, Tf=TF3)
    ladder = build_spatial_ladder3_batched(MMSCaseExpSin3, device=device, **kw)
    systems, iters = batched_step1(ladder, BATCHED_OPS3)
    check(tuple(systems[0][1].shape) == (5, 65, 65, 65), "the 3-D stack should be 5 x 65^3")
    err_solve, err_apply = batched_kernel_checks(systems, iters, "5x65^3 ladder")
    batched_edge_cases(device, ((5, 5, 5), (33, 20, 41)))

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    res = run_spatial_ladder3_batched(MMSCaseExpSin3, device=device, verbose=False, **kw)
    launches = dict(kernels.LAUNCHES)
    nsteps = max(ladder["nsteps"])
    log(f"[batched3] ExpSin3 ladder N={res['Ns'][0]}..{res['Ns'][-1]} in one batch: {nsteps} "
        f"steps, launches {launches}, first run {res['compile_plus_run_s']:.3f} s")
    check(nsteps == 32, "the batched 3-D ladder should run the finest level's 32 steps")
    for name in ("bicgstab_solve3", "stencil7_apply"):
        check(launches[name] == 6 * nsteps,
              f"{name} launched {launches[name]} times, expected {6 * nsteps}")
    for name in ("bicgstab_solve", "stencil5_apply", "triple_solve"):
        check(launches[name] == 0, f"the batched 3-D ladder launched {name}")
    check(all(res["converged"]), f"batched 3-D ladder: a solve did not converge {res['converged']}")
    for N, err in zip(res["Ns"], res["errors"]):
        ref = THREE_D_CPU_X64[N]
        rel = abs(err - ref) / ref
        log(f"[batched3] N={N}: error {err!r}, vs CPU-x64 {ref!r} rel {rel:.3e} (limit 1e-8)")
        check(math.isfinite(err) and rel <= 1e-8, f"batched 3-D N={N} off the CPU-x64 value")

    times = steady_pair({"batched": ladder["run"]}, repeats=1)
    steady = {k: min(v) for k, v in times.items()}
    log(f"[batched3] steady wall-clock (one run after a warm-up): batched ladder "
        f"{steady['batched']:.6f} s")

    steps = 5
    integ, grid, case = ladder["integrator"], ladder["grid"], ladder["case"]

    def five_steps():
        s = ladder["state"]
        for k in range(steps):
            s, _ = integ.step_fn(grid, BATCHED_OPS3, s, k * ladder["dt"], ladder["dt"])
        return s.T.sum().cpu()

    per_step, idle = profile_batched("the batched 3-D ladder (5 x 65^3)", five_steps, steps)
    st, b, mask = systems[0]
    rows = batched_timing_rows(st, b, mask, iters, "f64 5x65^3 step-1 T")
    return dict(launches=launches, steady=steady, errors=res["errors"], rows=rows,
                err_solve=err_solve, err_apply=err_apply, per_step=per_step, idle=idle)


# ---------------------------------------------------------------------------
# the solver options: probed planes, the while form, matrix-free, and in 3-D
# probing, the direct solve, the Crank-Nicolson heat solve, gradients; the
# batched ladders in mixed precision
# ---------------------------------------------------------------------------
# The JAX package's CPU-x64 values of the options (studies/options_cpu_x64.py,
# into studies/results/options_cpu_x64.json): the pol level N=64, 10 steps of
# dt = h^1.5, matrix-free with the while form; heat_mms_error (D=0.1,
# Tf=0.1, dt=Tf/20); the 3-D sin bump's sum of w_H*cd after 8 steps and its
# gradients in Kd and in the initial amplitude.
MATRIX_FREE = dict(N=64, steps=10)
MATRIX_FREE_CPU_X64 = 1.3439022196462837e-07
HEAT3_CPU_X64 = {16: 0.0002760560264005336, 32: 6.901137879103326e-05,
                 64: 1.7210125861546553e-05, 128: 4.257307425284447e-06}
# The heat errors differ from CPU-x64 by rounding of the solution (|u| <= 1):
# the port applies I - dt/2 L as assembled planes (K5's form), the JAX package
# as m*(w - dt/2 L w); 1-2 iterations a solve. Its floor is ~1e-14 absolute,
# 3e-10 of the N=64 error on the CPU plain run as on the card, so the gate to
# CPU-x64 is 1e-10 relative plus HEAT3_FLOOR; the card is held to the CPU
# plain run at 1e-10 relative.
HEAT3_FLOOR = 1e-13
GRAD3 = dict(N=64, steps=8, dt=1e-3)
GRAD3_CPU_X64 = {"value": 0.012964192303252466, "Kd": 0.007134464291374704,
                 "amplitude": 0.012895434415324552}
DIRECT3_N = 32
WHILE_BUDGET = 300  # the integrator's krylov_maxiter, the while form's cap


def counted(fn):
    """``fn()`` with the kernel launch counts set to 0 just before and read
    just after: (result, launches, float32 launches)."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_F32)


def turns(runs, repeats=1):
    """Wall-clock of each ``{name: callable}``, ``repeats`` rounds taken in
    turns, with no warm-up of their own (each route has run before in this
    process, or, for a route's first run, its kernels have).  Returns (the
    min of each, the times, each callable's last result)."""
    import torch

    times = {name: [] for name in runs}
    results = {}
    for _ in range(repeats):
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[name] = fn()
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    return {name: min(v) for name, v in times.items()}, times, results


def solve_row(st, b, mask, *, tol, iters, label, inv=None):
    """The timing row of K1 (planes) or K5 (volumes) on one system or a
    stack: device time, wrapper call, plain version, bound (each input read
    once, x written; the operations of the iterations each system takes)."""
    from na_dd_tpu_torch.ops import kernels

    nd = 2 if len(st) == 5 else 3
    solve = kernels.bicgstab_solve if nd == 2 else kernels.bicgstab_solve3
    plain = kernels.bicgstab_solve_plain if nd == 2 else kernels.bicgstab_solve3_plain
    inv = jacobi(st, mask) if inv is None else inv
    used = solve(st, b, inv, mask, tol=tol, iters=iters)[1]["iters"].reshape(-1).tolist()
    nsys = b.shape[0] if b.dim() > nd else 1
    points = 2 * nd + 1
    per_point = 2 * points - 1

    def k_solve():
        return solve(st, b, inv, mask, tol=tol, iters=iters)

    return kernel_row(
        "bicgstab_solve" if nd == 2 else "bicgstab_solve3", b.dtype,
        label=f"{label} (iterations {used})",
        device_ms=kernel_device_ms(k_solve, 20, "bicgstab_kernel"), wrapper_ms=time_ms(k_solve, 50),
        plain_ms=time_ms(lambda: plain(st, b, inv, mask, tol=tol, iters=iters), 3),
        nbytes=(points + 4) * b.numel() * b.element_size(),
        ops=(2 * per_point + 6 * 2 + 14) * (b.numel() // nsys) * sum(max(u, 1) for u in used))


def apply_row(st, u, label):
    """The timing row of K2 (planes) or K6 (volumes) on one operand."""
    from na_dd_tpu_torch.ops import kernels

    nd = 2 if len(st) == 5 else 3
    apply = kernels.stencil5_apply if nd == 2 else kernels.stencil7_apply
    plain = kernels.stencil5_apply_plain if nd == 2 else kernels.stencil7_apply_plain
    points = 2 * nd + 1
    name = "stencil5_apply" if nd == 2 else "stencil7_apply"
    k, p = apply(st, u), plain(st, u)
    # relative to the sum of the terms' magnitudes (a diffusion apply of a
    # smooth field cancels them by orders of magnitude)
    scale = float(plain(type(st)(*(c.abs() for c in st)), u.abs()).max())
    rel = float((k - p).abs().max()) / max(scale, 1e-300)
    log(f"[{'k2' if nd == 2 else 'k6'}] {label}: max diff to the plain version {rel:.3e} of the "
        "terms' magnitude (limit 1e-14)")
    check(bool(k.isfinite().all()) and rel <= 1e-14, f"{name} {label} disagrees")
    row = kernel_row(
        name, u.dtype, label=label,
        device_ms=kernel_device_ms(lambda: apply(st, u), 100, f"{name}_kernel"),
        wrapper_ms=time_ms(lambda: apply(st, u), 300), plain_ms=time_ms(lambda: plain(st, u), 30),
        nbytes=(points + 2) * u.numel() * u.element_size(), ops=(2 * points - 1) * u.numel())
    row["max_abs_err"] = float((k - p).abs().max())
    return row


def check_counts(tag, launches, expected):
    """Each kernel's launches exactly as ``expected`` (absent: 0)."""
    for name, count in launches.items():
        want = expected.get(name, 0)
        check(count == want, f"{tag}: {name} launched {count} times, expected {want}")


def phase_probe(device):
    """The pol N=256 main level with stencil_source="probe": the Newton
    planes from 5 colour probes of the linearized field graph, solved by K1
    (123 launches, 123 K2 for the verdicts); ≤1e-8 to CPU-x64 and ≤1e-12 to
    the analytic-plane level; the step-1 probed planes against the closed
    form on the card; steady wall-clock in turns with the analytic route."""
    import torch

    from na_dd_tpu_torch.ops import linsolve

    # the step-1 T planes, probed and closed-form, on the card
    trial, dt = make_trial(MAIN_N, torch.float64, device, stencil_source="probe")
    systems, _ = step1_systems(torch.float64, device, N=MAIN_N)
    integ = trial.integrator
    rec = integ.solver = RecordingSolver(integ.solver)
    integ.step_fn(trial.grid, trial.ops, trial.initial_state,
                  torch.zeros((), dtype=torch.float64, device=device), dt)
    integ.solver = rec.inner
    worst = max(rel_to_max(p, a) for (sp, _, _), (sa, _, _) in zip(rec.systems, systems)
                for p, a in zip(sp, sa))
    log(f"[probe] step-1 probed planes against the closed form: max rel {worst:.3e} (limit 1e-12)")
    check(worst <= 1e-12, "probe: the probed planes are off the closed form")
    check(isinstance(rec.systems[0][0], linsolve.Stencil5), "probe: planes are not a Stencil5")

    trial_an, _ = make_trial(MAIN_N, torch.float64, device)
    steady, _, results = turns({
        "probe": lambda: counted(lambda: trial.run_for_errors(Tf=TF, dt=dt)),
        "analytic": lambda: trial_an.run_for_errors(Tf=TF, dt=dt),
    })
    s, launches, _ = results["probe"]
    err = s.overall_combined_error
    rel_x64 = abs(err - N256_CPU_X64) / N256_CPU_X64
    rel_an = abs(err - N256_F64_PORT) / N256_F64_PORT
    log(f"[probe] pol N=256 probed planes: error {err!r}, vs CPU-x64 rel {rel_x64:.3e} (limit "
        f"1e-8), vs the analytic-plane level {N256_F64_PORT!r} rel {rel_an:.3e} (limit 1e-12); "
        f"launches {launches}; Krylov iterations {int(s.series.krylov_iters.sum())}")
    check(math.isfinite(err) and rel_x64 <= 1e-8 and rel_an <= 1e-12, "probe: off the references")
    check(bool(s.series.krylov_converged.all()), "probe: a solve did not converge")
    check_counts("probe", launches, {"bicgstab_solve": 123, "stencil5_apply": 123})

    g, ops = trial.grid, trial.ops
    t0 = torch.zeros((), dtype=torch.float64, device=device)
    per_step = {}
    for route, tr in (("probe", trial), ("analytic", trial_an)):
        per_step[route] = launches_of(
            lambda tr=tr: tr.integrator.step_fn(g, ops, tr.initial_state, t0, dt)[0].T.sum().cpu())
    log(f"[probe] launches a step: probe {per_step['probe']}, analytic {per_step['analytic']}")
    log(f"[probe] wall-clock in turns (each route warm): probe {steady['probe']:.6f} s, analytic "
        f"{steady['analytic']:.6f} s")
    return dict(launches=launches, err=err, steady=steady, per_step=per_step)


def phase_while_form(device):
    """The same level with krylov_unroll=None (the JAX package's while form):
    K1 with a budget of krylov_maxiter = 300, which breaks when done, so the
    level is bit for bit the default route's; K1 at budget 300 against 8 on
    the step-1 T system, in turns; steady wall-clock in turns."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    trial, dt = make_trial(MAIN_N, torch.float64, device, krylov_unroll=None)
    check(trial.integrator.solver.iters == WHILE_BUDGET, "while form: the budget is not 300")
    s, launches, _ = counted(lambda: trial.run_for_errors(Tf=TF, dt=dt))
    err = s.overall_combined_error
    log(f"[while] pol N=256, krylov_unroll=None: error {err!r} (the port's {N256_F64_PORT!r}); "
        f"launches {launches}; Krylov iterations {int(s.series.krylov_iters.sum())}")
    check(err == N256_F64_PORT, "while form: the level moved from the default route's bits")
    check_counts("while form", launches, {"bicgstab_solve": 123, "stencil5_apply": 123})

    systems, solver = step1_systems(torch.float64, device, N=MAIN_N)
    st, b, mask = systems[0]
    inv = jacobi(st, mask)
    err300, it300 = compare_solve(st, b, inv, mask, tol=1e-13, iters=WHILE_BUDGET, xtol=1e-12,
                                  label="step-1 T, budget 300")
    x8 = kernels.bicgstab_solve(st, b, inv, mask, tol=1e-13, iters=solver.iters)[0]
    x300 = kernels.bicgstab_solve(st, b, inv, mask, tol=1e-13, iters=WHILE_BUDGET)[0]
    check(torch.equal(x8, x300), "while form: budget 300 and the default budget differ")
    pair = {}
    for _ in range(2):
        for budget in (WHILE_BUDGET, solver.iters):
            ms = kernel_device_ms(lambda: kernels.bicgstab_solve(
                st, b, inv, mask, tol=1e-13, iters=budget), 50, "bicgstab_kernel")
            pair.setdefault(budget, []).append(ms)
    log(f"[while] K1 on the step-1 T system ({it300} iterations), device time in turns: budget "
        f"{WHILE_BUDGET} " + ", ".join(f"{1e3 * v:.2f}" for v in pair[WHILE_BUDGET])
        + f" us; budget {solver.iters} " + ", ".join(f"{1e3 * v:.2f}" for v in pair[solver.iters])
        + " us")
    row = solve_row(st, b, mask, tol=1e-13, iters=WHILE_BUDGET, label="f64 257^2 budget 300",
                    inv=inv)
    row["max_abs_err"] = err300
    trial_d, _ = make_trial(MAIN_N, torch.float64, device)
    steady, runs, _ = turns({
        "while": lambda: trial.run_for_errors(Tf=TF, dt=dt),
        "default": lambda: trial_d.run_for_errors(Tf=TF, dt=dt),
    })
    log(f"[while] steady wall-clock in turns: while form {steady['while']:.6f} s, default budget "
        f"{steady['default']:.6f} s (runs {runs})")
    return dict(launches=launches, err=err, steady=steady, row=row, pair=pair)


def phase_matrix_free(device):
    """assemble_stencil=False at pol N=64, 10 steps of the protocol's dt:
    the plain while-form BiCGStab on the linearized graph (no kernel solves
    a graph: no launch of any kernel); ≤1e-9 to the analytic route on the
    card and ≤1e-8 to CPU-x64; steady wall-clock in turns."""
    import torch

    from na_dd_tpu_torch.harness.studies import _make_trial, study_consts
    from na_dd_tpu_torch.mms.cases import MMSCasePol

    N, steps = MATRIX_FREE["N"], MATRIX_FREE["steps"]
    dt = (1.0 / N) ** 1.5
    kw = dict(mc=study_consts("pol"), krylov_unroll=None, dtype=torch.float64, device=device)
    trial = _make_trial(MMSCasePol, N, ETA, assemble_stencil=False, **kw)
    trial_an = _make_trial(MMSCasePol, N, ETA, **kw)
    s, launches, _ = counted(lambda: trial.run_for_errors(Tf=steps * dt, dt=dt))
    err = s.overall_combined_error
    s_an, launches_an, _ = counted(lambda: trial_an.run_for_errors(Tf=steps * dt, dt=dt))
    err_an = s_an.overall_combined_error
    rel_an = abs(err - err_an) / err_an
    rel_x64 = abs(err - MATRIX_FREE_CPU_X64) / MATRIX_FREE_CPU_X64
    log(f"[matrix_free] pol N={N}, {steps} steps: error {err!r}, vs the analytic route on the "
        f"card {err_an!r} rel {rel_an:.3e} (limit 1e-9), vs CPU-x64 {MATRIX_FREE_CPU_X64!r} rel "
        f"{rel_x64:.3e} (limit 1e-8); launches {launches} (analytic {launches_an}); Krylov "
        f"iterations {int(s.series.krylov_iters.sum())} (analytic "
        f"{int(s_an.series.krylov_iters.sum())})")
    check(math.isfinite(err) and rel_an <= 1e-9 and rel_x64 <= 1e-8, "matrix_free: off")
    check(bool(s.series.krylov_converged.all()), "matrix_free: a solve did not converge")
    check_counts("matrix_free", launches, {})
    steady, runs, _ = turns({
        "matrix_free": lambda: trial.run_for_errors(Tf=steps * dt, dt=dt),
        "analytic": lambda: trial_an.run_for_errors(Tf=steps * dt, dt=dt),
    })
    log(f"[matrix_free] steady wall-clock in turns: matrix-free {steady['matrix_free']:.6f} s, "
        f"analytic planes {steady['analytic']:.6f} s (runs {runs})")
    return dict(launches=launches, err=err, steady=steady)


def phase_probe3(device):
    """The first PROBE3_STEPS steps of the 3-D ExpSin3 level N=64 with
    stencil_source="probe": 7-colour probes, K5/K6 (6 each a step); the
    error after them ≤1e-10 to the analytic route's on the card (the full
    level, which the ``3d`` phase holds to CPU-x64, was cut in depth); each
    route's wall-clock (kernels warm)."""
    import torch

    from na_dd_tpu_torch.three_d.harness import run_trial3

    N, dt = MAIN_N3, dt3(MAIN_N3)
    Tf = PROBE3_STEPS * dt
    g, case, integ = make_trial3(N, torch.float64, device, stencil_source="probe")
    g_a, case_a, integ_a = make_trial3(N, torch.float64, device)
    steady, _, results = turns({
        "probe": lambda: counted(lambda: run_trial3(g, case, integ, Tf=Tf, dt=dt)),
        "analytic": lambda: run_trial3(g_a, case_a, integ_a, Tf=Tf, dt=dt),
    })
    r, launches, _ = results["probe"]
    err, ref = r["error"], results["analytic"]["error"]
    rel = abs(err - ref) / ref
    log(f"[probe3] ExpSin3 N={N} probed volumes, {PROBE3_STEPS} steps: error {err!r}, vs the "
        f"analytic route {ref!r} rel {rel:.3e} (limit 1e-10); launches {launches}")
    check(math.isfinite(err) and rel <= 1e-10 and r["krylov_converged"], "probe3: off analytic")
    want = 6 * PROBE3_STEPS
    check_counts("probe3", launches, {"bicgstab_solve3": want, "stencil7_apply": want})
    log(f"[probe3] wall-clock (kernels warm): probe {steady['probe']:.6f} s, analytic "
        f"{steady['analytic']:.6f} s")
    return dict(launches=launches, err=err, steady=steady)


PROBE3_STEPS = 8  # of the 32 steps of the 3-D N=64 level (launch-bound: ~1.4 s a step)


def phase_direct3(device):
    """ExpSin3 N=32 with linear_solver="direct" (block cyclic reduction over
    x-plane blocks, the K6 verdict a solve: 96 K6, no K5) against the Krylov
    level on the card and CPU-x64 (1e-8 each); the step-1 BCR solutions
    against K5's; one BCR solve's time beside one K5 call's; the K6 verdict
    row at 33^3; steady wall-clock in turns."""
    import torch

    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.three_d.direct_solve import stencil7_solve_direct
    from na_dd_tpu_torch.three_d.harness import run_trial3

    N = DIRECT3_N
    systems, solver = step1_systems3(N, torch.float64, device)
    for (st, b, mask), name in zip(systems[:3], ("T", "cl", "cd")):
        x_bcr = stencil7_solve_direct(st, b, mask)
        x_k5, info = kernels.bicgstab_solve3(st, b, jacobi(st, mask), mask, tol=1e-13,
                                             iters=solver.iters)
        rel = rel_to_max(x_bcr, x_k5)
        res = float(torch.linalg.norm((b - kernels.stencil7_apply(st, x_bcr)) * mask)
                    / torch.linalg.norm(b))
        log(f"[direct3] step-1 {name}: BCR vs K5 rel {rel:.3e} (limit 1e-10), BCR true residual "
            f"{res:.3e} of |b| (limit 1e-12); K5 {int(info['iters'])} iterations")
        check(rel <= 1e-10 and res <= 1e-12, f"direct3: step-1 {name} BCR solve")
    st, b, mask = systems[0]
    x_bcr = stencil7_solve_direct(st, b, mask)
    bcr_ms = time_ms(lambda: stencil7_solve_direct(st, b, mask), 3)
    k5_ms = time_ms(lambda: kernels.bicgstab_solve3(st, b, jacobi(st, mask), mask, tol=1e-13,
                                                    iters=solver.iters), 20)
    log(f"[direct3] one BCR solve of the step-1 T system at {N + 1}^3 {bcr_ms:.3f} ms against the "
        f"K5 call {k5_ms:.3f} ms (CUDA events, calls back to back)")
    verdict_row = apply_row(st, x_bcr, f"f64 {N + 1}^3 direct verdict")
    del systems, st, b, mask, x_bcr

    dt = dt3(N)
    g, case, integ = make_trial3(N, torch.float64, device, linear_solver="direct")
    g_k, case_k, integ_k = make_trial3(N, torch.float64, device)
    steady, _, results = turns({
        "direct": lambda: counted(lambda: run_trial3(g, case, integ, Tf=TF3, dt=dt)),
        "krylov": lambda: run_trial3(g_k, case_k, integ_k, Tf=TF3, dt=dt),
    })
    (r, launches, _), r_k = results["direct"], results["krylov"]
    err, err_k, ref = r["error"], r_k["error"], THREE_D_CPU_X64[N]
    rel_k, rel_x64 = abs(err - err_k) / err_k, abs(err - ref) / ref
    nsteps = round(TF3 / dt)
    log(f"[direct3] ExpSin3 N={N} direct: error {err!r}, vs Krylov on the card {err_k!r} rel "
        f"{rel_k:.3e}, vs CPU-x64 rel {rel_x64:.3e} (limits 1e-8); launches {launches}")
    check(math.isfinite(err) and rel_k <= 1e-8 and rel_x64 <= 1e-8, "direct3: off")
    check(r["krylov_converged"], "direct3: a true-residual verdict failed")
    check_counts("direct3", launches, {"stencil7_apply": 6 * nsteps})
    log(f"[direct3] wall-clock in turns (each route warm): direct {steady['direct']:.6f} s, "
        f"Krylov {steady['krylov']:.6f} s")
    return dict(launches=launches, err=err, steady=steady, bcr_ms=bcr_ms, k5_ms=k5_ms,
                row=verdict_row)


def phase_heat3(device):
    """heat_mms_error at N=16, 32, 64, 128 (D=0.1, Tf=0.1, dt=Tf/20): each
    ≤1e-10 to CPU-x64, the observed rate within 0.05 of 2 at the finest
    pair, one K5 a step (and two K6: the rhs and the verdict); K5 on the
    129^3 Crank-Nicolson planes and K6 on the diffusion planes against their
    plain versions, and their timing rows."""
    import torch

    from na_dd_tpu_torch.three_d.diffusion import diffusion_planes3, heat_mms_error, heat_planes
    from na_dd_tpu_torch.three_d.grid import make_uniform_grid3
    from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

    errors, walls = {}, {}
    steps = 20
    for N in sorted(HEAT3_CPU_X64):
        t0 = time.perf_counter()
        e, launches, _ = counted(lambda N=N: heat_mms_error(N, D=0.1, Tf=0.1, device=device))
        walls[N] = time.perf_counter() - t0
        errors[N] = e
        ref = HEAT3_CPU_X64[N]
        diff = abs(e - ref)
        log(f"[heat3] N={N}: error {e!r}, vs CPU-x64 rel {diff / ref:.3e}, abs {diff:.3e} (limit "
            f"1e-10 rel + {HEAT3_FLOOR:g}); {walls[N]:.3f} s (first run); launches {launches}")
        check(math.isfinite(e) and diff <= 1e-10 * ref + HEAT3_FLOOR, f"heat3 N={N} off CPU-x64")
        if N <= 64:
            e_cpu = heat_mms_error(N, D=0.1, Tf=0.1, device="cpu")
            rel_cpu = abs(e - e_cpu) / e_cpu
            log(f"[heat3] N={N}: card vs the CPU plain run {e_cpu!r} rel {rel_cpu:.3e} (limit 1e-10)")
            check(rel_cpu <= 1e-10, f"heat3 N={N}: the card and the CPU disagree")
        check_counts(f"heat3 N={N}", launches, {"bicgstab_solve3": steps,
                                                "stencil7_apply": 2 * steps})
    coarse, fine = sorted(errors)[-2:]
    rate = math.log2(errors[coarse] / errors[fine])
    log(f"[heat3] observed rate at N={coarse}/{fine} {rate:.4f} (limit |rate - 2| <= 0.05)")
    check(abs(rate - 2.0) <= 0.05, "heat3: the rate is off 2")
    heat_launches = launches
    t0 = time.perf_counter()
    heat_mms_error(fine, D=0.1, Tf=0.1, device=device)
    steady = time.perf_counter() - t0
    log(f"[heat3] N={fine} steady wall-clock {steady:.6f} s ({steps} steps)")

    g = make_uniform_grid3(fine, fine, fine, device=device)
    aD = torch.full_like(g.xx, 0.1)
    st = diffusion_planes3(g, LOCAL_OPS3, aD, aD, aD)
    planes = heat_planes(g, LOCAL_OPS3, st, 0.1 / steps)
    u = torch.sin(math.pi * g.xx) * torch.sin(math.pi * g.yy) * torch.sin(math.pi * g.zz)
    u = u * g.interior_mask
    side = f"{fine + 1}^3"
    err_k5, _ = compare_solve(planes, u, jacobi(planes, g.interior_mask), g.interior_mask,
                                tol=1e-12, iters=32, xtol=1e-12, label=f"{side} CN planes")
    solve = solve_row(planes, u, g.interior_mask, tol=1e-12, iters=32, label=f"f64 {side} CN heat")
    solve["max_abs_err"] = err_k5
    rhs = apply_row(st, u, f"f64 {side} CN rhs")
    return dict(launches=heat_launches, errors=errors, steady=steady, rows={
        "bicgstab_solve3": solve, "stencil7_apply": rhs})


def grad3_run(device, Kd, amp, differentiable, solver_wrap=None):
    """The 3-D sin bump (tests/test_three_d_model.py's, N=64) for GRAD3
    steps; returns (Σ w_H·cd at the end, the integrator).  With
    ``differentiable`` each step runs under torch.utils.checkpoint."""
    import torch

    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.three_d.grid import make_uniform_grid3
    from na_dd_tpu_torch.three_d.harness import make_integrator3
    from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

    N, dt = GRAD3["N"], GRAD3["dt"]
    g = make_uniform_grid3(N, N, N, device=device)
    bump = (torch.sin(math.pi * g.xx) * torch.sin(math.pi * g.yy) * torch.sin(math.pi * g.zz)
            ) * g.interior_mask
    mc = default_model_consts._replace(gamma_T=1e-2, **THREE_D_CONSTS)._replace(Kd=Kd)
    integ = make_integrator3(g, Model02(mc), differentiable=differentiable)
    if solver_wrap is not None:
        integ.solver = solver_wrap(integ.solver)

    def step(t, *fields):
        return tuple(integ.step_fn(g, LOCAL_OPS3, State(*fields), t, dt)[0])

    s = (0.2 * amp * bump, 0.1 * amp * bump, 0.0 * bump, 0.05 * amp * bump, amp * bump)
    for k in range(GRAD3["steps"]):
        t = torch.tensor(k * dt, dtype=torch.float64, device=device)
        if differentiable:
            s = torch.utils.checkpoint.checkpoint(step, t, *s, use_reentrant=False,
                                                  preserve_rng_state=False)
        else:
            s = step(t, *s)
    return LOCAL_OPS3.asum(g.w_H * s[3]), integ


def phase_gradients3(device):
    """differentiable=True on the 3-D sin bump (N=64, 8 steps): the forward
    bit for bit the non-differentiable run; the value and its gradients in
    Kd and the initial amplitude ≤1e-8 to CPU-x64 jax.grad; the adjoint K5
    solves on transposed volumes, their launches and iterations beside the
    forward's; one adjoint system held against the plain K5."""
    import torch

    from na_dd_tpu_torch.integrators.pc_trapezoidal import default_krylov_tol

    (v_plain, _), launches_fwd, _ = counted(
        lambda: grad3_run(device, 1e-2, 1.0, False))
    Kd = torch.tensor(1e-2, dtype=torch.float64, device=device, requires_grad=True)
    amp = torch.tensor(1.0, dtype=torch.float64, device=device, requires_grad=True)
    tallies = []

    def wrap(inner):
        tallies.append(IterTally(RecordingSolver(inner)))
        return tallies[-1]

    t0 = time.perf_counter()
    (value, _), launches_fwd_d, _ = counted(lambda: grad3_run(device, Kd, amp, True, wrap))
    tally = tallies[0]
    rec = tally.inner

    def total_iters():
        return int(torch.stack([torch.as_tensor(i).reshape(()) for i in tally.iters]).sum())

    n_fwd = len(rec.systems)
    fwd_iters = total_iters()
    grads, launches_bwd, _ = counted(lambda: torch.autograd.grad(value, (Kd, amp)))
    wall = time.perf_counter() - t0
    bwd_iters = total_iters() - fwd_iters
    # the backward recomputes each step's forward (the same systems and
    # iterations) and solves each transposed system once
    adj_iters = bwd_iters - fwd_iters
    check(value.item() == v_plain.item(), "gradients3: the differentiable forward moved")
    got = {"value": value.item(), "Kd": grads[0].item(), "amplitude": grads[1].item()}
    for key, ref in GRAD3_CPU_X64.items():
        rel = abs(got[key] - ref) / abs(ref)
        log(f"[gradients3] {key}: {got[key]!r}, vs CPU-x64 {ref!r} rel {rel:.3e} (limit 1e-8)")
        check(math.isfinite(got[key]) and rel <= 1e-8, f"gradients3: {key} off CPU-x64")
    log(f"[gradients3] value-and-grad {wall:.3f} s (first run); forward launches {launches_fwd_d} "
        f"({n_fwd} solves, {fwd_iters} K5 iterations); backward launches {launches_bwd} "
        f"(recompute + adjoint: {len(rec.systems) - n_fwd} solves, {bwd_iters} iterations, of "
        f"them the adjoint solves' {adj_iters})")
    check_counts("gradients3 forward", launches_fwd, {"bicgstab_solve3": 24, "stencil7_apply": 24})
    check_counts("gradients3 backward", launches_bwd, {"bicgstab_solve3": 48, "stencil7_apply": 48})

    # the last step's T adjoint system: the backward recomputes its T, cl,
    # cd solves, then solves the adjoints of cd, cl, T
    from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

    st_t, rhs, mask = rec.systems[n_fwd + 5]
    check(torch.equal(st_t.cxm, LOCAL_OPS3.shift_xm(rec.systems[n_fwd][0].cxp)),
          "gradients3: the recorded adjoint system is not the transposed T system")
    tol = default_krylov_tol(rhs.dtype)
    budget = rec.inner.iters
    err, _ = compare_solve(st_t, rhs, jacobi(st_t, mask), mask, tol=tol, iters=budget,
                             xtol=1e-12, label="65^3 adjoint (transposed volumes), last step T")
    row = solve_row(st_t, rhs, mask, tol=tol, iters=budget,
                    label="f64 65^3 adjoint (transposed volumes)")
    row["max_abs_err"] = err
    t0 = time.perf_counter()
    v2, _ = grad3_run(device, Kd, amp, True)
    torch.autograd.grad(v2, (Kd, amp))
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    t0 = time.perf_counter()
    grad3_run(device, 1e-2, 1.0, False)[0].item()
    forward = time.perf_counter() - t0
    log(f"[gradients3] steady: value-and-grad {steady:.6f} s, forward {forward:.6f} s")
    launches = {k: launches_fwd_d[k] + launches_bwd[k] for k in launches_bwd}
    return dict(launches=launches, grads=got, steady=steady, forward=forward, row=row,
                iters=(fwd_iters, adj_iters))


def phase_batched_mixed(device, f64_2d=None, f64_3d=None):
    """Both batched ladders with precision="mixed": float32 batched K1/K5 under
    per-level float64 refinement (three passes a solve: 369 float32 K1 for
    the pol ladder, 576 float32 K5 for the 3-D one); each level ≤1e-8 to
    CPU-x64 and ≤1e-12 to the float64 batched ladder; the first pass's
    float32 stacks against the plain versions; steady wall-clock in turns
    with the float64 ladders; the float32 timing rows.  ``f64_2d`` /
    ``f64_3d``: the float64 batched ladders' errors (run here when not
    given)."""
    import torch

    from na_dd_tpu_torch.harness.batched_ladder import (
        build_spatial_ladder_batched,
        run_spatial_ladder_batched,
    )
    from na_dd_tpu_torch.integrators.pc_trapezoidal import MIXED_INNER_TOL
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.ops.shifts import BATCHED_OPS
    from na_dd_tpu_torch.three_d.batched_ladder import (
        build_spatial_ladder3_batched,
        run_spatial_ladder3_batched,
    )
    from na_dd_tpu_torch.three_d.mms import MMSCaseExpSin3
    from na_dd_tpu_torch.three_d.shifts import BATCHED_OPS3

    f32 = torch.float32
    out = {}
    model = Model02(default_model_consts._replace(**THREE_D_CONSTS))
    kw3 = dict(model=model, levels=BATCH_LEVELS3, base_N=4, dt0=1e-2, Tf=TF3)
    for tag, build, run, ops, refs, f64_errs, per_step in (
        ("2d", lambda **k: build_spatial_ladder_batched("pol", levels=BATCH_LEVELS, **k),
         lambda **k: run_spatial_ladder_batched("pol", levels=BATCH_LEVELS, verbose=False, **k),
         BATCHED_OPS, POL_SPATIAL_CPU_X64, f64_2d, 3),
        ("3d", lambda **k: build_spatial_ladder3_batched(MMSCaseExpSin3, **kw3, **k),
         lambda **k: run_spatial_ladder3_batched(MMSCaseExpSin3, verbose=False, **kw3, **k),
         BATCHED_OPS3, THREE_D_CPU_X64, f64_3d, 6),
    ):
        name, apply = (("bicgstab_solve", "stencil5_apply") if tag == "2d"
                       else ("bicgstab_solve3", "stencil7_apply"))
        ladder = build(precision="mixed", device=device)
        systems, iters = batched_step1(ladder, ops)
        st, b, mask = systems[0]
        st32 = type(st)(*(c.to(f32) for c in st))
        inv32 = jacobi(st, mask).to(f32)
        err32, _ = compare_batched_solve(st32, b.to(f32), inv32, mask.to(f32), tol=MIXED_INNER_TOL,
                                         iters=iters, xtol=1e-4,
                                         label=f"f32 {tag} mixed ladder step-1 T, first pass")
        res, launches, launches32 = counted(lambda: run(precision="mixed", device=device))
        nsteps = max(ladder["nsteps"])
        solves = per_step * nsteps
        log(f"[batched_mixed] {tag} ladder N={res['Ns'][0]}..{res['Ns'][-1]} mixed: {nsteps} steps, "
            f"launches {launches}, of them float32 {launches32}")
        # three float32 solves a Newton solve; the f64 residuals of passes 2
        # and 3 and the final verdict, and each float32 solve's own residual
        check(launches32[name] == 3 * solves, f"batched_mixed {tag}: {launches32[name]} float32 "
              f"{name}, expected {3 * solves}")
        check_counts(f"batched_mixed {tag}", launches, {name: 3 * solves, apply: 6 * solves})
        check(launches32[apply] == 3 * solves, f"batched_mixed {tag}: float32 {apply}")
        if f64_errs is None:
            f64_errs = run(device=device)["errors"]
        for N, err, e64 in zip(res["Ns"], res["errors"], f64_errs):
            rel_x64, rel_64 = abs(err - refs[N]) / refs[N], abs(err - e64) / e64
            log(f"[batched_mixed] {tag} N={N}: error {err!r}, vs CPU-x64 rel {rel_x64:.3e} (limit "
                f"1e-8), vs the f64 batched ladder rel {rel_64:.3e} (limit 1e-12)")
            check(math.isfinite(err) and rel_x64 <= 1e-8 and rel_64 <= 1e-12,
                  f"batched_mixed {tag} N={N}: off")
        ladder64 = build(device=device)
        steady, _, _ = turns({"mixed": ladder["run"], "f64": ladder64["run"]})
        log(f"[batched_mixed] {tag} steady wall-clock in turns: mixed {steady['mixed']:.6f} s, "
            f"f64 {steady['f64']:.6f} s")
        row = solve_row(st32, b.to(f32), mask.to(f32), tol=MIXED_INNER_TOL, iters=iters,
                        label=f"f32 {tuple(b.shape)} mixed inner, step-1 T", inv=inv32)
        row["max_abs_err"] = err32
        out[tag] = dict(launches=launches, launches32=launches32, errors=res["errors"],
                        steady=steady, row=row)
    return out


# ---------------------------------------------------------------------------
# K4 with a batch dimension: the fused analytic batched ladder and eta sweep
# ---------------------------------------------------------------------------
_TRIPLE_STACKS = {}


def batched_triple_step1(build, ops):
    """The operands of a batch's first K4 launch (step 1's fused sweep) as
    kernels.triple_solve takes them: every operand at the batch's shape, the
    three Jacobi inverse diagonals filled in, dt one a system (a ladder) or
    a float (an eta sweep); and the Krylov budget."""
    import torch

    from na_dd_tpu_torch.integrators.pc_trapezoidal import _batch_shape

    integ = build["integrator"]
    rec = integ.solver = RecordingSolver(integ.solver)
    dt = build["dt"]
    t0 = (torch.zeros_like(dt) if isinstance(dt, torch.Tensor)
          else torch.zeros((), dtype=torch.float64, device=build["state"].T.device))
    integ.step_fn(build["grid"], ops, build["state"], t0, dt)
    integ.solver = rec.inner
    check(len(rec.triples) == 1 and not rec.systems,
          "a fused batched step should make one triple solve a sweep")
    *stencils, d, rhs_T, base_cl, base_cd, mask, dt_, _noise = rec.triples[0]
    (J_T, J_cl, J_cd, C_clT, C_cdT), (d, rhs_T, base_cl, base_cd, mask) = _batch_shape(
        stencils, (d, rhs_T, base_cl, base_cd, mask))
    operands = (J_T, J_cl, J_cd, C_clT, C_cdT, d, rhs_T, base_cl, base_cd,
                jacobi(J_T, mask), jacobi(J_cl, mask), jacobi(J_cd, mask), mask, dt_)
    return operands, rec.inner.iters


def f32_triple(operands):
    """K4's operands in float32 with the inverse diagonals of the float32
    planes, as the mixed refinement's inner solve takes them."""
    import torch

    ops32 = cast_triple(operands, torch.float32)
    mask32 = ops32[12]
    return (*ops32[:9], *(jacobi(J, mask32) for J in ops32[:3]), *ops32[12:])


def triple_stacks(device):
    """The batched K4 stacks of the fused analytic paths, built once: the
    pol ladder's 8 x 257^2 step-1 stack (each level its own dt), the eta
    sweep's 7 x 33^2 one (one grid, one dt), each with its Krylov budget."""
    from na_dd_tpu_torch.harness import studies
    from na_dd_tpu_torch.harness.batched_ladder import build_spatial_ladder_batched
    from na_dd_tpu_torch.ops.shifts import BATCHED_OPS

    if not _TRIPLE_STACKS:
        ladder = build_spatial_ladder_batched("pol", levels=BATCH_LEVELS,
                                              coupling_source="analytic", device=device)
        _TRIPLE_STACKS["ladder"] = batched_triple_step1(ladder, BATCHED_OPS)
        sweep = studies.build_eta_study_batched("pol", coupling_source="analytic", device=device)
        _TRIPLE_STACKS["eta"] = batched_triple_step1(sweep, BATCHED_OPS)
    return _TRIPLE_STACKS


def compare_triple_batched(operands, *, tol, iters, xtol, label):
    """Batched K4 (ONE launch for the stack) against its plain version on
    the same stack, system by system: equal (3,) iteration counts and
    convergence flags, each increment within ``xtol`` of the plain system's
    max-norm (an increment that is 0 must come out 0), tol_sq within 1e-10
    (float64) or 1e-4 (float32) relative.  Returns (max abs error, the
    (B, 3) iteration counts)."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    before = kernels.LAUNCHES["triple_solve"]
    *xk, ik = kernels.triple_solve(*operands, tol=tol, iters=iters)
    check(kernels.LAUNCHES["triple_solve"] == before + 1,
          f"K4 {label}: a batched triple solve made more than one launch")
    *xp, ip = kernels.triple_solve_plain(*operands, tol=tol, iters=iters)
    torch.cuda.synchronize()
    dtype = xk[0].dtype
    tiny = torch.finfo(dtype).tiny
    worst = max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(tiny))
                for a, b in zip(xk, xp) for k in range(a.shape[0]))
    itk, itp = ik["iters"].tolist(), ip["iters"].tolist()
    stol = 1e-10 if dtype == torch.float64 else 1e-4
    tol_rel = float(((ik["tol_sq"] - ip["tol_sq"]).abs()
                     / ip["tol_sq"].abs().clamp_min(tiny)).max())
    log(f"[k4 batched] {label}: iters kernel {itk} plain {itp}, max rel diff of a system's "
        f"increment {worst:.3e} (limit {xtol:g}), tol_sq rel {tol_rel:.3e} (limit {stol:g}), "
        f"converged {ik['converged'].tolist()}")
    check(all(bool(torch.isfinite(x).all()) for x in xk), f"K4 {label}: output not finite")
    check(itk == itp, f"K4 {label}: iteration counts differ")
    check(worst <= xtol, f"K4 {label}: an increment disagrees with the plain version")
    check(ik["converged"].tolist() == ip["converged"].tolist(),
          f"K4 {label}: convergence flags differ")
    check(tol_rel <= stol, f"K4 {label}: tol_sq disagrees")
    return max(float((a - b).abs().max()) for a, b in zip(xk, xp)), itk


def triple_edge_stack(device, dtype):
    """Three systems of random dominant K4 operands at 130 x 257 (a ragged
    grid), one dt a system: system 0 with rhs_T = 0 (its T solve ends before
    its first iteration while the others iterate), system 1 with diagonal
    Newton operators (every solve done in one iteration, before the
    others), system 2 as it is."""
    import torch

    rng = np.random.default_rng(411)
    sets = [list(random_triple(rng, (130, 257), dtype, device)) for _ in range(3)]
    sets[0][6] = torch.zeros_like(sets[0][6])
    for k in range(3):
        J = sets[1][k]
        sets[1][k] = type(J)(J[0], *(torch.zeros_like(c) for c in J[1:]))
    stack = []
    for i in range(13):
        items = [s[i] for s in sets]
        stack.append(type(items[0])(*(torch.stack(c) for c in zip(*items)))
                     if isinstance(items[0], tuple) else torch.stack(items))
    dt = torch.tensor([0.05, 0.02, 0.01], dtype=torch.float64, device=device)
    return (*stack, dt)


def phase_k4_batched(device):
    """Batched K4 against its plain version on the fused paths' stacks (the
    ladder's 8 x 257^2 and the eta sweep's 7 x 33^2 step-1 stacks) and on an
    edge stack (rhs_T = 0, a system done before the others), float64 at 1e-12
    and float32 at 1e-4 (the batched K1's float32 limit); a batch of one is
    bit for bit the single-system kernel.  Returns the float64 max abs errors
    of the two path stacks."""
    import torch

    from na_dd_tpu_torch.integrators.pc_trapezoidal import default_krylov_tol
    from na_dd_tpu_torch.ops import kernels

    errs = {}
    stacks = triple_stacks(device)
    for dtype, xtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        name, tol = str(dtype)[6:], default_krylov_tol(dtype)
        for key, (operands, iters) in stacks.items():
            ops_d = operands if dtype == torch.float64 else f32_triple(operands)
            shape = "x".join(str(v) for v in operands[6].shape)
            err, used = compare_triple_batched(ops_d, tol=tol, iters=iters, xtol=xtol,
                                               label=f"{name} {key} step-1 stack {shape}")
            check(min(sum(u) for u in used) > 0, f"K4 {key} stack: a system took no iteration")
            if dtype == torch.float64:
                errs[key] = err
        _, used = compare_triple_batched(triple_edge_stack(device, dtype), tol=tol, iters=40,
                                         xtol=xtol, label=f"{name} edge stack 3x130x257")
        check(used[0][0] == 0 and used[1] == [1, 1, 1] and min(used[2]) > 1,
              f"K4 edge stack: iterations {used}, expected T of system 0 at 0, system 1 "
              "at 1 a solve, system 2 over 1")
        # a batch of one launches the single-system kernel: bit for bit
        operands, solver = step1_triple(dtype, device)
        one = tuple(type(o)(*(c[None] for c in o)) if isinstance(o, tuple)
                    else (o[None] if isinstance(o, torch.Tensor) else o) for o in operands)
        *x1, i1 = kernels.triple_solve(*operands, tol=tol, iters=solver.iters)
        *xb, ib = kernels.triple_solve(*one, tol=tol, iters=solver.iters)
        same = all(torch.equal(a[0], b) for a, b in zip(xb, x1))
        log(f"[k4 batched] {name} a batch of one (1x257x257 step-1): bit for bit the single "
            f"system's {same}, iterations {ib['iters'].tolist()} against {i1['iters'].tolist()}")
        check(same and ib["iters"].tolist() == [i1["iters"].tolist()],
              "K4: a batch of one is not the single-system kernel's result")
    return errs


def triple_batched_row(operands, *, tol, iters, label):
    """Timing row of batched K4 on one stack: device time, wrapper call,
    plain version, bound (33 input planes read once and 3 written, 288 bytes
    a point in float64; per system 44 operations a point an iteration it
    takes, 29 for the couplings and rhs forms)."""
    from na_dd_tpu_torch.ops import kernels

    rhs_T = operands[6]
    nsys, n = rhs_T.shape[0], rhs_T[0].numel()
    its = kernels.triple_solve(*operands, tol=tol, iters=iters)[3]["iters"].tolist()

    def k4():
        return kernels.triple_solve(*operands, tol=tol, iters=iters)

    row = kernel_row(
        "triple_solve", rhs_T.dtype, label=f"{label} (iterations {its})",
        device_ms=kernel_device_ms(k4, 20, "triple_solve_kernel"), wrapper_ms=time_ms(k4, 50),
        plain_ms=time_ms(lambda: kernels.triple_solve_plain(*operands, tol=tol, iters=iters), 2),
        nbytes=36 * rhs_T.numel() * rhs_T.element_size(),
        ops=sum(44 * max(sum(u), 1) + 29 for u in its) * n)
    blocks = kernels._BLOCKS.get(("triple_solve", rhs_T.dtype, n, nsys))
    log(f"[time] triple_solve {label}: cooperative grid {blocks} blocks of 256 threads "
        f"({blocks // nsys if blocks else None} a system)")
    return row


def phase_batched_analytic(device, per_solve=None, eta_per_solve=None):
    """The fused analytic batched paths (coupling_source="analytic"), each
    Newton sweep of the whole batch ONE launch of batched K4: the pol ladder
    N=2..256 as one batch of 8 levels in float64 (the finest level's 41
    steps: exactly 41 K4 and no K1 or K2) and in precision="mixed" (123
    float32 K4, three a step, and 615 float64 K2 for the block residuals and
    the verdicts), and the eta sweep, 7 eta at N=32 (20 K4 a run, two runs);
    every level against CPU-x64 (1e-8) and the per-solve batched routes on
    the card (1e-10; ``per_solve`` / ``eta_per_solve``, run here when not
    given); the wall-clock of the gated fused runs (the per-solve twins'
    are the ``batched`` and ``eta_batched`` phases'); the timing rows of
    batched K4 at 8 x 257^2 (float64 and the mixed float32) and 7 x 33^2."""
    import torch

    from na_dd_tpu_torch.harness import studies
    from na_dd_tpu_torch.harness.batched_ladder import run_spatial_ladder_batched
    from na_dd_tpu_torch.integrators.pc_trapezoidal import MIXED_INNER_TOL

    def ladder(**kw):
        return run_spatial_ladder_batched("pol", levels=BATCH_LEVELS, device=device,
                                          verbose=False, **kw)

    def sweep(**kw):
        return studies.run_eta_study_batched("pol", device=device, verbose=False, **kw)

    if per_solve is None:
        per_solve = ladder()["errors"]
    if eta_per_solve is None:
        eta_per_solve = sweep()["errors"]
    out = {}
    for tag, kw, expect, expect32 in (
        ("f64", {}, {"triple_solve": 41}, {}),
        ("mixed", dict(precision="mixed"), {"triple_solve": 123, "stencil5_apply": 615},
         {"triple_solve": 123}),
    ):
        # the main path: counts set to 0 just before, read just after
        res, launches, launches32 = counted(lambda: ladder(coupling_source="analytic", **kw))
        log(f"[batched_analytic] fused {tag} pol ladder N={res['Ns'][0]}..{res['Ns'][-1]} in one "
            f"batch: launches {launches}, of them float32 {launches32}, first run "
            f"{res['compile_plus_run_s']:.3f} s")
        check_counts(f"batched_analytic {tag} ladder", launches, expect)
        check_counts(f"batched_analytic {tag} ladder (float32)", launches32, expect32)
        for N, err, e_ps in zip(res["Ns"], res["errors"], per_solve):
            ref = POL_SPATIAL_CPU_X64[N]
            rel_x64, rel_ps = abs(err - ref) / ref, abs(err - e_ps) / e_ps
            log(f"[batched_analytic] {tag} N={N}: error {err!r}, vs CPU-x64 rel {rel_x64:.3e} "
                f"(limit 1e-8), vs the per-solve batched ladder rel {rel_ps:.3e} (limit 1e-10)")
            check(math.isfinite(err) and rel_x64 <= 1e-8, f"fused {tag} N={N} off CPU-x64")
            check(rel_ps <= 1e-10, f"fused {tag} N={N} off the per-solve batched ladder")
        out[tag] = dict(launches=launches, launches32=launches32, errors=res["errors"],
                        first=res["compile_plus_run_s"])

    res, launches, _ = counted(lambda: sweep(coupling_source="analytic"))
    nsteps = round(res["Tf"] / res["dt"])
    log(f"[batched_analytic] fused eta sweep, {len(res['etas'])} eta at N={res['N']}: {nsteps} "
        f"steps, two runs (first {res['wallclock_s'][0]:.3f} s, steady {res['steady_s'][0]:.3f} "
        f"s), launches {launches}")
    check(nsteps == 20, "the eta sweep should take 20 steps")
    check_counts("batched_analytic eta sweep", launches, {"triple_solve": 2 * nsteps})
    for eta, err, ref, e_ps in zip(res["etas"], res["errors"], ETA_BATCHED_CPU_X64, eta_per_solve):
        rel_x64, rel_ps = abs(err - ref) / ref, abs(err - e_ps) / e_ps
        log(f"[batched_analytic] eta={eta:g}: error {err!r}, vs CPU-x64 rel {rel_x64:.3e} (limit "
            f"1e-8), vs the per-solve batched sweep rel {rel_ps:.3e} (limit 1e-10)")
        check(math.isfinite(err) and rel_x64 <= 1e-8, f"fused eta={eta} off CPU-x64")
        check(rel_ps <= 1e-10, f"fused eta={eta} off the per-solve batched sweep")
    out["eta"] = dict(launches={k: v // 2 for k, v in launches.items()}, errors=res["errors"])

    out["steady"] = {"fused": out["f64"]["first"], "fused eta": res["steady_s"][0]}

    stacks = triple_stacks(device)
    rows = {}
    for key, (operands, iters), tol, label in (
        ("f64", stacks["ladder"], 1e-13, "f64 8x257x257 batched ladder step-1"),
        ("f32", (f32_triple(stacks["ladder"][0]), stacks["ladder"][1]), MIXED_INNER_TOL,
         "f32 8x257x257 batched mixed ladder, first pass"),
        ("eta", stacks["eta"], 1e-13, "f64 7x33x33 batched eta sweep step-1"),
    ):
        rows[key] = triple_batched_row(operands, tol=tol, iters=iters, label=label)
        rows[key]["max_abs_err"] = compare_triple_batched(
            operands, tol=tol, iters=iters, xtol=1e-12 if key != "f32" else 1e-4,
            label=f"{label} (timed)")[0]
    out["rows"] = rows
    return out


# the parallel phase: the pol level N=255 (256 rows over 4 ranks; the main
# level's 257 rows do not divide), 5 steps; the 2 x 2 checks; the ensemble
PAR_N, PAR_STEPS, PAR_WORLD = 255, 5, 4
PAR_SMALL_N, PAR_N3 = 15, 31
PAR_ENSEMBLE = dict(study="pol", N=64, Tf=0.01, dt=5e-4)  # the JAX study's defaults
PAR_K1_B = 32  # the batch whose step-1 T stack the kernels line times (one K1 launch)
PAR_DP_B = 8  # the batch dp=2 is held to dp=1 at
PAR_PARTS_B = 128  # a batch build_ensemble splits into parts of kernels.MAX_BATCH
# an ensemble member's final-field H-norms² against the CPU-x64 record (they
# are O(1e-3), summed in another order)
ENSEMBLE_RTOL = 1e-10


def rel_to(value, ref):
    return abs(value - ref) / abs(ref)


def par_gathered(ops, state):
    from na_dd_tpu_torch.core.state import State

    return State(*(ops.gather_full(v.detach()) for v in state))


def par_counted(ops, fn):
    """``fn()`` on this rank with the launch counts and the ops' traffic
    set to 0 just before and read just after: (result, launches, traffic,
    wall-clock s)."""
    import torch

    from na_dd_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    ops.stats.reset()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES), dict(vars(ops.stats)), time.perf_counter() - t0


def par_integrators(trial):
    """The level's integrator and its ``precision="mixed"`` twin on the same
    field (one MMS case built, not two)."""
    integ = trial.integrator
    mixed = type(integ)(trial.field, regularization_factor=ETA, track_residuals=False,
                        krylov_unroll=integ.krylov_unroll, precision="mixed")
    return {"step": integ, "mixed": mixed}


def parallel_rank(rank, device, ckpt_dir, etas_dp):
    """The body of each of the 4 ranks (gloo, every rank on the one card):
    the sharded N=255 level on a (4,) x mesh (counted, then again warm),
    saved as a sharded checkpoint; on a (2, 2) mesh the 2-D step, mixed,
    direct and value-and-grad steps and 2 steps of ExpSin3 N=31; the
    checkpoint read back by ranks 0 and 1 as a (2,) row layout; the
    ensemble at dp=2 on ranks 0 and 1 (a sub-group, as the JAX study's
    ``--dp`` takes the first devices).  Rank 0 returns the gathered
    results; every rank its launch counts and traffic."""
    import torch
    import torch.distributed as dist

    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.harness.checkpoint import load_state_sharded, save_state_sharded
    from na_dd_tpu_torch.harness.ensemble import simulate_ensemble
    from na_dd_tpu_torch.parallel import HaloOps, build_sharded_step, make_mesh
    from na_dd_tpu_torch.parallel import shard_grid_and_state
    from na_dd_tpu_torch.parallel.step import build_sharded_simulation
    from na_dd_tpu_torch.three_d import HaloOps3
    from na_dd_tpu_torch.three_d.harness import run_trial3
    from na_dd_tpu_torch.three_d.mms import state_from_mms_when3

    f64 = torch.float64
    out, counts = {}, {}
    trial, dt = make_trial(PAR_N, f64, device)
    mesh = make_mesh((PAR_WORLD,), ("x",))
    gs, ss = shard_grid_and_state(mesh, trial.grid, trial.initial_state)
    sim = build_sharded_simulation(trial.integrator, mesh, mms_case=trial.mms_case,
                                   num_steps=PAR_STEPS, t0=0.0, dt=dt)
    (s_fin, errors), counts["level"], traffic, wall = par_counted(sim.ops, lambda: sim(gs, ss))
    _, _, _, wall_warm = par_counted(sim.ops, lambda: sim(gs, ss))
    out["level"] = dict(state=par_gathered(sim.ops, s_fin), errors=errors, wall=wall,
                        wall_warm=wall_warm)
    counts["level_traffic"] = traffic
    save_state_sharded(ckpt_dir, s_fin, t=PAR_STEPS * dt, step=PAR_STEPS, ops=sim.ops)
    if rank < 2:
        layout = HaloOps(make_mesh((2,), ("x",), rank=rank), axis_x="x")
        counts["ckpt2"] = load_state_sharded(ckpt_dir, ops=layout, device=device)[0]

    mesh22 = make_mesh((2, 2), ("x", "y"))
    t0 = torch.zeros((), dtype=f64, device=device)
    g_b, s_b = shard_grid_and_state(mesh22, trial.grid, trial.initial_state, axis_x="x",
                                    axis_y="y")
    small_trial, dt_s = make_trial(PAR_SMALL_N, f64, device, linear_solver="direct")
    cases = [(key, integ, g_b, s_b, dt) for key, integ in par_integrators(trial).items()]
    cases.append(("direct", small_trial.integrator)
                 + shard_grid_and_state(mesh22, small_trial.grid, small_trial.initial_state,
                                        axis_x="x", axis_y="y") + (dt_s,))
    for key, integ, g_k, s_k, dt_k in cases:
        step = build_sharded_step(integ, mesh22, axis_x="x", axis_y="y")
        (s1, small), counts[key], _, _ = par_counted(step.ops, lambda: step(g_k, s_k, t0, dt_k))
        out[key] = dict(state=par_gathered(step.ops, s1), converged=small["krylov_converged"])

    tr, dt_g = make_trial(PAR_SMALL_N, f64, device, differentiable=True)
    g_b, s_b = shard_grid_and_state(mesh22, tr.grid, tr.initial_state, axis_x="x", axis_y="y")
    leaves = State(*(v.clone().requires_grad_(True) for v in s_b))
    step = build_sharded_step(tr.integrator, mesh22, axis_x="x", axis_y="y")

    def value_and_grad():
        s1, _small = step(g_b, leaves, t0, dt_g)
        loss = torch.sum(s1.T * s1.T) + torch.sum(s1.cd)
        loss.backward()
        return step.ops.asum(loss.detach())

    value, counts["grad"], _, _ = par_counted(step.ops, value_and_grad)
    out["grad"] = dict(value=value, grads=State(*(step.ops.gather_full(v.grad) for v in leaves)))

    g3, case3, integ3 = make_trial3(PAR_N3, f64, device)
    hops3 = HaloOps3(mesh22, axis_x="x", axis_y="y")
    g3b, _ = shard_grid_and_state(mesh22, g3, state_from_mms_when3(mms_case=case3, t=0.0, grid=g3),
                                  axis_x="x", axis_y="y")
    res, counts["sim3"], counts["sim3_traffic"], _ = par_counted(
        hops3, lambda: run_trial3(g3b, case3, integ3, Tf=2 * dt3(PAR_N3), dt=dt3(PAR_N3),
                                  ops=hops3))
    out["sim3"] = dict(state=par_gathered(hops3, res["state"]), error=res["error"],
                       converged=res["krylov_converged"])

    pair = dist.new_group([0, 1])
    if rank < 2:
        out["ensemble"] = simulate_ensemble(etas_dp, mesh=make_mesh((2,), ("b",), group=pair),
                                            device=device, **PAR_ENSEMBLE)
    return dict(out if rank == 0 else {}, counts=counts)


def par_check_state(label, got, ref, tol=1e-12):
    d = max(float((a.to(b.device) - b).abs().max()) for a, b in zip(got, ref))
    log(f"[parallel] {label}: max abs diff to the local run on the card {d:.3e} (limit {tol:g})")
    check(d <= tol, f"parallel {label}: off the local run")
    return d


def par_check_errors(label, got, ref):
    """Each error norm (the square root of each squared norm) to 1e-12 of
    itself or 1e-15 absolute, the rounding floor of the O(1) state."""
    worst = 0.0
    for a, b in zip(got, ref):
        for v in b:
            ea = np.sqrt(np.asarray(a[v].cpu(), dtype=np.float64))
            eb = np.sqrt(np.asarray(b[v].cpu(), dtype=np.float64))
            worst = max(worst, float(np.max(np.abs(ea - eb) / np.maximum(eb, 1e-300))))
            check(bool(np.all(np.abs(ea - eb) <= 1e-12 * eb + 1e-15)),
                  f"parallel {label}: the {v} error norms are off the local run")
    log(f"[parallel] {label}: error norms, max rel diff to the local run {worst:.3e} (limit "
        "1e-12, or 1e-15 absolute)")


def par_padded_block(full, rows, cols):
    """The halo-padded block ``full[rows, cols]`` a rank gives the apply
    kernel: one more line of its neighbours on each side of the first two
    dimensions, zeros past the grid's edge."""
    import torch.nn.functional as F

    r0, r1 = rows
    c0, c1 = cols
    n0, n1 = full.shape[0], full.shape[1]
    pad = [0, 0] * (full.dim() - 2)
    core = full[max(r0 - 1, 0):min(r1 + 1, n0), max(c0 - 1, 0):min(c1 + 1, n1)]
    return F.pad(core, pad + [int(c0 == 0), int(c1 == n1), int(r0 == 0), int(r1 == n0)]
                 ).contiguous()


def par_padded_planes(st, rows, cols):
    """A stencil's planes of the block, zero in the halo."""
    import torch.nn.functional as F

    pad = [0, 0] * (st.c0.dim() - 2) + [1, 1, 1, 1]
    return type(st)(*(F.pad(p[rows[0]:rows[1], cols[0]:cols[1]], pad).contiguous() for p in st))


def phase_parallel(device):
    """The parallel layer on the card: 4 gloo ranks, all on the one card
    (the only multi-rank layout one card allows: this measures correctness,
    not scaling).  The sharded pol level N=255 (5 steps; its K2 launches on
    halo-padded blocks counted) against the port's local run on the card
    (1e-12); on a 2 x 2 mesh the 2-D step, mixed, direct (N=15),
    value-and-grad (N=15) and 2 steps of ExpSin3 N=31 (K6 on halo-padded
    volumes), each against its local run on the card; the sharded
    checkpoint saved by 4 ranks and restored on 2 and on 1 (bit for bit);
    the ensemble at the JAX study's defaults, B = 8 and 32 (batched K1/K2;
    one run each: the ``drivers`` phase times the study's batches), and dp=2
    (ranks 0 and 1) against dp=1 at B = 8 (1e-13, equal iterations)."""
    import shutil
    import tempfile

    import torch

    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.harness.checkpoint import load_state_sharded
    from na_dd_tpu_torch.harness.ensemble import build_ensemble
    from na_dd_tpu_torch.integrators.pc_trapezoidal import _one_shape
    from na_dd_tpu_torch.ops.shifts import BATCHED_OPS, LOCAL_OPS
    from na_dd_tpu_torch.parallel import run_ranks
    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.parallel.step import simulate_with_errors
    from na_dd_tpu_torch.studies.ensemble_throughput import final_norms
    from na_dd_tpu_torch.studies.reference_values import ENSEMBLE_NORMS_CPU_X64
    from na_dd_tpu_torch.three_d.harness import run_trial3

    f64 = torch.float64
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    etas_dp = np.linspace(20.0, 200.0, PAR_DP_B).tolist()
    try:
        t0 = time.perf_counter()
        ranks = run_ranks(parallel_rank, PAR_WORLD, backend="gloo", device="cuda",
                          args=(ckpt, etas_dp), timeout_s=600.0)
        wall4 = time.perf_counter() - t0
        whole, t_ck, step_ck = load_state_sharded(ckpt, device=device)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    r0 = ranks[0]
    log(f"[parallel] 4 gloo ranks on one card: {wall4:.3f} s with the spawn")
    for rank, r in enumerate(ranks):
        c = r["counts"]
        log(f"[parallel] rank {rank}: N={PAR_N} sharded level launches {c['level']}, traffic "
            f"{c['level_traffic']}; 2x2 step {c['step']}, mixed {c['mixed']}, direct "
            f"{c['direct']}, value-and-grad {c['grad']}, ExpSin3 N={PAR_N3} {c['sim3']}, "
            f"traffic {c['sim3_traffic']}")
        check(c["level"]["stencil5_apply"] > 0, f"rank {rank}: no K2 on halo-padded blocks")
        check(c["level"]["bicgstab_solve"] == 0 and c["level"]["triple_solve"] == 0,
              f"rank {rank}: a local solve kernel ran on a sharded level")
        check(c["sim3"]["stencil7_apply"] > 0 and c["sim3"]["bicgstab_solve3"] == 0,
              f"rank {rank}: the sharded 3-D steps should run K6 and no K5")
    level = r0["level"]
    per_step = {k: v / PAR_STEPS for k, v in ranks[0]["counts"]["level_traffic"].items()}
    log(f"[parallel] N={PAR_N} sharded level, {PAR_STEPS} steps on 4 ranks: {level['wall']:.6f} s, "
        f"warm {level['wall_warm']:.6f} s (rank 0's clock); a step on rank 0: {per_step['exchanges']:.1f} halo exchanges, "
        f"{per_step['reductions']:.1f} all-reduces, {per_step['staged_bytes']:.0f} bytes staged "
        "through pinned host memory")

    # the local runs on the card
    trial, dt = make_trial(PAR_N, f64, device)
    t_loc = time.perf_counter()
    local = simulate_with_errors(trial.integrator, trial.grid, LOCAL_OPS, trial.initial_state,
                                 mms_case=trial.mms_case, num_steps=PAR_STEPS, t0=0.0, dt=dt)
    torch.cuda.synchronize()
    t_loc = time.perf_counter() - t_loc
    t_warm = time.perf_counter()
    simulate_with_errors(trial.integrator, trial.grid, LOCAL_OPS, trial.initial_state,
                         mms_case=trial.mms_case, num_steps=PAR_STEPS, t0=0.0, dt=dt)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t_warm
    log(f"[parallel] N={PAR_N} local level, {PAR_STEPS} steps: {t_loc:.6f} s, warm {t_warm:.6f} s")
    par_check_state(f"N={PAR_N} sharded level (4 ranks)", level["state"], local[0])
    s_err, l_err = level["errors"], local[1]
    par_check_errors(f"N={PAR_N} sharded level", (s_err[0], s_err[1], *s_err[2][:2]),
                     (l_err[0], l_err[1], *l_err[2][:2]))
    z = torch.zeros((), dtype=f64, device=device)
    small_trial, dt_s = make_trial(PAR_SMALL_N, f64, device, linear_solver="direct")
    cases = [(key, integ, trial, dt, PAR_N) for key, integ in par_integrators(trial).items()]
    cases.append(("direct", small_trial.integrator, small_trial, dt_s, PAR_SMALL_N))
    for key, integ, tr, dt_k, N in cases:
        ref, _ = integ.step_fn(tr.grid, LOCAL_OPS, tr.initial_state, z, dt_k)
        check(bool(r0[key]["converged"]), f"parallel {key}: a solve missed its tolerance")
        par_check_state(f"2x2 {key} (N={N})", r0[key]["state"], ref)
    tr, dt_g = make_trial(PAR_SMALL_N, f64, device, differentiable=True)
    leaves = State(*(v.clone().requires_grad_(True) for v in tr.initial_state))
    s1, _ = tr.integrator.step_fn(tr.grid, LOCAL_OPS, leaves, z, dt_g)
    loss = torch.sum(s1.T * s1.T) + torch.sum(s1.cd)
    loss.backward()
    value = float(loss.detach())
    rel_v = abs(float(r0["grad"]["value"]) - value) / abs(value)
    worst_g = 0.0
    for a, b in zip(r0["grad"]["grads"], leaves):
        a, b = a.to(device), b.grad
        worst_g = max(worst_g, float(((a - b).abs() / (1e-10 * b.abs() + 1e-12)).max()))
    log(f"[parallel] 2x2 value-and-grad (N={PAR_SMALL_N}): value rel diff {rel_v:.3e} (limit "
        f"1e-12), gradients at {worst_g:.3e} of rtol 1e-10 + atol 1e-12 (limit 1)")
    check(rel_v <= 1e-12 and worst_g <= 1.0, "parallel value-and-grad off the local one")
    g3, case3, integ3 = make_trial3(PAR_N3, f64, device)
    ref3 = run_trial3(g3, case3, integ3, Tf=2 * dt3(PAR_N3), dt=dt3(PAR_N3))
    rel3 = abs(r0["sim3"]["error"] - ref3["error"]) / ref3["error"]
    log(f"[parallel] 2x2 ExpSin3 N={PAR_N3}, 2 steps: error {r0['sim3']['error']!r} against "
        f"{ref3['error']!r} locally, rel {rel3:.3e} (limit 1e-12)")
    check(r0["sim3"]["converged"] and rel3 <= 1e-12, "parallel 3-D error off the local run")
    par_check_state(f"2x2 ExpSin3 N={PAR_N3}", r0["sim3"]["state"], ref3["state"])

    # the checkpoint: written by 4 ranks, read by 2 and by 1, bit for bit
    check((t_ck, step_ck) == (PAR_STEPS * dt, PAR_STEPS), "checkpoint t/step not as saved")
    for rank in (0, 1):
        rows = slice(rank * (PAR_N + 1) // 2, (rank + 1) * (PAR_N + 1) // 2)
        block = ranks[rank]["counts"]["ckpt2"]
        check(all(torch.equal(a.cpu(), b[rows].cpu()) for a, b in zip(block, level["state"])),
              f"checkpoint block of rank {rank} of 2 is not the saved rows")
    check(all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(whole, level["state"])),
          "checkpoint restored on one rank is not the saved state")
    log("[parallel] checkpoint saved by 4 ranks restored bit for bit on 2 and on 1")

    # the ensemble at the JAX study's defaults, dp=1, one untimed run each
    # (the drivers phase times the JAX study's batches through its CLI): B=8
    # for dp=2 to be held to, B=32 for the kernels line, B=128 in the
    # ceil(B / MAX_BATCH) parts build_ensemble splits it into; every member
    # to the CPU-x64 record
    ens_rows, dp1 = {}, None
    for B in (PAR_DP_B, PAR_K1_B, PAR_PARTS_B):
        build = build_ensemble(np.linspace(20.0, 200.0, B).tolist(), device=device,
                               **PAR_ENSEMBLE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (s_e, it_e), launches_e, _ = counted(build["run"])
        first = time.perf_counter() - t0
        check(all(bool(v.isfinite().all()) for v in s_e), f"ensemble B={B}: non-finite state")
        n_parts = len(build["parts"])
        check(n_parts == -(-B // kernels.MAX_BATCH),
              f"ensemble B={B}: {n_parts} parts of at most {kernels.MAX_BATCH}")
        check(launches_e["bicgstab_solve"] == 3 * build["num_steps"] * n_parts,
              f"ensemble B={B}: {launches_e['bicgstab_solve']} K1 launches, expected one a "
              f"solve of each of its {n_parts} parts")
        worst = max(rel_to(a, b) for got, want in
                    zip(final_norms(build["grid"], s_e), ENSEMBLE_NORMS_CPU_X64[B], strict=True)
                    for a, b in zip(got, want, strict=True))
        check(worst <= ENSEMBLE_RTOL, f"ensemble B={B}: members off the CPU-x64 record")
        ens_rows[B] = dict(launches=launches_e, build=build)
        log(f"[ensemble] pol N={PAR_ENSEMBLE['N']} steps={build['num_steps']} budget "
            f"{build['budget']} B={B:3d} in {n_parts} parts: first run {first:.6f} s (launches "
            f"{launches_e}); members' final-field H-norms² max rel to CPU-x64 {worst:.3e} "
            f"(limit {ENSEMBLE_RTOL:g})")
        if B == PAR_DP_B:
            dp1 = (s_e, it_e)
    s_dp, it_dp = r0["ensemble"]
    d_dp = max(float((a.to(device) - b).abs().max()) for a, b in zip(s_dp, dp1[0]))
    same_it = torch.equal(it_dp.to(device), dp1[1])
    log(f"[ensemble] dp=2 against dp=1 at B={PAR_DP_B}: max abs diff {d_dp:.3e} (limit 1e-13; "
        f"bit for bit: {d_dp == 0.0}), per-member iterations equal: {same_it}")
    check(d_dp <= 1e-13 and same_it, "the dp=2 ensemble is off the dp=1 one")

    # the kernels on this path at its shapes: K2 on a rank's halo-padded
    # block of the N=255 level, K6 on a 2x2 block of ExpSin3 N=31, batched
    # K1 on the B=32 ensemble's step-1 T stack
    systems, _inner = step1_systems(f64, device, N=PAR_N)
    st, b, _mask = systems[0]
    rows = ((PAR_N + 1) // PAR_WORLD, 2 * (PAR_N + 1) // PAR_WORLD)
    cols = (0, PAR_N + 1)
    row_k2 = apply_row(par_padded_planes(st, rows, cols), par_padded_block(b, rows, cols),
                       f"f64 {rows[1] - rows[0] + 2}x{PAR_N + 3} halo-padded block")
    sys3, _ = step1_systems3(PAR_N3, f64, device)
    st3, b3, _m3 = sys3[0]
    half = (PAR_N3 + 1) // 2
    row_k6 = apply_row(par_padded_planes(st3, (0, half), (0, half)),
                       par_padded_block(b3, (0, half), (0, half)),
                       f"f64 {half + 2}x{half + 2}x{PAR_N3 + 1} halo-padded block")
    build = ens_rows[PAR_K1_B]["build"]
    integ = build["parts"][0]["integrator"]
    rec = integ.solver = RecordingSolver(integ.solver)
    integ.step_fn(build["grid"], BATCHED_OPS, build["parts"][0]["state"], z, build["dt"])
    integ.solver = rec.inner
    st_e, b_e, mask_e = _one_shape(*rec.systems[0])
    err_k1, _ = compare_batched_solve(st_e, b_e, jacobi(st_e, mask_e), mask_e, tol=1e-13,
                                      iters=rec.inner.iters, xtol=1e-12,
                                      label=f"f64 {tuple(b_e.shape)} ensemble step-1 T")
    row_k1 = solve_row(st_e, b_e, mask_e, tol=1e-13, iters=rec.inner.iters,
                       label=f"f64 {tuple(b_e.shape)} ensemble")
    row_k1["max_abs_err"] = err_k1
    total = {name: sum(r["counts"][key][name] for r in ranks)
             for key, name in (("level", "stencil5_apply"), ("sim3", "stencil7_apply"))}
    return dict(
        rows=dict(k2=row_k2, k6=row_k6, k1=row_k1),
        launches=dict(k2={"stencil5_apply": total["stencil5_apply"]},
                      k6={"stencil7_apply": total["stencil7_apply"]},
                      k1=ens_rows[PAR_K1_B]["launches"]),
        level_wall=level["wall_warm"], local_wall=t_warm, per_step=per_step,
    )


STUDIES_TIMEOUT_S = 600  # an entry point that takes longer fails the phase


def run_entry_point(label, module, args):
    """``python -m module args`` from the repo root, as a user runs it (the
    kernels are built already, so the child loads them); returns its
    wall-clock.  A non-zero exit or a time-out fails the phase."""
    cmd = [sys.executable, "-m", module, *args]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=STUDIES_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        out = e.stdout.decode(errors="replace") if isinstance(e.stdout, bytes) else e.stdout
        log(f"[studies] {label}: timed out after {STUDIES_TIMEOUT_S} s; output tail:\n"
            f"{(out or '')[-3000:]}")
        raise CheckFailed(f"{label} timed out") from None
    wall = time.perf_counter() - t0
    log(f"[studies] {label}: `{' '.join(cmd[1:])}` exited {proc.returncode} in {wall:.1f} s wall")
    for line in proc.stdout.splitlines():
        if "[adjudicate]" in line or "##########" in line or "saved ->" in line:
            log(f"[studies]   {line.strip()}")
    if proc.returncode != 0:
        log(f"[studies] {label} stdout tail:\n{proc.stdout[-3000:]}\nstderr tail:\n"
            f"{proc.stderr[-3000:]}")
        raise CheckFailed(f"{label} exited {proc.returncode}")
    return wall


def check_study_levels(label, result, refs, keys, what="CPU-x64"):
    """Each level of ``result`` (an entry point's JSON) at ``PARITY_RTOL`` to its
    value in ``refs`` (``what``), looked up by ``keys``; and the run went
    through the card's K1 and K2."""
    check(len(result["errors"]) == len(keys), f"{label}: {len(result['errors'])} levels")
    for key, err in zip(keys, result["errors"]):
        rel = abs(err - refs[key]) / refs[key]
        log(f"[studies] {label} {key}: error {err!r}, {what} {refs[key]!r}, rel {rel:.3e}")
        check(math.isfinite(err) and rel <= PARITY_RTOL, f"{label} {key} off {what}")
    log(f"[studies] {label} on {result['device']}: kernel launches {result['kernel_launches']}")
    for name in ("bicgstab_solve", "stencil5_apply"):
        check(result["kernel_launches"][name] > 0, f"{label} launched no {name}")


def phase_studies(device):
    """The port's user entry points as a user runs them, each in a process of its
    own: the six-notebook reproduction for the pol study in its fast mode
    (``run_all --only pol``: the batched mixed ladder, the mixed temporal
    ladder, the mixed eta sweep, each over-gate level adjudicated against the
    CPU-x64 record), every level held here to the JAX package's CPU-x64
    values and the report's three pol rows read PASS; and the study CLI on
    the ExpSin spatial ladder (``run_study --study expsin --kind spatial
    --levels 8``), every level to the notebook and N=256 to CPU-x64."""
    import glob
    import tempfile

    from na_dd_tpu_torch.harness import calculate_observed_rates

    del device  # the entry points run on the card by default
    walls = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_studies_") as tmp:
        out = Path(tmp) / "run_all"
        walls["run_all --only pol"] = run_entry_point(
            "run_all --only pol", "na_dd_tpu_torch.studies.run_all",
            ["--only", "pol", "--results-dir", str(out)])
        runs = {kind: json.loads((out / f"pol_{kind}.json").read_text())
                for kind in ("spatial", "temporal", "eta_batched")}
        for kind, res in runs.items():
            check(res["device"] != "cpu" and res["precision"] == "mixed",
                  f"pol {kind} ran as {res['precision']} on {res['device']}")
        check_study_levels("pol spatial (batched mixed)", runs["spatial"], POL_SPATIAL_CPU_X64,
                           runs["spatial"]["Ns"])
        check_study_levels("pol temporal (mixed)", runs["temporal"], POL_TEMPORAL_CPU_X64,
                           runs["temporal"]["dts"])
        check_study_levels("pol eta (batched mixed)", runs["eta_batched"],
                           dict(enumerate(ETA_BATCHED_CPU_X64)), range(len(ETA_BATCHED_CPU_X64)))
        report = (out / "REPRODUCTION.md").read_text()
        for kind in ("spatial", "temporal", "eta"):
            row = next(line for line in report.splitlines() if line.startswith(f"| pol | {kind} |"))
            log(f"[studies] report row: {row}")
            check(" PASS |" in row, f"the report's pol {kind} row does not read PASS")

        out = Path(tmp) / "run_study"
        walls["run_study expsin spatial"] = run_entry_point(
            "run_study expsin spatial", "na_dd_tpu_torch.studies.run_study",
            ["--study", "expsin", "--kind", "spatial", "--levels", "8", "--results-dir", str(out)])
        (path,) = glob.glob(str(out / "expsin_spatial_*.json"))
        res = json.loads(Path(path).read_text())
        check_study_levels("expsin spatial (CLI)", res, EXPSIN_REFERENCE, res["Ns"], "notebook")
        rel = abs(res["errors"][-1] - EXPSIN_N256_CPU_X64) / EXPSIN_N256_CPU_X64
        log(f"[studies] expsin spatial (CLI) N=256 vs CPU-x64 {EXPSIN_N256_CPU_X64!r}: rel {rel:.3e}")
        check(rel <= PARITY_RTOL, "the CLI's ExpSin N=256 off CPU-x64")
        rate = calculate_observed_rates(res["errors"])[-1][0]
        rate_ref = calculate_observed_rates(list(EXPSIN_REFERENCE.values()))[-1][0]
        log(f"[studies] expsin spatial (CLI) observed rate (3-point, N=64,128,256) {rate!r}, the "
            f"notebook's {rate_ref!r}, difference {abs(rate - rate_ref):.3e} (limit 1e-6)")
        check(abs(rate - rate_ref) <= 1e-6, "the CLI's ExpSin observed rate off the notebook's")
    log("[studies] entry-point wall-clock: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; {sum(walls.values()):.1f} s in all")
    return walls


ENSEMBLE_BATCHES = (1, 32)  # the drivers phase's batches of the ensemble CLI


def phase_drivers(device):
    """The port's other study CLIs, each called in this process as a user's
    ``main(argv)`` on the card, writing to a temporary directory (the
    ``studies`` phase proves the entry points as processes): the 3-D study's
    spatial ladder N=4..16 (every level to CPU-x64 at 1e-8 and its own
    adjudication passed), its eta sweep at N=32 (7 eta in one batch, to
    ``ETA3_CPU_X64`` at 1e-8; 16 steps of one Newton sweep, so exactly 48 K5
    and 48 K6 launches), the eta-gradient study at N=16 (every row's Obs and
    dObs/deta to the JAX study's CPU-x64 run at 1e-8, the central
    differences at 1e-4) and the ensemble screen at B = 1 and 32 (every
    member's final-field H-norms² to the CPU-x64 record at 1e-10).  A
    nonzero return fails the phase; the 3-D calls must launch K5/K6, the 2-D
    ones K1/K2."""
    import tempfile

    import torch

    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.studies import ensemble_throughput, eta_gradient_study, three_d_study
    from na_dd_tpu_torch.studies.reference_values import (
        ENSEMBLE_NORMS_CPU_X64,
        ETA_GRADIENT_CPU_X64,
    )

    del device  # the CLIs run on the card by default
    walls, counts = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_drivers_") as tmp:

        def call(label, module, argv, name, kernel_names):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rc = module.main([*argv, "--results-dir", tmp])
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
            launches = counts[label] = {k: v for k, v in kernels.LAUNCHES.items() if v}
            log(f"[drivers] {label}: main({' '.join(argv)}) returned {rc} in {walls[label]:.1f} s "
                f"wall; launches {launches}")
            check(rc == 0, f"{label} returned {rc}")
            for kernel in kernel_names:
                check(launches.get(kernel, 0) > 0, f"{label} launched no {kernel}")
            res = json.loads((Path(tmp) / name).read_text())
            check(res["device"] != "cpu", f"{label} ran on {res['device']}")
            return res

        res = call("three_d_study spatial", three_d_study, ["--levels", "3", "--n0", "4"],
                   "three_d_study.json", ("bicgstab_solve3", "stencil7_apply"))
        for lv in res["levels"]:
            rel = rel_to(lv["error"], THREE_D_CPU_X64[lv["N"]])
            log(f"[drivers] 3-D N={lv['N']}: error {lv['error']!r}, CPU-x64 "
                f"{THREE_D_CPU_X64[lv['N']]!r}, rel {rel:.3e}; cold {lv['cold_s']:.3f} s, warm "
                f"{lv['warm_s']:.6f} s ({1e3 * lv['warm_per_step_s']:.3f} ms a step)")
            check(rel <= PARITY_RTOL and lv["converged"], f"3-D study N={lv['N']} off CPU-x64")
        adj = res["adjudication"]
        check(adj["passed"] is True and len(adj["gated_levels"]) == 3,
              f"the 3-D study's own adjudication: {adj['passed']}, "
              f"{len(adj['gated_levels'])} levels gated")

        res = call("three_d_study eta sweep", three_d_study,
                   ["--eta-sweep", "--n0", str(ETA3["N"]), "--dt0", repr(ETA3["dt"])],
                   "three_d_eta_sweep.json", ("bicgstab_solve3", "stencil7_apply"))
        worst = max(rel_to(e, r) for e, r in zip(res["errors"], ETA3_CPU_X64))
        log(f"[drivers] 3-D eta sweep N={ETA3['N']}: max rel to ETA3_CPU_X64 {worst:.3e} "
            f"(limit {PARITY_RTOL:g}); sweep {res['wallclock_s']:.3f} s")
        check(len(res["errors"]) == len(ETA3_CPU_X64) and worst <= PARITY_RTOL
              and all(res["converged"]), "the 3-D study's eta sweep off CPU-x64")
        eta3_wall = res["wallclock_s"]
        nsteps = round(ETA3["Tf"] / ETA3["dt"])
        check(counts["three_d_study eta sweep"] == {"bicgstab_solve3": 3 * nsteps,
                                                    "stencil7_apply": 3 * nsteps},
              f"the 3-D eta sweep: expected {3 * nsteps} K5 and K6 launches, one a solve")

        res = call("eta_gradient_study", eta_gradient_study,
                   ["--n", str(ETA_GRADIENT_CPU_X64["N"])], "eta_gradient_study.json",
                   ("bicgstab_solve", "stencil5_apply"))
        worst = 0.0
        for row, ref in zip(res["rows"], ETA_GRADIENT_CPU_X64["rows"], strict=True):
            check(row["eta"] == ref["eta"], f"eta-gradient row at eta {row['eta']}")
            worst = max(worst, rel_to(row["obs"], ref["obs"]),
                        rel_to(row["dobs_deta"], ref["dobs_deta"]))
        fd = max(c["rel_dev"] for c in res["fd_checks"])
        log(f"[drivers] eta gradient N={res['N']}: max rel of Obs and dObs/deta to the CPU-x64 "
            f"run {worst:.3e} (limit {PARITY_RTOL:g}); adjoint against central differences "
            f"{fd:.3e} (limit 1e-4)")
        check(worst <= PARITY_RTOL and fd <= 1e-4, "the eta gradient off CPU-x64")

        res = call("ensemble_throughput", ensemble_throughput,
                   ["--batches", ",".join(map(str, ENSEMBLE_BATCHES))], "ensemble_throughput.json",
                   ("bicgstab_solve", "stencil5_apply"))
        sims = {}
        for B in ENSEMBLE_BATCHES:
            row = res["batches"][str(B)]
            ref = ENSEMBLE_NORMS_CPU_X64[B]
            check(len(row["final_norms"]) == len(ref) == B, f"ensemble B={B}: member count")
            worst = max(rel_to(a, b) for got, want in zip(row["final_norms"], ref)
                        for a, b in zip(got, want, strict=True))
            sims[B] = row["sims_per_s"]
            log(f"[drivers] ensemble B={B}: {row['sims_per_s']:.3f} sims/s, steady "
                f"{row['batch_s']:.6f} s (first {row['first_s']:.6f} s); members' final-field "
                f"H-norms² max rel to CPU-x64 {worst:.3e} (limit {ENSEMBLE_RTOL:g})")
            check(worst <= ENSEMBLE_RTOL, f"ensemble B={B} off CPU-x64")
    log("[drivers] wall-clock: " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
        + f"; {sum(walls.values()):.1f} s in all")
    return dict(walls=walls, sims=sims, eta3_wall=eta3_wall)


def ptxas_rows(text: str):
    """(kernel, registers, stack frame bytes, spill store bytes, spill load
    bytes) of each entry function in nvcc's ``-Xptxas -v`` report."""
    import re

    rows, name, frame = [], None, (0, 0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, frame = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            rows.append((demangle(name), int(m.group(1)), *frame))
            name = None
    return rows


def demangle(name: str) -> str:
    try:
        out = subprocess.run(["c++filt", name], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or name
    except OSError:
        return name


PHASES = ("k2", "k1", "k3", "k4", "slice", "f32", "analytic", "scale", "timings", "profile",
          "k6", "k5", "3d", "3d128", "3d_f32", "timings3", "expsin", "golden",
          "variants3", "production", "mixed3", "timings_mixed", "df", "simulate", "adaptive",
          "checkpoint", "gradients", "direct", "fit", "batched", "eta_batched", "batched3",
          "probe", "while_form", "matrix_free", "probe3", "direct3", "heat3", "gradients3",
          "batched_mixed", "batched_analytic", "parallel", "studies", "drivers")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default=",".join(PHASES),
                        help="comma-separated phases to run (default: all): " + ",".join(PHASES))
    only = parser.parse_args(argv).only.split(",")
    unknown = sorted(set(only) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (REPO / "na_dd_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the na_dd_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from na_dd_tpu_torch.ops import kernels

    device = "cuda"
    t_all = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; card: {nvidia_smi_line()}")

    t0 = time.perf_counter()
    kernels.build_kernels()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall for {len(kernels.SOURCES)} "
        f"sources, built in parallel")
    for name, info in kernels.BUILD_INFO.items():
        log(f"[build] {name}: {info['seconds']:.1f} s (cached {info['cached']})")
        for kernel, regs, stack, spill_st, spill_ld in ptxas_rows(info["ptxas"]):
            log(f"[build]   {kernel}: {regs} registers, {stack} bytes stack frame, "
                f"{spill_st} bytes spill stores, {spill_ld} bytes spill loads")

    done = {}

    def phase(name, fn, *args):
        if name in only:
            t0 = time.perf_counter()
            done[name] = fn(*args)
            log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")

    phase("k2", phase_apply5, device, "k2", K2_SHAPES, 2)
    phase("k1", phase_k1, device)
    phase("k3", phase_apply5, device, "k3", K3_SHAPES, 3)
    phase("k4", phase_k4, device)
    phase("slice", phase_slice_f64, device)
    phase("f32", phase_slice_f32, device)
    phase("analytic", phase_analytic, device, done["slice"][3] if "slice" in done else None)
    phase("scale", phase_scale, device)
    phase("timings", phase_timings, device)
    phase("profile", phase_profile, device)
    phase("k6", phase_k6, device)
    phase("k5", phase_k5, device)
    phase("3d", phase_three_d_f64, device)
    if "3d128" in only:
        check("3d" in done, "phase 3d128 needs phase 3d (the N=64 error)")
    phase("3d128", phase_three_d_n128, device, done.get("3d", (None, None, None))[2])
    phase("3d_f32", phase_three_d_f32, device)
    phase("timings3", phase_timings3, device)
    phase("expsin", phase_expsin, device)
    phase("golden", phase_golden, device)
    phase("variants3", phase_variants3, device)
    phase("production", phase_production, device)
    phase("mixed3", phase_mixed3, device, done["3d"][2] if "3d" in done else None)
    phase("timings_mixed", timings_mixed, device)
    phase("df", phase_df, device)
    phase("simulate", phase_simulate, device)
    phase("adaptive", phase_adaptive, device)
    phase("checkpoint", phase_checkpoint, device)
    phase("gradients", phase_gradients, device)
    phase("direct", phase_direct, device)
    phase("fit", phase_fit, device)
    phase("batched", phase_batched, device)
    phase("eta_batched", phase_eta_batched, device)
    phase("batched3", phase_batched3, device)
    phase("probe", phase_probe, device)
    phase("while_form", phase_while_form, device)
    phase("matrix_free", phase_matrix_free, device)
    phase("probe3", phase_probe3, device)
    phase("direct3", phase_direct3, device)
    phase("heat3", phase_heat3, device)
    phase("gradients3", phase_gradients3, device)
    phase("batched_mixed", phase_batched_mixed, device,
          done["batched"]["errors"] if "batched" in done else None,
          done["batched3"]["errors"] if "batched3" in done else None)
    phase("batched_analytic", phase_batched_analytic, device,
          done["batched"]["errors"] if "batched" in done else None,
          done["eta_batched"]["errors"] if "eta_batched" in done else None)
    phase("parallel", phase_parallel, device)
    phase("studies", phase_studies, device)
    phase("drivers", phase_drivers, device)
    if set(only) != set(PHASES):
        log(f"[done] phases {only}; total {time.perf_counter() - t_all:.1f} s (no result line)")
        return 0

    launches2, steady2, err2, _ = done["slice"]
    launches_an, steady_an, err_an, steady_ps = done["analytic"]
    launches_sc, steady_sc, err_sc = done["scale"]
    launches3, steady3, err3 = done["3d"]
    _, steady_ex, err_ex = done["expsin"]["jvp"]
    _, steady_ex_an, err_ex_an = done["expsin"]["analytic"]
    t2, t3 = done["timings"], done["timings3"][MAIN_N3]
    counts_prod, steady_prod = done["production"]
    launches3_32, steady_m3, err_m3 = done["mixed3"]
    tm = done["timings_mixed"]
    launches_sim, steady_sim, _ = done["simulate"]
    _, steady_ad = done["adaptive"]
    launches_grad, launches_grad32, grad_times, fwd_time, adjoint_rows = done["gradients"]
    _, steady_direct, steady_krylov, err_direct = done["direct"]
    bl, be, bl3 = done["batched"], done["eta_batched"], done["batched3"]
    pr, wf, mf, p3 = done["probe"], done["while_form"], done["matrix_free"], done["probe3"]
    d3, h3, g3, bm = done["direct3"], done["heat3"], done["gradients3"], done["batched_mixed"]
    ba, par, study_walls = done["batched_analytic"], done["parallel"], done["studies"]
    drivers = done["drivers"]
    dfr = done["df"]
    pk = "na_dd_tpu/ops/pallas_kernels.py"
    entries = []
    # (wrapper, source, TPU kernel, shape, error against the plain version,
    # the launch counts of the path that runs it at that shape, timing row)
    for name, src, replaces, shape, err, launches, row in (
        ("bicgstab_solve", "bicgstab", f"{pk}:342", "257x257", done["k1"], launches2,
         t2["bicgstab_solve"]),
        ("bicgstab_solve", "bicgstab", f"{pk}:342", "1025x1025",
         done["timings"]["bicgstab_solve_1025"]["max_abs_err"], launches_sc,
         t2["bicgstab_solve_1025"]),
        ("stencil5_apply", "stencil5", f"{pk}:523", "257x257", done["k2"], launches2,
         t2["stencil5_apply"]),
        ("stencil5_apply", "stencil5", f"{pk}:466", "1025x1025", done["k3"], launches_sc,
         t2["stencil5_apply_1025"]),
        ("triple_solve", "triple_solve", f"{pk}:263", "257x257", done["k4"]["main"], launches_an,
         t2["triple_solve"]),
        ("bicgstab_solve3", "bicgstab3", f"{pk}:702", "65x65x65", done["k5"], launches3,
         t3["bicgstab_solve3"]),
        ("stencil7_apply", "stencil7", f"{pk}:615, {pk}:834", "65x65x65", done["k6"], launches3,
         t3["stencil7_apply"]),
        # the float32 solves of the mixed path, with their float32 launches
        ("bicgstab_solve", "bicgstab", f"{pk}:342", "257x257 f32 (mixed)",
         tm["bicgstab_solve"]["max_abs_err"], counts_prod["mixed"][1], tm["bicgstab_solve"]),
        ("triple_solve", "triple_solve", f"{pk}:263", "257x257 f32 (mixed fused)",
         tm["triple_solve"]["max_abs_err"], counts_prod["mixed fused"][1], tm["triple_solve"]),
        ("bicgstab_solve3", "bicgstab3", f"{pk}:702", "65x65x65 f32 (mixed)",
         tm["bicgstab_solve3"]["max_abs_err"], launches3_32, tm["bicgstab_solve3"]),
        # the float32 solves of the double-float paths, with their float32 launches
        ("triple_solve", "triple_solve", f"{pk}:263", "257x257 f32 (df fused)",
         dfr["rows"]["triple_solve"]["max_abs_err"], dfr["main"]["launches32"],
         dfr["rows"]["triple_solve"]),
        ("bicgstab_solve", "bicgstab", f"{pk}:342", "257x257 f32 (mixed_df per-solve)",
         dfr["rows"]["bicgstab_solve"]["max_abs_err"], dfr["mixed"]["per-solve"]["launches32"],
         dfr["rows"]["bicgstab_solve"]),
        ("bicgstab_solve3", "bicgstab3", f"{pk}:702", "65x65x65 f32 (3-D df)",
         dfr["rows"]["bicgstab_solve3"]["max_abs_err"], dfr["launches3_32"],
         dfr["rows"]["bicgstab_solve3"]),
        # the gradients' solves: K1 forward, recomputed and on the
        # transposed planes, launches of one gradient evaluation
        ("bicgstab_solve", "bicgstab", f"{pk}:342", "257x257 adjoint (transposed planes)",
         adjoint_rows["adjoint"]["max_abs_err"], launches_grad, adjoint_rows["adjoint"]),
        ("bicgstab_solve", "bicgstab", f"{pk}:342", "65x65 f32 adjoint (mixed gradient)",
         adjoint_rows["adjoint_f32"]["max_abs_err"], launches_grad32, adjoint_rows["adjoint_f32"]),
        # the batch axis: one launch for every level of a ladder
        ("bicgstab_solve", "bicgstab", f"{pk}:342", "8x257x257 (batched pol ladder)",
         bl["err_solve"], bl["launches"], bl["rows"]["bicgstab_solve"]),
        ("stencil5_apply", "stencil5", f"{pk}:523", "8x257x257 (batched pol ladder)",
         bl["err_apply"], bl["launches"], bl["rows"]["stencil5_apply"]),
        ("bicgstab_solve3", "bicgstab3", f"{pk}:702", "5x65x65x65 (batched 3-D ladder)",
         bl3["err_solve"], bl3["launches"], bl3["rows"]["bicgstab_solve3"]),
        ("stencil7_apply", "stencil7", f"{pk}:615", "5x65x65x65 (batched 3-D ladder)",
         bl3["err_apply"], bl3["launches"], bl3["rows"]["stencil7_apply"]),
        ("bicgstab_solve", "bicgstab", f"{pk}:342", "7x33x33 (batched eta sweep)",
         be["row"]["max_abs_err"], be["launches"], be["row"]),
        # the solver options
        ("bicgstab_solve", "bicgstab", f"{pk}:342", "257x257 budget 300 (while form)",
         wf["row"]["max_abs_err"], wf["launches"], wf["row"]),
        ("bicgstab_solve3", "bicgstab3", f"{pk}:702", "65x65x65 adjoint (transposed volumes)",
         g3["row"]["max_abs_err"], g3["launches"], g3["row"]),
        ("bicgstab_solve3", "bicgstab3", f"{pk}:702", "129x129x129 (CN heat)",
         h3["rows"]["bicgstab_solve3"]["max_abs_err"], h3["launches"], h3["rows"]["bicgstab_solve3"]),
        ("stencil7_apply", "stencil7", f"{pk}:834", "129x129x129 (CN heat rhs)",
         h3["rows"]["stencil7_apply"]["max_abs_err"], h3["launches"], h3["rows"]["stencil7_apply"]),
        ("stencil7_apply", "stencil7", f"{pk}:615", "33x33x33 (3-D direct verdict)",
         d3["row"]["max_abs_err"], d3["launches"], d3["row"]),
        ("bicgstab_solve", "bicgstab", f"{pk}:342", "8x257x257 f32 (batched mixed ladder)",
         bm["2d"]["row"]["max_abs_err"], bm["2d"]["launches32"], bm["2d"]["row"]),
        ("bicgstab_solve3", "bicgstab3", f"{pk}:702", "5x65x65x65 f32 (batched mixed ladder)",
         bm["3d"]["row"]["max_abs_err"], bm["3d"]["launches32"], bm["3d"]["row"]),
        # K4 with a batch dimension: the fused analytic batched paths
        ("triple_solve", "triple_solve", f"{pk}:263", "8x257x257 (batched fused pol ladder)",
         ba["rows"]["f64"]["max_abs_err"], ba["f64"]["launches"], ba["rows"]["f64"]),
        ("triple_solve", "triple_solve", f"{pk}:263", "8x257x257 f32 (batched mixed fused ladder)",
         ba["rows"]["f32"]["max_abs_err"], ba["mixed"]["launches32"], ba["rows"]["f32"]),
        ("triple_solve", "triple_solve", f"{pk}:263", "7x33x33 (batched fused eta sweep)",
         ba["rows"]["eta"]["max_abs_err"], ba["eta"]["launches"], ba["rows"]["eta"]),
        # the parallel layer: K2/K6 on halo-padded blocks (every rank's
        # launches), batched K1 in the ensemble
        ("stencil5_apply", "stencil5", f"{pk}:523",
         f"{(PAR_N + 1) // PAR_WORLD + 2}x{PAR_N + 3} (halo-padded block, {PAR_WORLD} ranks)",
         par["rows"]["k2"]["max_abs_err"], par["launches"]["k2"], par["rows"]["k2"]),
        ("stencil7_apply", "stencil7", f"{pk}:615",
         f"{(PAR_N3 + 1) // 2 + 2}x{(PAR_N3 + 1) // 2 + 2}x{PAR_N3 + 1} (halo-padded block, 2x2)",
         par["rows"]["k6"]["max_abs_err"], par["launches"]["k6"], par["rows"]["k6"]),
        ("bicgstab_solve", "bicgstab", f"{pk}:342",
         f"{PAR_K1_B}x{PAR_ENSEMBLE['N'] + 1}x{PAR_ENSEMBLE['N'] + 1} (ensemble)",
         par["rows"]["k1"]["max_abs_err"], par["launches"]["k1"], par["rows"]["k1"]),
    ):
        entries.append({
            "name": name, "route": "cuda", "source": f"na_dd_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "shape": shape, "launches": launches[name],
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"], "library_ms": None,
        })
        check(launches[name] > 0, f"{name} at {shape} was launched no time on its path")
    log(f"[done] 2-D N=256 steady {steady2:.6f} s, error {err2!r}; analytic fused steady "
        f"{steady_an:.6f} s (per-solve {steady_ps:.6f} s), error {err_an!r}; N={SCALE_N} "
        f"{SCALE_STEPS} steps {steady_sc:.6f} s, error {err_sc!r}; 3-D N=64 steady "
        f"{steady3:.6f} s, error {err3!r}; ExpSin N=256 steady {steady_ex:.6f} s, error "
        f"{err_ex!r} (analytic fused {steady_ex_an:.6f} s, error {err_ex_an!r}); production "
        "steady " + ", ".join(f"{k} {v:.6f} s" for k, v in steady_prod.items())
        + f"; 3-D mixed N=64 steady {steady_m3:.6f} s, error {err_m3!r}; release N=256 "
        f"simulate {steady_sim:.6f} s ({launches_sim['bicgstab_solve']} K1), adaptive "
        f"{steady_ad:.6f} s; df_fast N=256 {dfr['main']['wall']:.6f} s warm "
        f"({dfr['main']['per_step']} launches a step, idle {dfr['main']['idle']:.2f} %), deviation "
        f"{dfr['main']['dev']:.3e} from CPU-x64, forward {fwd_time:.6f} s, value-and-grad {grad_times[True][0]:.6f} s "
        f"({launches_grad['bicgstab_solve']} K1); pol N=256 direct {steady_direct:.6f} s against "
        f"Krylov {steady_krylov:.6f} s, error {err_direct!r}; batched pol ladder "
        f"{bl['steady']['batched']:.6f} s "
        f"({bl['per_step']:.0f} launches a step, idle {bl['idle']:.2f} %); batched eta sweep "
        f"{be['steady']['batched']:.6f} s; "
        f"batched 3-D ladder {bl3['steady']['batched']:.6f} s "
        f"({bl3['per_step']:.0f} launches a step, idle "
        f"{bl3['idle']:.2f} %); 3-D eta sweep {drivers['eta3_wall']:.6f} s; probed planes "
        f"{pr['steady']['probe']:.6f} s against analytic {pr['steady']['analytic']:.6f} s; while "
        f"form {wf['steady']['while']:.6f} s; matrix-free N=64 {mf['steady']['matrix_free']:.6f} "
        f"s; 3-D probe {p3['steady']['probe']:.6f} s; 3-D direct N=32 {d3['steady']['direct']:.6f} "
        f"s against Krylov {d3['steady']['krylov']:.6f} s; heat N=128 {h3['steady']:.6f} s; 3-D "
        f"value-and-grad {g3['steady']:.6f} s against a forward {g3['forward']:.6f} s; batched "
        f"mixed {bm['2d']['steady']['mixed']:.6f} s / {bm['3d']['steady']['mixed']:.6f} s; "
        f"fused batched ladder {ba['steady']['fused']:.6f} s (first run), fused eta sweep "
        f"{ba['steady']['fused eta']:.6f} s; sharded N={PAR_N} level "
        f"{par['level_wall']:.6f} s on {PAR_WORLD} ranks of one card against "
        f"{par['local_wall']:.6f} s locally; ensemble CLI "
        + ", ".join(f"B={B} {r:.3f} sims/s" for B, r in drivers["sims"].items())
        + "; study entry points " + ", ".join(f"{k} {v:.1f} s" for k, v in study_walls.items())
        + "; the other CLIs in process " + ", ".join(f"{k} {v:.1f} s" for k, v in drivers["walls"].items())
        + f"; total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
