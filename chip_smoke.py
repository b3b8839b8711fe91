#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (na_dd_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``na_dd_tpu_torch/csrc`` with nvcc (one
nvcc per source, all in parallel), holds each against its plain PyTorch
version on the card, and drives the port's two paths:

* 2-D: the MMSCasePol RegHCs spatial study, N=2..256, dt = h^1.5,
  Tf = 0.01, eta = 50, through ``MMSTrial.run_for_errors`` in float64 and
  float32 (kernels K1 ``bicgstab_solve`` and K2 ``stencil5_apply``);
* 3-D: the three_d_study protocol (MMSCaseExpSin3, RegHCs, eta = 50,
  Tf = 0.02, two Newton sweeps, dt = 1e-2/2^k), N=4..64 and N=128 in float64
  and N=32 in float32, through ``make_setup3`` and ``run_trial3`` (kernels K5
  ``bicgstab_solve3`` and K6/K7 ``stencil7_apply``).

It checks the errors against the reference values and the launch counts of
each path's main level (counts set to 0 just before it, read just after),
times the kernels (torch.profiler and CUDA events), profiles five steps of
each main level, and prints one JSON line with every kernel's numbers, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
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
TF, ETA, MAIN_N = 0.01, 50.0, 256

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


def make_trial(N: int, dtype, device, dt=None):
    from na_dd_tpu_torch.core.fields import FieldRegHCsTriple
    from na_dd_tpu_torch.core.forcing import MMSForcingRegHCsTriple
    from na_dd_tpu_torch.harness.trial import MMSTrial, choose_krylov_unroll
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
        integrator_params=dict(
            regularization_factor=ETA,
            track_residuals=False,
            krylov_unroll=choose_krylov_unroll(N, dt, POL_PEAKS_CONSTS),
        ),
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

    def solve(self, st, rhs, mask):
        self.systems.append((st, rhs * mask, mask))
        return self.inner.solve(st, rhs, mask)


def jacobi(st, mask):
    import torch

    return torch.where(
        mask > 0,
        1.0 / torch.where(st.c0 == 0, torch.ones_like(st.c0), st.c0),
        torch.zeros_like(st.c0),
    )


def step1_systems(dtype, device):
    """The T, cl and cd Newton systems of step 1 of the pol N=256 run."""
    import torch

    trial, dt = make_trial(MAIN_N, dtype, device)
    integ = trial.integrator
    rec = RecordingSolver(integ.solver)
    integ.solver = rec
    t0 = torch.zeros((), dtype=dtype, device=device)
    integ.step_fn(trial.grid, trial.ops, trial.initial_state, t0, dt)
    integ.solver = rec.inner
    check(len(rec.systems) == 3, "step 1 should make three Newton solves")
    return rec.systems, rec.inner


def phase_k2(device):
    import torch

    from na_dd_tpu_torch.ops import kernels

    rng = np.random.default_rng(2)
    worst = {}
    for dtype, tol in ((torch.float64, 1e-14), (torch.float32, 1e-6)):
        for shape in ((257, 257), (257, 130)):
            st, u = random_planes(rng, shape, dtype, device, dominant=False)
            k = kernels.stencil5_apply(st, u)
            p = kernels.stencil5_apply_plain(st, u)
            torch.cuda.synchronize()
            rel = rel_to_max(k, p)
            log(f"[k2] {str(dtype)[6:]} {shape}: max rel diff {rel:.3e} (limit {tol:g}), "
                f"max abs {float((k - p).abs().max()):.3e}")
            check(bool(torch.isfinite(k).all()), "K2 output not finite")
            check(rel <= tol, f"K2 {dtype} {shape} disagrees with its plain version")
            worst[(dtype, shape)] = float((k - p).abs().max())
    return worst[(torch.float64, (257, 257))]


def compare_solve(st, b, inv_diag, mask, *, tol, iters, xtol, label):
    """K1 (a plane) or K5 (a volume) against its plain version on one
    system: identical iteration counts, x within ``xtol`` of the plain
    version's max-norm."""
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
    return float((xk - xp).abs().max())


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
    main_err = None
    for dtype, xtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        systems, solver = step1_systems(dtype, device)
        for name, (st, b, mask) in zip(("T", "cl", "cd"), systems):
            err = compare_solve(st, b, jacobi(st, mask), mask,
                                tol=default_krylov_tol(dtype), iters=solver.iters,
                                xtol=xtol, label=f"{str(dtype)[6:]} step-1 {name} plane")
            if dtype == torch.float64:
                main_err = max(err, main_err or 0.0)
    return main_err


def run_level(N, dtype, device, dt=None):
    trial, dt = make_trial(N, dtype, device, dt)
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

    # the same level through the plain versions on this machine's CPU
    t0 = time.perf_counter()
    _, _, s_cpu = run_level(MAIN_N, torch.float64, "cpu")
    err_cpu = s_cpu.overall_combined_error
    rel_cpu = abs(err - err_cpu) / err_cpu
    log(f"[f64] N=256 on the CPU (plain versions): error {err_cpu!r}, card vs CPU rel "
        f"{rel_cpu:.3e}; Krylov iterations {int(s_cpu.series.krylov_iters.sum())} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(rel_cpu <= 1e-8, "N=256 f64: the card and the CPU disagree")
    check(nsteps == 41, "N=256 should take 41 steps")
    for name in ("bicgstab_solve", "stencil5_apply"):
        check(launches[name] == 3 * nsteps,
              f"{name} launched {launches[name]} times, expected {3 * nsteps}")
    for name in ("bicgstab_solve3", "stencil7_apply"):
        check(launches[name] == 0, f"the 2-D path launched the 3-D kernel {name}")
    check(bool(s.series.krylov_converged.all()), "N=256: a solve did not converge")

    trial.run_for_errors(Tf=TF, dt=dt)  # warm-up
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s2 = trial.run_for_errors(Tf=TF, dt=dt)
        runs.append(time.perf_counter() - t0)
    check(s2.overall_combined_error == err, "repeat run changed the error")
    steady = min(runs)
    log(f"[f64] N=256 steady wall-clock {steady:.6f} s (min of 3 after a warm-up; runs "
        + ", ".join(f"{r:.6f}" for r in runs) + " s)")
    return launches, steady, err


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


def profile_device(fn):
    """Run ``fn`` under torch.profiler; return (wall_s, {kernel name:
    (calls, device_us)}) over the device kernels it launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.events():
        if str(evt.device_type).endswith("CUDA") and evt.device_time_total > 0:
            calls, us = kernels.get(evt.name, (0, 0.0))
            kernels[evt.name] = (calls + 1, us + evt.device_time_total)
    return wall, kernels


def kernel_device_ms(fn, reps: int, name: str):
    """Mean device time of the CUDA kernel whose name contains ``name``, or
    None when the profiler reports no device time for it."""
    _, found = profile_device(lambda: [fn() for _ in range(reps)])
    hits = [(c, us) for k, (c, us) in found.items() if name in k]
    if not hits:
        log(f"[time] the profiler saw no device time for {name}; using CUDA events")
        return None
    calls = sum(c for c, _ in hits)
    return sum(us for _, us in hits) / calls / 1e3


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
    # one iteration makes ~35 plane passes (csrc/bicgstab.cu): its streaming time
    passes = 35 * n * item
    log(f"[time] bicgstab_solve per iteration: ~35 plane passes = {passes / 1e6:.2f} MB, "
        f"{passes / HBM_BYTES_PER_S * 1e6:.2f} us at the HBM rate; measured "
        f"{res['bicgstab_solve']['ms'] * 1e3 / max(iters, 1):.2f} us an iteration")
    return res


def phase_profile(device):
    """Where a main-level step's time goes: 5 steps of the f64 N=256 level
    under torch.profiler — device busy share and the busiest kernels."""
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

    from na_dd_tpu_torch.harness.trial import _collect_errors

    g, ops, s0 = trial.grid, trial.ops, trial.initial_state
    t0 = torch.zeros((), dtype=torch.float64, device=device)
    step_launches, breakdown = step_launch_breakdown(
        lambda: trial.integrator.step_fn(g, ops, s0, t0, dt), trial.forcing_terms, g, ops, t0)
    collect = launches_of(lambda: _collect_errors(
        g, ops, trial.mms_case, s0, t0, trial.variable_names, trial.integral_vars))
    log(f"[profile] one step_fn: {step_launches} launches; {breakdown}"
        f"; one error collection: {collect} launches")


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


def make_trial3(N: int, dtype, device):
    """The three_d_study level N through the user entry point make_setup3."""
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.three_d.harness import make_setup3
    from na_dd_tpu_torch.three_d.mms import MMSCaseExpSin3

    model = Model02(default_model_consts._replace(**THREE_D_CONSTS))
    g, case, _field, integ = make_setup3(
        MMSCaseExpSin3, N=N, model=model, eta=ETA,
        integrator_params=dict(num_newton_steps=2), dtype=dtype, device=device,
    )
    return g, case, integ


class IterTally:
    """Solver backend that keeps each solve's iteration count (on the
    device) for the log."""

    def __init__(self, inner):
        self.inner = inner
        self.iters = []

    def solve(self, st, rhs, mask):
        x, info = self.inner.solve(st, rhs, mask)
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
    main_err = 0.0
    for dtype, xtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        systems, solver = step1_systems3(MAIN_N3, dtype, device)
        for name, (st, b, mask) in zip(("T", "cl", "cd"), systems[:3]):
            err = compare_solve(st, b, jacobi(st, mask), mask,
                                tol=default_krylov_tol(dtype), iters=solver.iters,
                                xtol=xtol, label=f"{str(dtype)[6:]} N={MAIN_N3} step-1 {name} volume")
            if dtype == torch.float64:
                main_err = max(err, main_err)
    return main_err


def phase_three_d_f64(device):
    import torch

    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.three_d.harness import run_trial3

    for N in (4, 8, 16, 32):
        r, tally = run_level3(N, torch.float64, device)
        ref = THREE_D_CPU_X64[N]
        rel = abs(r["error"] - ref) / ref
        log(f"[3d f64] N={N}: error {r['error']!r}, vs CPU-x64 {ref!r} rel {rel:.3e}; "
            f"{tally.summary()}")
        check(math.isfinite(r["error"]) and rel <= 1e-8, f"3-D N={N} off the CPU-x64 value")
        check(r["krylov_converged"], f"3-D N={N}: a solve did not converge")

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

    run_trial3(g, case, integ, Tf=TF3, dt=dt)  # warm-up
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r2 = run_trial3(g, case, integ, Tf=TF3, dt=dt)
        runs.append(time.perf_counter() - t0)
    check(r2["error"] == err, "repeat 3-D run changed the error")
    steady = min(runs)
    log(f"[3d f64] N={N} steady wall-clock {steady:.6f} s (min of 3 after a warm-up; runs "
        + ", ".join(f"{x:.6f}" for x in runs) + f" s; {1e3 * steady / nsteps:.3f} ms a step)")
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
    """One kernel's timing row: kernel time (the profiler's device time
    where it gives one, else the wrapper call by CUDA events) beside the
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
        # one iteration makes ~39 volume passes (csrc/bicgstab3.cu)
        passes = 39 * n * item
        blocks = kernels._BLOCKS.get(("bicgstab3", b.dtype, n), 0)
        log(f"[time] bicgstab_solve3 {label}: cooperative grid {blocks} blocks of 256 threads "
            f"({n / max(blocks * 256, 1):.1f} points a thread); per iteration ~39 volume passes = "
            f"{passes / 1e6:.1f} MB, {passes / HBM_BYTES_PER_S * 1e6:.1f} us at the HBM rate; "
            f"measured {res[N]['bicgstab_solve3']['ms'] * 1e3 / max(iters, 1):.1f} us an iteration")
        del st, b, mask, inv
        torch.cuda.empty_cache()
    return res


def phase_profile3(device):
    """Where a 3-D main-level step's time goes: 5 steps of the f64 N=64 level
    under torch.profiler, and the launch breakdown of one step."""
    import torch

    from na_dd_tpu_torch.three_d.harness import run_trial3
    from na_dd_tpu_torch.three_d.mms import state_from_mms_when3
    from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

    g, case, integ = make_trial3(MAIN_N3, torch.float64, device)
    dt = dt3(MAIN_N3)
    steps = 5
    wall, found = profile_device(lambda: run_trial3(g, case, integ, Tf=steps * dt, dt=dt))
    busy_us = sum(us for _, us in found.values())
    launches = sum(c for c, _ in found.values())
    log(f"[profile3] {steps} steps of f64 N={MAIN_N3}: wall {wall:.6f} s, device busy "
        f"{busy_us / 1e6:.6f} s ({100 * busy_us / 1e6 / wall:.2f} %), idle "
        f"{100 * (1 - busy_us / 1e6 / wall):.2f} %, {launches} kernel launches "
        f"({launches / steps:.0f} per step, {busy_us / max(launches, 1):.2f} us each on average)")
    top = sorted(found.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (calls, us) in top:
        log(f"[profile3]   {us / 1e3:9.3f} ms in {calls:6d} calls: {name[:90]}")
    s0 = state_from_mms_when3(mms_case=case, t=0.0, grid=g)
    t0 = torch.zeros((), dtype=torch.float64, device=device)
    step_launches, breakdown = step_launch_breakdown(
        lambda: integ.step_fn(g, LOCAL_OPS3, s0, t0, dt), integ.semi_discrete_field.forcing,
        g, LOCAL_OPS3, t0)
    log(f"[profile3] one step_fn: {step_launches} launches; {breakdown}")


PHASES = ("k2", "k1", "slice", "f32", "timings", "profile",
          "k6", "k5", "3d", "3d128", "3d_f32", "timings3", "profile3")


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
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")

    done = {}

    def phase(name, fn, *args):
        if name in only:
            t0 = time.perf_counter()
            done[name] = fn(*args)
            log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")

    phase("k2", phase_k2, device)
    phase("k1", phase_k1, device)
    phase("slice", phase_slice_f64, device)
    phase("f32", phase_slice_f32, device)
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
    phase("profile3", phase_profile3, device)
    if set(only) != set(PHASES):
        log(f"[done] phases {only}; total {time.perf_counter() - t_all:.1f} s (no result line)")
        return 0

    launches2, steady2, err2 = done["slice"]
    launches3, steady3, err3 = done["3d"]
    t2, t3 = done["timings"], done["timings3"][MAIN_N3]
    pk = "na_dd_tpu/ops/pallas_kernels.py"
    entries = []
    for name, src, replaces, err, launches, t in (
        ("bicgstab_solve", "bicgstab", f"{pk}:342", done["k1"], launches2, t2),
        ("stencil5_apply", "stencil5", f"{pk}:523", done["k2"], launches2, t2),
        ("bicgstab_solve3", "bicgstab3", f"{pk}:702", done["k5"], launches3, t3),
        ("stencil7_apply", "stencil7", f"{pk}:615, {pk}:834", done["k6"], launches3, t3),
    ):
        row = t[name]
        entries.append({
            "name": name, "route": "cuda", "source": f"na_dd_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    log(f"[done] 2-D N=256 steady {steady2:.6f} s, error {err2!r}; 3-D N=64 steady "
        f"{steady3:.6f} s, error {err3!r}; total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
