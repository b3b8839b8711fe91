#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (na_dd_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``na_dd_tpu_torch/csrc`` with nvcc,
holds each against its plain PyTorch version on the card, drives the main
path (the MMSCasePol RegHCs spatial study, N=2..256, dt = h^1.5, Tf = 0.01,
eta = 50) through ``MMSTrial.run_for_errors`` in float64 and float32, checks
the errors against the reference values, times the kernels (torch.profiler
and CUDA events), profiles five steps of the main level, and prints one JSON
line with every kernel's numbers, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.  Every check that fails stops the
script with a nonzero exit code; without a card it exits nonzero at once.
Imports nothing of JAX.
"""

from __future__ import annotations

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
N256_F32 = 3.7049e-07  # f32 + kernel error floor
TF, ETA, MAIN_N = 0.01, 50.0, 256

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
    """Five random planes (and an operand); diagonally dominant when asked."""
    import torch

    from na_dd_tpu_torch.ops.linsolve import Stencil5

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    if dominant:
        c0 = 4.5 + rng.random(shape)
        offs = [-rng.random(shape) for _ in range(4)]
    else:
        c0 = rng.standard_normal(shape)
        offs = [rng.standard_normal(shape) for _ in range(4)]
    return Stencil5(t(c0), *(t(o) for o in offs)), t(rng.standard_normal(shape))


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
    import torch

    from na_dd_tpu_torch.ops import kernels

    xk, ik = kernels.bicgstab_solve(st, b, inv_diag, mask, tol=tol, iters=iters)
    xp, ip = kernels.bicgstab_solve_plain(st, b, inv_diag, mask, tol=tol, iters=iters)
    torch.cuda.synchronize()
    rel = rel_to_max(xk, xp)
    itk, itp = int(ik["iters"]), int(ip["iters"])
    log(f"[k1] {label}: iters kernel {itk} plain {itp}, max rel diff x {rel:.3e} "
        f"(limit {xtol:g}), resnorm_sq {float(ik['resnorm_sq']):.3e}, "
        f"converged {bool(ik['converged'])}")
    check(bool(torch.isfinite(xk).all()), f"K1 {label}: x not finite")
    check(itk == itp, f"K1 {label}: iteration counts differ")
    check(rel <= xtol, f"K1 {label}: x disagrees with the plain version")
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
    for name, count in launches.items():
        check(count == 3 * nsteps, f"{name} launched {count} times, expected {3 * nsteps}")
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

    res = {
        "stencil5_apply": {
            "device_ms": kernel_device_ms(k2, 200, "stencil5_apply_kernel"),
            "wrapper_ms": time_ms(k2, 2000),
            "plain_ms": time_ms(lambda: kernels.stencil5_apply_plain(st, b), 500),
            # reads u and 5 planes, writes out; 9 operations per point
            "bytes": 7 * n * item,
            "ops": 9 * n,
        },
        "bicgstab_solve": {
            "device_ms": kernel_device_ms(k1, 100, "bicgstab_kernel"),
            "wrapper_ms": time_ms(k1, 500),
            "plain_ms": time_ms(lambda: kernels.bicgstab_solve_plain(
                st, b, inv, mask, tol=tol, iters=solver.iters), 50),
            # reads b, 5 planes, inv_diag, mask; writes x (the true-residual
            # apply is K2's, counted there).  Per iteration taken: two applies
            # (9 each), six dots (2 each), the p/s/x/r updates and the two
            # Jacobi scalings (~14).
            "bytes": 9 * n * item,
            "ops": (2 * 9 + 6 * 2 + 14) * n * max(iters, 1),
        },
    }
    peak = PEAK_FLOPS[str(b.dtype)[6:]]
    for name, r in res.items():
        # the kernel's own device time where the profiler gives it, else the
        # wrapper call timed by CUDA events
        r["ms"] = r["device_ms"] if r["device_ms"] is not None else r["wrapper_ms"]
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["ops"] / peak * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[time] {name} f64 257x257: kernel (device) {r['ms'] * 1e3:.2f} us, "
            f"wrapper call {r['wrapper_ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
            f"bound {r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}, {r['bytes'] / 1e6:.2f} MB)")
    log(f"[time] bicgstab_solve iterations in the timed solve: {iters}; cooperative grid "
        f"{kernels._BLOCKS.get((b.dtype, n))} blocks of 256 threads")
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

    # where a step's launches come from: count the forcing calls of one step,
    # and the launches of one step, of one call of each forcing term and of
    # one error collection
    from na_dd_tpu_torch.harness.trial import _collect_errors

    def launches_of(fn):
        return sum(c for c, _ in profile_device(fn)[1].values())

    g, ops, s0 = trial.grid, trial.ops, trial.initial_state
    t0 = torch.zeros((), dtype=torch.float64, device=device)
    forcing = trial.forcing_terms
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
    trial.integrator.step_fn(g, ops, s0, t0, dt)
    for k in terms:
        delattr(forcing, k)
    step_launches = launches_of(lambda: trial.integrator.step_fn(g, ops, s0, t0, dt))
    collect = launches_of(lambda: _collect_errors(
        g, ops, trial.mms_case, s0, t0, trial.variable_names, trial.integral_vars))
    in_forcing = sum(calls[k] * per_call[k] for k in terms)
    log(f"[profile] one step_fn: {step_launches} launches; forcing terms "
        f"{in_forcing} of them ({100 * in_forcing / step_launches:.1f} %) from calls "
        + ", ".join(f"{k} {calls[k]}x{per_call[k]}" for k in terms)
        + f"; one error collection: {collect} launches")


def main() -> int:
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

    k2_err = phase_k2(device)
    k1_err = phase_k1(device)
    launches, steady, err64 = phase_slice_f64(device)
    phase_slice_f32(device)
    timing = phase_timings(device)
    phase_profile(device)

    source = "na_dd_tpu_torch/csrc/{}.cu"
    entries = []
    for name, src, replaces, err in (
        ("bicgstab_solve", "bicgstab", "na_dd_tpu/ops/pallas_kernels.py:342", k1_err),
        ("stencil5_apply", "stencil5", "na_dd_tpu/ops/pallas_kernels.py:523", k2_err),
    ):
        t = timing[name]
        entries.append({
            "name": name, "route": "cuda", "source": source.format(src),
            "replaces": replaces, "launches": launches[name], "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    log(f"[done] steady {steady:.6f} s, error {err64!r}; total "
        f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
