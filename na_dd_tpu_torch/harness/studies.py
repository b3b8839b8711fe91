"""Convergence studies: the six reference notebooks as parameterized runs
(counterpart of :mod:`na_dd_tpu.harness.studies`).

Each reference notebook (``*_reghcstriple_convergence_study.ipynb``) runs, for
one MMS case, with shared study constants (notebook cell 3):

* cell 9  — spatial study: N = 2·2^k (8 levels), dt = h^1.5, PC-RegHCs η=50;
* cell 11 — temporal study: fixed grid, dt = BASE_DT/2^k;
* cell 13 — regularization study: N=32, dt=5e-4, η ∈ {10,…,1000}.

Same protocols, constants and error functional as the JAX package, with the
wall-clock of each level.  Every run is one :class:`MMSTrial` on the card
unless the caller passes ``device="cpu"``.  Results are plain dicts.  The
JAX package's compile-sharing options (``parallel_compile``,
``shared_compile``) have no counterpart in an eager loop.  The batched
forms, every level or every η in one batch, are
:func:`na_dd_tpu_torch.harness.batched_ladder.run_spatial_ladder_batched`
and :func:`run_eta_study_batched`.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import torch

from na_dd_tpu_torch.core.fields import FieldRegHCsTriple
from na_dd_tpu_torch.core.forcing import MMSForcingRegHCsTriple
from na_dd_tpu_torch.harness.rates import calculate_observed_rates
from na_dd_tpu_torch.harness.trial import MMSTrial
from na_dd_tpu_torch.integrators.pc_trapezoidal import PCTrapezoidalRegHCsTriple
from na_dd_tpu_torch.mms import cases as mms_cases
from na_dd_tpu_torch.models.coefficients import Model02
from na_dd_tpu_torch.models.consts import POL_PEAKS_CONSTS, STUDY_MODEL_CONSTS, ModelConsts
from na_dd_tpu_torch.ops.grid import make_uniform_grid

DEFAULT_ETA = 50.0
ETA_LADDER = [10.0, 50.0, 100.0, 200.0, 300.0, 500.0, 1000.0]


def _peaks_temporal_N(dt: float) -> int:
    """The peaks temporal study scales the grid with dt: h = 2·dt, i.e.
    N = ceil(1/(2·dt)).  At N < 2 (a 2×2 all-boundary grid, every node
    pinned to 0 where the exact solution vanishes) the error is identically
    0, which :func:`run_temporal_study` reports without simulating."""
    return math.ceil(1.0 / (2.0 * dt))


# The six studies: MMS case class and protocol, from each notebook's cells
# 3/9/11.
STUDIES: Dict[str, dict] = {
    "pol": dict(
        case_cls=mms_cases.MMSCasePol,
        consts=POL_PEAKS_CONSTS,
        spatial_Tf=0.01,
        temporal=dict(N=256, base_dt=1e-2, levels=4, Tf=0.01),
    ),
    "expsin": dict(
        case_cls=mms_cases.MMSCaseExpSin,
        spatial_Tf=0.01,
        temporal=dict(N=32, base_dt=1e-2, levels=6, Tf=0.01),
    ),
    "nfsp_cpcsH2_TclcdH3": dict(
        case_cls=mms_cases.MMSCaseNonFullySmoothPol_cpcsH2_TclcdH3,
        spatial_Tf=1.0,
        temporal=dict(N=256, base_dt=1e-2, levels=4, Tf=0.01),
    ),
    "nfsp_cpcsH2_TclcdH2": dict(
        case_cls=mms_cases.MMSCaseNonFullySmoothPol_cpcsH2_TclcdH2,
        spatial_Tf=1.0,
        temporal=dict(N=256, base_dt=1e-2, levels=4, Tf=0.01),
    ),
    "nfsp_cpcsH1_TclcdH2": dict(
        case_cls=mms_cases.MMSCaseNonFullySmoothPol_cpcsH1_TclcdH2,
        spatial_Tf=1.0,
        temporal=dict(N=256, base_dt=1e-2, levels=4, Tf=0.01),
    ),
    "peaks_fast1e1": dict(
        case_cls=mms_cases.MMSCaseSlowlyChangingPeaks_Fast1e1,
        consts=POL_PEAKS_CONSTS,
        spatial_Tf=1.0,
        temporal=dict(N_of_dt=_peaks_temporal_N, base_dt=1.0, levels=9, Tf=10.0),
        # The JAX package's floor on this study's budget.  It only raises the
        # budget, and the masked early exit makes a larger budget give the
        # same answer, so it is kept as the JAX package has it.
        min_krylov_unroll=16,
    ),
}


def study_consts(study: str) -> ModelConsts:
    """The ModelConsts the given study's notebook uses."""
    return STUDIES[study].get("consts", STUDY_MODEL_CONSTS)


def choose_krylov_unroll(
    N: int, dt: float, mc: ModelConsts = STUDY_MODEL_CONSTS, *, num_steps: int | None = None
) -> int:
    """BiCGStab iteration budget from the stiffness number s = 4 dt D_max / h²
    of J = 2I − dt·L: 8 up to s = 0.25, then 16, 32, 48, 96 and 160 at
    s ≤ 1, 8, 64, 256 and beyond.  The masked early exit makes any
    sufficient budget give the same answer.  ``num_steps`` is accepted, and
    unused, as in the JAX package."""
    del num_steps
    h = 1.0 / N
    d_max = max(mc.DT, mc.Dl_max, mc.Dd_max)
    s = 4.0 * dt * d_max / (h * h)
    if s <= 0.25:
        return 8
    if s <= 1.0:
        return 16
    if s <= 8.0:
        return 32
    if s <= 64.0:
        return 48
    if s <= 256.0:
        return 96
    return 160


def _study_unroll(cfg: dict, N: int, dt: float, mc: ModelConsts, num_steps=None) -> int:
    """The stiffness tier of :func:`choose_krylov_unroll`, floored by the
    study's ``min_krylov_unroll``."""
    return max(
        choose_krylov_unroll(N, dt, mc, num_steps=num_steps),
        cfg.get("min_krylov_unroll", 0),
    )


def _make_trial(
    case_cls,
    N: int,
    eta: float,
    *,
    track_residuals=False,
    krylov_unroll=16,
    mc: ModelConsts = STUDY_MODEL_CONSTS,
    dtype=None,
    device=None,
    **integrator_kwargs,
) -> MMSTrial:
    """The RegHCs MMS trial of ``case_cls`` on the uniform N×N grid (in
    ``dtype`` on ``device``) with regularization factor ``eta``;
    ``integrator_kwargs`` (``precision``, ``coupling_source``, ...) go to
    :class:`PCTrapezoidalRegHCsTriple`."""
    grid = make_uniform_grid(N, N, dtype=dtype, device=device)
    return MMSTrial(
        grid,
        Model02(mc),
        case_cls,
        FieldRegHCsTriple,
        MMSForcingRegHCsTriple,
        PCTrapezoidalRegHCsTriple,
        forcing_terms_params=dict(regularization_factor=eta),
        field_params=dict(regularization_factor=eta),
        integrator_params=dict(
            regularization_factor=eta,
            track_residuals=track_residuals,
            krylov_unroll=krylov_unroll,
            **integrator_kwargs,
        ),
    )


def run_spatial_study(
    study: str,
    *,
    levels: int = 8,
    base_N: int = 2,
    eta: float = DEFAULT_ETA,
    verbose: bool = True,
    measure_steady: bool = False,
    precision: str = "full",
    coupling_source: str = "jvp",
    mixed_df: bool = False,
    dtype=None,
    device=None,
) -> dict:
    """Notebook cell 9: N = base_N·2^k ladder with dt = h^1.5.

    measure_steady: run each level once more after the timed run and report
    that run's wall-clock as ``steady_s``.  ``precision`` ("full", "mixed"
    or "df"), ``mixed_df`` and ``coupling_source`` ("jvp" or "analytic")
    are the integrator's, which the JAX function reads from
    ``NA_DD_TPU_PRECISION``, ``NA_DD_TPU_MIXED_DF`` and
    ``NA_DD_TPU_COUPLING``."""
    cfg = STUDIES[study]
    mc = study_consts(study)
    Tf = cfg["spatial_Tf"]
    errors: List[float] = []
    times: List[float] = []
    steady: List[float] = []
    Ns: List[int] = []
    for k in range(levels):
        N = base_N * 2**k
        dt = (1.0 / N) ** 1.5
        nsteps = math.ceil(Tf / dt)
        trial = _make_trial(
            cfg["case_cls"], N, eta, mc=mc, dtype=dtype, device=device,
            krylov_unroll=_study_unroll(cfg, N, dt, mc, num_steps=nsteps),
            precision=precision, coupling_source=coupling_source, mixed_df=mixed_df,
        )
        t0 = time.perf_counter()
        summary = trial.run_for_errors(Tf=Tf, dt=dt)
        elapsed = time.perf_counter() - t0
        if measure_steady:
            t0 = time.perf_counter()
            trial.run_for_errors(Tf=Tf, dt=dt)
            steady.append(time.perf_counter() - t0)
        errors.append(summary.overall_combined_error)
        times.append(elapsed)
        Ns.append(N)
        if verbose:
            extra = f" steady={steady[-1]:.2f}s" if measure_steady else ""
            print(f"  [spatial {study}] N={N:4d} dt={dt:.3e} err={errors[-1]:.6e} ({elapsed:.2f}s{extra})")
    rates = calculate_observed_rates(errors) if len(errors) >= 3 else []
    return dict(
        study=study,
        kind="spatial",
        Ns=Ns,
        Tf=Tf,
        eta=eta,
        errors=errors,
        wallclock_s=times,
        steady_s=steady or None,
        rates=[r for r, _ in rates],
        statuses=[s for _, s in rates],
    )


def run_temporal_study(
    study: str,
    *,
    levels: Optional[int] = None,
    eta: float = DEFAULT_ETA,
    verbose: bool = True,
    measure_steady: bool = False,
    precision: str = "full",
    coupling_source: str = "jvp",
    mixed_df: bool = False,
    dtype=None,
    device=None,
) -> dict:
    """Notebook cell 11: dt = base_dt / 2^k ladder.

    The grid is fixed (``N``) for five studies; the peaks study recomputes
    it per level from dt (``N_of_dt``, :func:`_peaks_temporal_N`).  Levels
    of one grid size and budget share one trial.  ``precision``,
    ``mixed_df`` and ``coupling_source`` as in :func:`run_spatial_study`."""
    cfg = STUDIES[study]
    mc = study_consts(study)
    tcfg = cfg["temporal"]
    levels = levels or tcfg["levels"]
    Tf = tcfg["Tf"]
    N_of_dt = tcfg.get("N_of_dt")

    errors: List[float] = []
    times: List[float] = []
    steady: List[float] = []
    dts: List[float] = []
    Ns: List[int] = []
    trials: Dict[tuple, MMSTrial] = {}
    for k in range(levels):
        dt = tcfg["base_dt"] / 2**k
        N = N_of_dt(dt) if N_of_dt is not None else tcfg["N"]
        dts.append(dt)
        Ns.append(N)
        if N < 2:
            # the all-boundary grid: the combined error is identically 0
            errors.append(0.0)
            times.append(0.0)
            if measure_steady:
                steady.append(0.0)
            if verbose:
                print(f"  [temporal {study}] dt={dt:.3e} N={N} err=0 (degenerate all-boundary grid)")
            continue
        unroll = _study_unroll(cfg, N, dt, mc)
        trial = trials.get((N, unroll))
        if trial is None:
            trial = trials[(N, unroll)] = _make_trial(
                cfg["case_cls"], N, eta, mc=mc, krylov_unroll=unroll, dtype=dtype, device=device,
                precision=precision, coupling_source=coupling_source, mixed_df=mixed_df,
            )
        t0 = time.perf_counter()
        summary = trial.run_for_errors(Tf=Tf, dt=dt)
        elapsed = time.perf_counter() - t0
        if measure_steady:
            t0 = time.perf_counter()
            trial.run_for_errors(Tf=Tf, dt=dt)
            steady.append(time.perf_counter() - t0)
        errors.append(summary.overall_combined_error)
        times.append(elapsed)
        if verbose:
            extra = f" steady={steady[-1]:.2f}s" if measure_steady else ""
            print(f"  [temporal {study}] dt={dt:.3e} N={N} err={errors[-1]:.6e} ({elapsed:.2f}s{extra})")
    rates = calculate_observed_rates(errors) if len(errors) >= 3 else []
    return dict(
        study=study,
        kind="temporal",
        N=Ns[-1] if N_of_dt is not None else tcfg["N"],
        Ns=Ns,
        Tf=Tf,
        eta=eta,
        dts=dts,
        errors=errors,
        wallclock_s=times,
        steady_s=steady or None,
        rates=[r for r, _ in rates],
        statuses=[s for _, s in rates],
    )


def run_eta_study(
    study: str,
    *,
    N: int = 32,
    dt: float = 5e-4,
    Tf: float = 0.01,
    etas: Optional[List[float]] = None,
    verbose: bool = True,
    precision: str = "full",
    coupling_source: str = "jvp",
    mixed_df: bool = False,
    dtype=None,
    device=None,
) -> dict:
    """Notebook cell 13: regularization-factor sweep at fixed N and dt.
    ``precision``, ``mixed_df`` and ``coupling_source`` as in
    :func:`run_spatial_study`."""
    cfg = STUDIES[study]
    mc = study_consts(study)
    etas = etas or ETA_LADDER
    errors: List[float] = []
    times: List[float] = []
    nsteps = math.ceil(Tf / dt)
    for eta in etas:
        trial = _make_trial(
            cfg["case_cls"], N, eta, mc=mc, dtype=dtype, device=device,
            krylov_unroll=_study_unroll(cfg, N, dt, mc, num_steps=nsteps),
            precision=precision, coupling_source=coupling_source, mixed_df=mixed_df,
        )
        t0 = time.perf_counter()
        summary = trial.run_for_errors(Tf=Tf, dt=dt)
        elapsed = time.perf_counter() - t0
        errors.append(summary.overall_combined_error)
        times.append(elapsed)
        if verbose:
            print(f"  [eta {study}] eta={eta:7.1f} err={errors[-1]:.6e} ({elapsed:.2f}s)")
    return dict(
        study=study,
        kind="eta",
        N=N,
        dt=dt,
        Tf=Tf,
        etas=list(etas),
        errors=errors,
        wallclock_s=times,
    )


def build_eta_study_batched(
    study: str,
    *,
    N: int = 32,
    dt: float = 5e-4,
    Tf: float = 0.01,
    etas: Optional[List[float]] = None,
    precision: str | None = None,
    coupling_source: str | None = None,
    mixed_df: bool = False,
    dtype=None,
    device=None,
) -> dict:
    """Everything the batched η sweep runs, built once: ``etas``, the
    adjusted ``dt`` and ``num_steps``, the Krylov ``budget``, the shared
    ``grid``, the ``case``, the ``parts`` and ``run()``, which runs the
    whole sweep and returns its norms and diagnostics on the host (the
    packing of :func:`na_dd_tpu_torch.harness.trial._simulate`, one column
    an η), after one transfer a part.

    A sweep of more than :data:`~na_dd_tpu_torch.ops.kernels.MAX_BATCH` η
    runs as consecutive parts of at most that many (the batched kernels
    take no more systems a launch), each a dict of its ``etas``, stacked
    initial ``state`` and ``integrator`` (η an (E, 1, 1) tensor);
    ``state`` and ``integrator`` are also the first part's."""
    from na_dd_tpu_torch.harness.batched_ladder import stack_states
    from na_dd_tpu_torch.harness.trial import (
        ALL_VARIABLES,
        DEFAULT_INTEGRAL_VARS,
        _concat_packed,
        _simulate,
    )
    from na_dd_tpu_torch.mms.engine import state_from_mms_when
    from na_dd_tpu_torch.ops import kernels
    from na_dd_tpu_torch.ops.shifts import BATCHED_OPS

    cfg = STUDIES[study]
    mc = study_consts(study)
    etas = list(etas or ETA_LADDER)
    grid = make_uniform_grid(N, N, dtype=dtype, device=device)
    model = Model02(mc)
    case = cfg["case_cls"](grid=grid, model=model)
    s0 = state_from_mms_when(mms_case=case, t=0.0, grid=grid)
    num_steps = math.ceil(Tf / dt)
    dt_adj = Tf / num_steps
    unroll = _study_unroll(cfg, N, dt_adj, mc)

    def part(members):
        eta = torch.tensor(members, dtype=grid.dtype, device=grid.device).reshape(-1, 1, 1)
        forcing = MMSForcingRegHCsTriple(mms_case=case, model=model, regularization_factor=eta)
        field = FieldRegHCsTriple(grid=grid, model=model, forcing=forcing,
                                  regularization_factor=eta)
        integ = PCTrapezoidalRegHCsTriple(
            field, regularization_factor=eta, track_residuals=False, krylov_unroll=unroll,
            precision=precision or "full", coupling_source=coupling_source or "jvp",
            mixed_df=mixed_df,
        )
        return dict(etas=members, state=stack_states([s0] * len(members)), integrator=integ)

    step = kernels.MAX_BATCH
    parts = [part(etas[i:i + step]) for i in range(0, len(etas), step)]

    def run_part(p):
        # the part's only host transfer
        return _simulate(
            grid=grid, integrator=p["integrator"], exact_sol_pack=case, exact_stack=None,
            initial_state=p["state"], t0=0.0, dt=dt_adj, num_steps=num_steps,
            variable_names=ALL_VARIABLES, integral_vars=DEFAULT_INTEGRAL_VARS,
            ops=BATCHED_OPS, tail_grid=None, nsys=len(p["etas"]),
        ).cpu().numpy()

    def run():
        return _concat_packed([run_part(p) for p in parts], len(ALL_VARIABLES), num_steps,
                              [len(p["etas"]) for p in parts])

    return dict(etas=etas, dt=dt_adj, num_steps=num_steps, budget=unroll, grid=grid,
                state=parts[0]["state"], case=case, integrator=parts[0]["integrator"],
                parts=parts, run=run)


def run_eta_study_batched(
    study: str,
    *,
    N: int = 32,
    dt: float = 5e-4,
    Tf: float = 0.01,
    etas: Optional[List[float]] = None,
    precision: str | None = None,
    coupling_source: str | None = None,
    mixed_df: bool = False,
    verbose: bool = True,
    dtype=None,
    device=None,
) -> dict:
    """Notebook cell 13's sweep with every η in one batch (the JAX package
    vmaps it; the reference loops serially).

    One shared grid; η rides as an (E, 1, 1) tensor through the field, the
    forcing and the corrector, the state is the stack of the E runs', and
    each Newton solve is one launch of the batched kernel for all E.  The
    masked early exits of the solve and of the pointwise Newton make every
    η's run the serial one's up to the order of the kernel's sums.  Runs
    twice, as the JAX function does: ``wallclock_s`` the first run,
    ``steady_s`` the second.  More than
    :data:`~na_dd_tpu_torch.ops.kernels.MAX_BATCH` η run as consecutive
    batches of at most that many, as the JAX package's one vmap computes
    them.  On the card unless ``device="cpu"``.
    ``precision`` ("full", "mixed" or "df"), ``mixed_df`` and
    ``coupling_source`` ("jvp" or "analytic", whose every Newton sweep is one
    launch of the batched triple solve for all η) are the integrator's; None
    takes "full" and "jvp", the defaults the JAX function reads from
    ``NA_DD_TPU_PRECISION`` and ``NA_DD_TPU_COUPLING``.
    """
    from na_dd_tpu_torch.harness.trial import (
        ALL_VARIABLES,
        DEFAULT_INTEGRAL_VARS,
        NumericalErrorSummary,
        _error_series,
        _unpack,
    )

    sweep = build_eta_study_batched(
        study, N=N, dt=dt, Tf=Tf, etas=etas, precision=precision,
        coupling_source=coupling_source, mixed_df=mixed_df, dtype=dtype, device=device,
    )
    etas, dt_adj, num_steps = sweep["etas"], sweep["dt"], sweep["num_steps"]
    t0 = time.perf_counter()
    packed = sweep["run"]()
    elapsed = time.perf_counter() - t0
    t0 = time.perf_counter()
    sweep["run"]()
    steady = time.perf_counter() - t0

    mats, diags = _unpack(packed, len(ALL_VARIABLES), num_steps, len(etas))
    errors = []
    for i, eta_i in enumerate(etas):
        series = _error_series(mats[..., i], diags[..., i], ALL_VARIABLES, 0.0, dt_adj)
        summary = NumericalErrorSummary(
            dt_adj, series, list(ALL_VARIABLES), list(DEFAULT_INTEGRAL_VARS)
        )
        errors.append(summary.overall_combined_error)
        if verbose:
            print(f"  [eta-batched {study}] eta={eta_i:7.1f} err={errors[-1]:.6e}")
    if verbose:
        print(f"  [eta-batched {study}] total wall-clock {elapsed:.2f}s for {len(etas)} runs")
    return dict(
        study=study,
        kind="eta_batched",
        N=N,
        dt=dt_adj,
        Tf=Tf,
        etas=etas,
        errors=errors,
        wallclock_s=[elapsed],
        steady_s=[steady],
    )
