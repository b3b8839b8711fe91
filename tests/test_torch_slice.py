"""The port's main path as a whole against the JAX package on CPU float64:
one PCTrapezoidalRegHCsTriple step at N=8 against the JAX integrator with
``stencil_backend="pallas"`` (its Pallas kernels in interpret mode) — as the
studies run it (one PC step, one Newton sweep) and with two of each — and
``MMSTrial.run_for_errors`` for the pol case at N=8 and N=16, with the
default jvp couplings and with ``coupling_source="analytic"`` (fused: the
JAX package through ``triple_solve_pallas`` in interpret mode, the port
through ``kernels.triple_solve``; and per-solve, ``fused_triple=False``).

Tolerances: each stepped field within 1e-12 relative to its max-norm with the
same Krylov iteration total; each combined error within 1e-10 relative of
the JAX value and within 1e-5 of the reference notebook's 6-digit value;
the analytic routes also within 1e-10 of the JAX package's CPU-x64 values.

The port's user entry points (the study CLI, the six-notebook reproduction and
its report), the plotting helpers and utils are held to the JAX package's
harness functions, its CPU-x64 records, its report writer and its twins."""

import json
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from na_dd_tpu.core import FieldRegHCsTriple as JField
from na_dd_tpu.core import MMSForcingRegHCsTriple as JForcing
from na_dd_tpu.harness.studies import POL_PEAKS_CONSTS as J_CONSTS
from na_dd_tpu.harness.trial import MMSTrial as JTrial
from na_dd_tpu.integrators import PCTrapezoidalRegHCsTriple as JIntegrator
from na_dd_tpu.mms.cases import MMSCasePol as JCase
from na_dd_tpu.models import Model02 as JModel02
from na_dd_tpu.ops import make_uniform_grid as j_make_uniform_grid
from na_dd_tpu.ops.shifts import LOCAL_OPS as J_OPS
from na_dd_tpu_torch.convert import consts_from_dict, state_from_numpy
from na_dd_tpu_torch.core.fields import FieldRegHCsTriple as TField
from na_dd_tpu_torch.core.forcing import MMSForcingRegHCsTriple as TForcing
from na_dd_tpu_torch.harness.trial import MMSTrial as TTrial
from na_dd_tpu_torch.harness.trial import choose_krylov_unroll
from na_dd_tpu_torch.integrators.pc_trapezoidal import PCTrapezoidalRegHCsTriple as TIntegrator
from na_dd_tpu_torch.mms.cases import MMSCasePol as TCase
from na_dd_tpu_torch.models.coefficients import Model02 as TModel02
from na_dd_tpu_torch.ops.grid import make_uniform_grid as t_make_uniform_grid
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS as T_OPS

ETA = 50.0
TF = 0.01
# the pol notebook's saved spatial errors (studies/reference_values.py)
REFERENCE = {8: 4.28269e-06, 16: 1.08800e-06}
FIELDS = ("cp", "T", "cl", "cd", "cs")
# CPU-x64 errors of the JAX package with coupling_source="analytic"
ANALYTIC_CPU_X64 = {8: 4.282692732192525e-06, 16: 1.087998167311069e-06}
ROUTES = {"fused": dict(coupling_source="analytic"),
          "per_solve": dict(coupling_source="analytic", fused_triple=False)}


def _params(N, dt, **extra):
    integrator = dict(
        regularization_factor=ETA,
        track_residuals=False,
        krylov_unroll=choose_krylov_unroll(N, dt, J_CONSTS),
    )
    integrator.update(extra)
    return dict(
        forcing_terms_params=dict(regularization_factor=ETA),
        field_params=dict(regularization_factor=ETA),
        integrator_params=integrator,
    )


def _jax_trial(N, dt, **extra):
    return JTrial(
        j_make_uniform_grid(N, N), JModel02(J_CONSTS), JCase, JField, JForcing, JIntegrator,
        **_params(N, dt, stencil_backend="pallas", **extra),
    )


def _port_trial(N, dt, **extra):
    return TTrial(
        t_make_uniform_grid(N, N, device="cpu"), TModel02(consts_from_dict(J_CONSTS._asdict())),
        TCase, TField, TForcing, TIntegrator, **_params(N, dt, **extra),
    )


@pytest.fixture(scope="module", params=[1, 2], ids=["1pc1sweep", "2pc2sweeps"])
def one_step(request):
    """One step at N=8 from the exact initial state, in both packages, with
    residual tracking on and ``request.param`` PC steps and Newton sweeps."""
    N = 8
    dt = (1.0 / N) ** 1.5
    loops = dict(num_pc_steps=request.param, num_newton_steps=request.param)
    jt = _jax_trial(N, dt, track_residuals=True, **loops)
    j_state, j_diag = jax.jit(jt.integrator.step_fn, static_argnums=1)(
        jt.grid, J_OPS, jt.initial_state, 0.0, dt
    )
    tt = _port_trial(N, dt, track_residuals=True, **loops)
    s0 = state_from_numpy({k: np.asarray(v) for k, v in jt.initial_state._asdict().items()}, device="cpu")
    t_state, t_diag = tt.integrator.step_fn(tt.grid, T_OPS, s0, 0.0, dt)
    return j_state, j_diag, t_state, t_diag


@pytest.mark.parametrize("field", FIELDS)
def test_one_step_field_matches_jax_pallas(one_step, field):
    j_state, _, t_state, _ = one_step
    ref = np.asarray(getattr(j_state, field))
    port = getattr(t_state, field).numpy()
    assert np.max(np.abs(port - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_one_step_krylov_diagnostics_match_jax_pallas(one_step):
    _, j_diag, _, t_diag = one_step
    assert int(t_diag.krylov_iters) == int(j_diag.krylov_iters) > 0
    assert bool(t_diag.krylov_converged) and bool(j_diag.krylov_converged)
    assert bool(t_diag.hcs_denominator_ok)


@pytest.mark.parametrize("name", ["residual_T", "residual_cl", "residual_cd"])
def test_one_step_newton_residual_matches_jax_pallas(one_step, name):
    """The last sweep's Newton residual planes (nonzero on the boundary,
    where the forcing stays and the sweep pins the unknowns)."""
    _, j_diag, _, t_diag = one_step
    ref = np.asarray(getattr(j_diag, name))
    port = getattr(t_diag, name).numpy()
    assert np.max(np.abs(port - ref)) <= 1e-12 * np.max(np.abs(ref))


@pytest.mark.parametrize("N", [8, 16])
def test_run_for_errors_matches_jax_and_reference(N):
    dt = (1.0 / N) ** 1.5
    ref = _jax_trial(N, dt).run_for_errors(Tf=TF, dt=dt)
    port = _port_trial(N, dt).run_for_errors(Tf=TF, dt=dt)
    assert port.dt_used == ref.dt_used
    err, ref_err = port.overall_combined_error, ref.overall_combined_error
    assert abs(err - ref_err) <= 1e-10 * ref_err
    assert abs(err - REFERENCE[N]) <= 1e-5 * REFERENCE[N]
    for var in FIELDS:
        a, b = port.per_variable_sup_errors[var], ref.per_variable_sup_errors[var]
        assert abs(a - b) <= 1e-10 * b
    assert port.series.krylov_converged.all()


def test_run_for_errors_float32_stays_near_the_float64_error():
    """float32 on request: the same level runs end to end in float32."""
    N = 16
    dt = (1.0 / N) ** 1.5
    trial = TTrial(
        t_make_uniform_grid(N, N, dtype=torch.float32, device="cpu"),
        TModel02(consts_from_dict(J_CONSTS._asdict())), TCase, TField, TForcing, TIntegrator,
        **_params(N, dt),
    )
    assert trial.initial_state.T.dtype == torch.float32
    err = trial.run_for_errors(Tf=TF, dt=dt).overall_combined_error
    assert np.isfinite(err) and abs(err - REFERENCE[N]) <= 1e-2 * REFERENCE[N]


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("N", [8, 16])
def test_analytic_run_for_errors_matches_jax(N, route):
    dt = (1.0 / N) ** 1.5
    ref = _jax_trial(N, dt, **ROUTES[route]).run_for_errors(Tf=TF, dt=dt)
    port = _port_trial(N, dt, **ROUTES[route]).run_for_errors(Tf=TF, dt=dt)
    err, ref_err = port.overall_combined_error, ref.overall_combined_error
    assert abs(err - ref_err) <= 1e-10 * ref_err
    assert abs(err - ANALYTIC_CPU_X64[N]) <= 1e-10 * ANALYTIC_CPU_X64[N]
    for var in FIELDS:
        a, b = port.per_variable_sup_errors[var], ref.per_variable_sup_errors[var]
        assert abs(a - b) <= 1e-10 * b
    assert port.series.krylov_converged.all()


@pytest.fixture(scope="module", params=list(ROUTES))
def analytic_step(request):
    """One step at N=8 with analytic couplings (two Newton sweeps, residual
    tracking on) in both packages, and the port's solver calls by kind."""
    N = 8
    dt = (1.0 / N) ** 1.5
    extra = dict(track_residuals=True, num_newton_steps=2, **ROUTES[request.param])
    jt = _jax_trial(N, dt, **extra)
    j_state, j_diag = jax.jit(jt.integrator.step_fn, static_argnums=1)(
        jt.grid, J_OPS, jt.initial_state, 0.0, dt
    )
    tt = _port_trial(N, dt, **extra)
    calls = {"solve": 0, "solve_triple": 0}
    solver = tt.integrator.solver

    class Counting:
        iters = solver.iters

        def solve(self, *args):
            calls["solve"] += 1
            return solver.solve(*args)

        def solve_triple(self, *args):
            calls["solve_triple"] += 1
            return solver.solve_triple(*args)

    tt.integrator.solver = Counting()
    s0 = state_from_numpy({k: np.asarray(v) for k, v in jt.initial_state._asdict().items()}, device="cpu")
    t_state, t_diag = tt.integrator.step_fn(tt.grid, T_OPS, s0, 0.0, dt)
    return request.param, j_state, j_diag, t_state, t_diag, calls


@pytest.mark.parametrize("field", FIELDS)
def test_analytic_step_field_matches_jax(analytic_step, field):
    _, j_state, _, t_state, _, _ = analytic_step
    ref = np.asarray(getattr(j_state, field))
    port = getattr(t_state, field).numpy()
    assert np.max(np.abs(port - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_analytic_step_diagnostics_and_route(analytic_step):
    route, _, j_diag, _, t_diag, calls = analytic_step
    assert int(t_diag.krylov_iters) == int(j_diag.krylov_iters) > 0
    assert bool(t_diag.krylov_converged) and bool(j_diag.krylov_converged)
    for name in ("residual_T", "residual_cl", "residual_cd"):
        ref = np.asarray(getattr(j_diag, name))
        assert np.max(np.abs(getattr(t_diag, name).numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))
    # two sweeps: one fused call each, or three solves each
    assert calls == ({"solve": 0, "solve_triple": 2} if route == "fused" else {"solve": 6, "solve_triple": 0})


def test_coupling_source_is_validated():
    with pytest.raises(ValueError, match="coupling_source"):
        _port_trial(8, 0.04, coupling_source="probe")
    integ = _port_trial(8, 0.04).integrator
    assert integ.coupling_source == "jvp" and integ.fused_triple is True


def test_default_budget_step_matches_jax():
    """Both integrators built with no solver arguments: the port's default
    "auto" resolves as the JAX package's does on the CPU, to the while form
    (``default_krylov_unroll()`` is None).  One step of the pol N=128 level
    from the exact state, stiff enough that the old fixed budget of 16 stops
    short: each field to 1e-12 of its max-norm, every solve converged.  At
    dt=0.2 (27 + 23 + 2 iterations) the iteration totals are equal.  At
    dt=0.5 the two solves of 38-44 iterations end where the residual
    stagnates at the tolerance, and the count there follows the order of
    the sums: the JAX package's own jitted and eager solves of the same
    systems take 41 + 38 and 42 + 39, the port 43 + 44; so there both only
    exceed three budgets of 16."""
    from na_dd_tpu_torch.integrators import default_krylov_unroll

    N = 128
    no_solver_args = dict(
        forcing_terms_params=dict(regularization_factor=ETA),
        field_params=dict(regularization_factor=ETA),
        integrator_params=dict(regularization_factor=ETA),
    )
    jt = JTrial(j_make_uniform_grid(N, N), JModel02(J_CONSTS), JCase, JField, JForcing,
                JIntegrator, **no_solver_args)
    j_step = jax.jit(jt.integrator.step_fn, static_argnums=1)
    tt = TTrial(t_make_uniform_grid(N, N, device="cpu"),
                TModel02(consts_from_dict(J_CONSTS._asdict())), TCase, TField, TForcing,
                TIntegrator, **no_solver_args)
    assert default_krylov_unroll() is None and tt.integrator.krylov_unroll is None
    s0 = state_from_numpy({k: np.asarray(v) for k, v in jt.initial_state._asdict().items()},
                          device="cpu")
    for dt in (0.2, 0.5):
        j_state, j_diag = j_step(jt.grid, J_OPS, jt.initial_state, 0.0, dt)
        t_state, t_diag = tt.integrator.step_fn(tt.grid, T_OPS, s0, 0.0, dt)
        t_iters, j_iters = int(t_diag.krylov_iters), int(j_diag.krylov_iters)
        if dt == 0.2:
            assert t_iters == j_iters == 52
        else:
            assert min(t_iters, j_iters) > 3 * 16
        assert bool(t_diag.krylov_converged) and bool(j_diag.krylov_converged)
        for field in FIELDS:
            ref = np.asarray(getattr(j_state, field))
            got = getattr(t_state, field).numpy()
            assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref)), (dt, field)


# ---------------------------------------------------------------------------
# the harness's production options, the time tables and the studies module:
# twins of tests/test_harness.py (collect_tail, collect_precompute) and of
# the JAX package's run_spatial_study / run_temporal_study / run_eta_study
# ---------------------------------------------------------------------------
HARNESS_RUN = dict(Tf=0.01, dt=5e-4)


def _study_trials(**kw):
    """The pol N=16 study trial (budget 8) of both packages."""
    from na_dd_tpu.harness.studies import _make_trial as j_make_trial
    from na_dd_tpu.mms import cases as j_cases
    from na_dd_tpu_torch.harness.studies import _make_trial
    from na_dd_tpu_torch.mms import cases

    jt = j_make_trial(j_cases.MMSCasePol, 16, ETA, mc=J_CONSTS, krylov_unroll=8, **kw)
    tt = _make_trial(cases.MMSCasePol, 16, ETA, mc=consts_from_dict(J_CONSTS._asdict()),
                     krylov_unroll=8, device="cpu", **kw)
    return jt, tt


@pytest.fixture(scope="module")
def harness_runs():
    """The port's N=16 study level by default, with the float32 tail, with
    the time tables and with both; the JAX package's with both."""
    jt, tt = _study_trials()
    runs = {
        name: tt.run_for_errors(**HARNESS_RUN, **kw).overall_combined_error
        for name, kw in (
            ("default", {}),
            ("tail", dict(collect_tail="f32")),
            ("tables", dict(collect_precompute=True)),
            ("both", dict(collect_precompute=True, collect_tail="f32")),
        )
    }
    runs["jax_both"] = float(jt.run_for_errors(
        **HARNESS_RUN, collect_precompute=True, collect_tail="f32").overall_combined_error)
    return tt, runs


def test_collect_tail_f32_inside_parity_gate(harness_runs):
    tt, runs = harness_runs
    assert abs(runs["tail"] - runs["default"]) <= 1e-7 * runs["default"]
    assert runs["tail"] != runs["default"]  # the tail did run in float32
    with pytest.raises(ValueError, match="collect_tail"):
        tt.run_for_errors(**HARNESS_RUN, collect_tail="bf16")


def test_collect_precompute_matches_default(harness_runs):
    _, runs = harness_runs
    assert abs(runs["tables"] - runs["default"]) <= 1e-10 * runs["default"]
    assert abs(runs["both"] - runs["default"]) <= 1e-7 * runs["default"]


def test_tables_and_tail_match_jax(harness_runs):
    _, runs = harness_runs
    assert abs(runs["both"] - runs["jax_both"]) <= 1e-10 * runs["jax_both"]


def test_collect_tail_is_a_no_op_in_float32():
    N, dt = 8, (1.0 / 8) ** 1.5
    trial = TTrial(
        t_make_uniform_grid(N, N, dtype=torch.float32, device="cpu"),
        TModel02(consts_from_dict(J_CONSTS._asdict())), TCase, TField, TForcing, TIntegrator,
        **_params(N, dt),
    )
    assert (trial.run_for_errors(Tf=TF, dt=dt, collect_tail="f32").overall_combined_error
            == trial.run_for_errors(Tf=TF, dt=dt).overall_combined_error)


def test_time_tables_are_built_once_and_within_the_budget(monkeypatch):
    from na_dd_tpu_torch.harness import trial as t_trial

    builds = []
    real = t_trial.build_time_tables
    monkeypatch.setattr(t_trial, "build_time_tables", lambda **kw: builds.append(kw["num"]) or real(**kw))
    N, dt = 8, (1.0 / 8) ** 1.5
    trial = _port_trial(N, dt)
    first = trial.run_for_errors(Tf=TF, dt=dt, collect_precompute=True).overall_combined_error
    again = trial.run_for_errors(Tf=TF, dt=dt, collect_precompute=True).overall_combined_error
    assert first == again and builds == [trial.run_for_errors(Tf=TF, dt=dt).series.t.size - 1]
    # tables of 2 x 5 fields x (steps + 1) planes over the budget: not built
    monkeypatch.setattr(t_trial, "TIME_TABLES_BUDGET", 1000)
    over = trial.run_for_errors(Tf=TF, dt=dt / 2, collect_precompute=True)
    assert len(builds) == 1 and abs(over.overall_combined_error - first) < 1e-2 * first


def test_forcing_from_time_grid_serves_the_inner_values():
    from na_dd_tpu_torch.core.forcing import ForcingFromTimeGrid

    N, dt = 8, 1e-3
    trial = _port_trial(N, dt)
    g, inner = trial.grid, trial.forcing_terms
    tabled = ForcingFromTimeGrid(inner, t0=0.002, dt=dt, num=4)
    with pytest.raises(RuntimeError, match="bind"):
        tabled.fT(g, T_OPS, 0.002)
    tabled.bind(tabled.build_tables(g, T_OPS))
    ts = 0.002 + dt * torch.arange(5, dtype=torch.float64)
    for term in ("fcp", "fT", "fcl", "fcd", "fcs"):
        for j in range(5):
            assert torch.equal(getattr(tabled, term)(g, T_OPS, ts[j]), getattr(inner, term)(g, T_OPS, ts[j]))
        # a time near a grid time takes its row; beyond the grid, the end rows
        assert torch.equal(getattr(tabled, term)(g, T_OPS, ts[2] + 1e-9), getattr(inner, term)(g, T_OPS, ts[2]))
        assert torch.equal(getattr(tabled, term)(g, T_OPS, ts[4] + 5 * dt), getattr(inner, term)(g, T_OPS, ts[4]))


def test_forcing_from_callables():
    from na_dd_tpu_torch.core.forcing import ForcingFromCallables

    g = t_make_uniform_grid(4, 4, device="cpu")
    f = ForcingFromCallables({k: (lambda i: lambda t, x, y: i * t + x * y)(i)
                              for i, k in enumerate(("fcp", "fT", "fcl", "fcd", "fcs"))})
    for i, k in enumerate(("fcp", "fT", "fcl", "fcd", "fcs")):
        assert torch.equal(getattr(f, k)(g, T_OPS, 0.5), i * 0.5 + g.xx * g.yy)


def test_run_spatial_study_matches_jax_cpu_x64():
    """run_spatial_study("pol", levels=3, base_N=4) against the JAX
    package's run_spatial_study("pol") on CPU x64, N=4..16
    (studies/results/pol_cpu_x64.json, studies/pol_cpu_x64.py)."""
    import json
    import pathlib

    from na_dd_tpu_torch.harness.studies import run_spatial_study

    ref = json.loads((pathlib.Path(__file__).resolve().parent.parent / "studies" / "results"
                      / "pol_cpu_x64.json").read_text())["spatial"]
    out = run_spatial_study("pol", levels=3, base_N=4, verbose=False, measure_steady=True, device="cpu")
    assert out["Ns"] == [4, 8, 16] and len(out["steady_s"]) == 3
    for N, err in zip(out["Ns"], out["errors"]):
        x64 = ref["errors"][ref["Ns"].index(N)]
        assert abs(err - x64) <= 1e-10 * x64
    assert len(out["rates"]) == 1 and out["statuses"] == ["OK"]


def test_run_temporal_study_matches_jax():
    """The peaks temporal ladder's first three levels: N = ceil(1/(2 dt)) =
    1, 1, 2 (the degenerate all-boundary grid twice, then one interior
    point under the study's budget floor of 16)."""
    from na_dd_tpu.harness.studies import run_temporal_study as j_run
    from na_dd_tpu_torch.harness.studies import run_temporal_study

    ref = j_run("peaks_fast1e1", levels=3, verbose=False)
    out = run_temporal_study("peaks_fast1e1", levels=3, verbose=False, device="cpu")
    assert out["Ns"] == ref["Ns"] == [1, 1, 2] and out["dts"] == ref["dts"]
    assert out["errors"][:2] == [0.0, 0.0]
    assert abs(out["errors"][2] - ref["errors"][2]) <= 1e-10 * ref["errors"][2]


def test_run_eta_study_matches_jax():
    from na_dd_tpu.harness.studies import run_eta_study as j_run
    from na_dd_tpu_torch.harness.studies import run_eta_study

    ref = j_run("pol", N=6, etas=[10.0, 1000.0], verbose=False)
    out = run_eta_study("pol", N=6, etas=[10.0, 1000.0], verbose=False, device="cpu")
    assert out["etas"] == [10.0, 1000.0] and out["N"] == 6
    for err, j_err in zip(out["errors"], ref["errors"]):
        assert abs(err - j_err) <= 1e-10 * j_err


def test_study_registry_and_budget_match_jax():
    from na_dd_tpu.harness import studies as j_studies
    from na_dd_tpu_torch.harness import studies

    assert list(studies.STUDIES) == list(j_studies.STUDIES)
    for name, cfg in studies.STUDIES.items():
        j_cfg = j_studies.STUDIES[name]
        assert cfg["case_cls"].__name__ == j_cfg["case_cls"].__name__
        assert studies.study_consts(name)._asdict() == j_studies.study_consts(name)._asdict()
        assert cfg.get("min_krylov_unroll") == j_cfg.get("min_krylov_unroll")
        assert {k: v for k, v in cfg["temporal"].items() if k != "N_of_dt"} == {
            k: v for k, v in j_cfg["temporal"].items() if k != "N_of_dt"}
    for N, dt in ((256, (1 / 256) ** 1.5), (200, 1.0), (200, 2.0), (256, 1e-2), (32, 0.3), (2, 0.25)):
        for name in ("pol", "peaks_fast1e1"):
            mc = studies.study_consts(name)
            assert studies._study_unroll(studies.STUDIES[name], N, dt, mc) == j_studies._study_unroll(
                j_studies.STUDIES[name], N, dt, j_studies.study_consts(name))
    assert choose_krylov_unroll is studies.choose_krylov_unroll


# ---------------------------------------------------------------------------
# the port's user entry points (na_dd_tpu_torch.studies): the study CLI, the
# six-notebook reproduction and its report, against the JAX package's
# harness functions, its CPU-x64 records and its report writer; the plotting
# helpers and utils against their JAX twins
# ---------------------------------------------------------------------------
REPO = pathlib.Path(__file__).resolve().parent.parent
RESULTS = REPO / "studies" / "results"
#: keys of the JAX harness's result dicts that are XLA's (compile sharing)
XLA_ONLY_KEYS = {"parallel_compile_s", "shared_compile"}
#: what the port's entry points add to a result: where it ran
PROVENANCE_KEYS = {"kernel_launches", "device"}
#: Absolute floor of an error norm's agreement with the JAX package.  The
#: port's exact solutions (SymPy lambdified to torch) differ from the JAX
#: package's (lambdified to jax.numpy) by one ulp at 10-68 % of the nodes
#: (ExpSin, N=32, t=0.01: 2.2e-16 on the O(1) fields), because torch's and
#: XLA's exp and sin round differently; an error norm of ~1e-7 built from
#: such fields then moves by ~1e-17 absolute (the ExpSin temporal level
#: dt=1e-2 is 4.8e-17, 4.6e-10 relative, from JAX, while the JAX package's
#: own routes, which share XLA's functions, agree to 1.7e-15 relative).
ULP_FLOOR = 1e-16


def _close_to_jax(err, ref, rtol=1e-10):
    return abs(err - ref) <= max(rtol * abs(ref), ULP_FLOOR)


def _outputs_snapshot():
    """Every file under the entry points' default and the JAX study scripts' output
    places, with its modification time."""
    places = [REPO / "studies" / "results_torch", RESULTS]
    files = {p: p.stat().st_mtime_ns for d in places if d.exists() for p in d.rglob("*")}
    root = REPO / "REPRODUCTION.md"
    files[root] = root.stat().st_mtime_ns
    return files


@pytest.fixture(scope="module")
def jax_pol_spatial3():
    """The JAX CLI's spatial study, pol N=2..8 (what run_study.py calls)."""
    from na_dd_tpu.harness.studies import run_spatial_study as j_run

    return j_run("pol", levels=3, verbose=False)


def _saved(tmp_path, pattern):
    (path,) = tmp_path.glob(pattern)
    return json.loads(path.read_text())


@pytest.mark.parametrize("batched", [False, True], ids=["serial", "batched"])
def test_run_study_cli_spatial_matches_jax(jax_pol_spatial3, tmp_path, batched):
    from na_dd_tpu_torch.studies import run_study

    before = _outputs_snapshot()
    (res,) = run_study.main(["--study", "pol", "--kind", "spatial", "--levels", "3",
                             "--device", "cpu", "--results-dir", str(tmp_path)]
                            + (["--batched"] if batched else []))
    assert _outputs_snapshot() == before  # nothing written outside tmp_path
    ref = jax_pol_spatial3
    assert res["Ns"] == ref["Ns"] == [2, 4, 8]
    for err, j_err in zip(res["errors"], ref["errors"]):
        assert abs(err - j_err) <= 1e-10 * j_err
    assert res["kernel_launches"]["bicgstab_solve"] == 0 and res["device"] == "cpu"
    numbers = res["errors"] + res["rates"] + res["wallclock_s"] + (res["steady_s"] or [])
    assert len(numbers) >= 5 and all(type(x) is float for x in numbers)  # what json.dump takes
    saved = _saved(tmp_path, "pol_spatial_batched_*.json" if batched else "pol_spatial_[0-9]*.json")
    assert saved == json.loads(json.dumps(res))
    if batched:  # the keys of the JAX run_spatial_ladder_batched's dict
        assert set(saved) == {"study", "kind", "Ns", "Tf", "eta", "errors", "wallclock_s",
                              "steady_s", "compile_plus_run_s", "krylov_unroll", "rates",
                              "statuses"} | PROVENANCE_KEYS
    else:
        assert set(saved) == (set(ref) - XLA_ONLY_KEYS) | PROVENANCE_KEYS


def test_run_study_cli_temporal_matches_jax(tmp_path):
    from na_dd_tpu.harness.studies import run_temporal_study as j_run
    from na_dd_tpu_torch.studies import run_study

    ref = j_run("expsin", levels=2, verbose=False)
    (res,) = run_study.main(["--study", "expsin", "--kind", "temporal", "--levels", "2",
                             "--device", "cpu", "--results-dir", str(tmp_path)])
    assert res["dts"] == ref["dts"] and res["N"] == ref["N"] == 32
    for err, j_err in zip(res["errors"], ref["errors"]):
        assert _close_to_jax(err, j_err)
    saved = _saved(tmp_path, "expsin_temporal_*.json")
    assert set(saved) == (set(ref) - XLA_ONLY_KEYS) | PROVENANCE_KEYS


def test_run_all_pol_eta_matches_the_cpu_x64_record(tmp_path):
    """The fast mode (precision="mixed", the sweep as one batch) against the
    JAX run_eta_study_batched on CPU x64 (studies/results/batched_cpu_x64.json)."""
    from na_dd_tpu_torch.studies import run_all

    before = _outputs_snapshot()
    assert run_all.main(["--only", "pol", "eta", "--cpu", "--results-dir", str(tmp_path)]) == 0
    assert _outputs_snapshot() == before
    ref = json.loads((RESULTS / "batched_cpu_x64.json").read_text())["eta_batched"]["errors"]
    res = json.loads((tmp_path / "pol_eta_batched.json").read_text())
    assert len(res["errors"]) == 7
    for err, x64 in zip(res["errors"], ref):
        assert abs(err - x64) <= 1e-10 * x64
    assert res["precision"] == "mixed" and res["device"] == "cpu"
    # the 6-digit notebook is over the gate: every level adjudicated, passed
    adj = res["adjudication"]
    assert adj["status"] == "ok" and adj["passed"] and len(adj["gated_levels"]) == 7
    assert {"errors", "wallclock_s", "steady_s", "reference_errors",
            "max_rel_dev_vs_reference", "precision", "total_wallclock_s"} <= set(res)
    row = next(line for line in (tmp_path / "REPRODUCTION.md").read_text().splitlines()
               if line.startswith("| pol | eta |"))
    assert " PASS |" in row


def test_run_all_expsin_temporal_f64_matches_the_cpu_x64_record(tmp_path):
    from na_dd_tpu_torch.studies import run_all
    from na_dd_tpu_torch.studies.reference_values import CPU_X64_ERRORS

    assert run_all.main(["--only", "expsin", "temporal", "--f64", "--cpu",
                         "--results-dir", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "expsin_temporal.json").read_text())
    x64 = CPU_X64_ERRORS[("expsin", "temporal")]
    assert res["precision"] == "full" and len(res["errors"]) == len(x64) == 6
    for k, err in enumerate(res["errors"]):
        assert _close_to_jax(err, x64[k])
    assert "f64_spotcheck" not in res and len(res["steady_s"]) == 6


def _synthetic_archive(path):
    """Archived runs in the JAX script's format: one adjudicated, one within
    the gate, one skipped over budget; the rest MISSING."""
    runs = {
        "pol_spatial": {
            "study": "pol", "kind": "spatial",
            "errors": [4.93452e-05, 1.59616e-05, 4.38284e-09], "rates": [1.99],
            "steady_s": [0.1, 0.1, 0.5], "wallclock_s": [1.0, 1.0, 2.0],
            "max_rel_dev_vs_reference": 1.9e-6, "precision": "mixed", "batched": True,
            "f64_spotcheck": {"level": 2, "N": 256, "f64_error": 4.38284e-09,
                              "mixed_error": 4.38284e-09, "mixed_vs_f64_rel": 3.2e-12,
                              "wallclock_s": 12.0},
            "adjudication": {"status": "ok", "level": 1, "cpu_error": 1.59616e-05,
                             "reference": 1.59616e-05, "cpu_rel_dev": 2.1e-09,
                             "passed": True, "tpu_rel_dev": 1.9e-6},
        },
        "expsin_temporal": {
            "study": "expsin", "kind": "temporal", "errors": [1.0362e-07, 8.3442e-08, 8.1938e-08],
            "rates": [float("nan")], "steady_s": None, "wallclock_s": [0.5, 0.5, 0.25],
            "max_rel_dev_vs_reference": 3e-9, "precision": "full",
        },
        "peaks_fast1e1_eta_batched": {
            "study": "peaks_fast1e1", "kind": "eta_batched", "errors": [7.4984405e-05] * 7,
            "wallclock_s": [3.0], "steady_s": [0.06], "max_rel_dev_vs_reference": 2e-8,
            "precision": "mixed",
            "adjudication": {"status": "skipped_over_budget", "over_gate_levels": [0],
                             "budget_node_steps": 5e7},
        },
        "nfsp_cpcsH1_TclcdH2_spatial": {
            "study": "nfsp_cpcsH1_TclcdH2", "kind": "spatial", "errors": [1e-5, 2e-6, 5e-7, 1e-7],
            "rates": [2.3, 2.1], "steady_s": [1.0, 2.0, 4.0, 8.0], "wallclock_s": [1, 2, 4, 8],
            "max_rel_dev_vs_reference": 0.5, "precision": "full",
            "adjudication": {"status": "ok", "level": 3, "cpu_error": 1e-7, "reference": 2e-7,
                             "cpu_rel_dev": 0.5, "passed": False},
        },
    }
    path.mkdir()
    for name, payload in runs.items():
        (path / f"{name}.json").write_text(json.dumps(payload))


def _table(text):
    """{(study, kind): columns} of the report's table."""
    rows = [line.split("|")[1:-1] for line in text.splitlines() if line.startswith("| ")]
    return {(c[0].strip(), c[1].strip()): [x.strip() for x in c] for c in rows[1:]}


def test_report_rows_equal_the_jax_report(tmp_path):
    from na_dd_tpu_torch.studies.write_reproduction import write_report
    from studies.write_reproduction import write_report as j_write_report

    _synthetic_archive(tmp_path / "results")
    ours = _table(open(write_report(device="NVIDIA H100 80GB HBM3, 700.00 W",
                                    results_dir=str(tmp_path / "results"))).read())
    theirs = _table(open(j_write_report(device="test", results_dir=str(tmp_path / "results"),
                                        out_path=str(tmp_path / "JAX.md"))).read())
    assert len(ours) == len(theirs) == 18 and list(ours) == list(theirs)
    timing = slice(0, -2)  # every column but "finest steady vs ref" and "speedup"
    for key in theirs:
        assert ours[key][timing] == theirs[key][timing], key
    assert sum(row[2] == "MISSING" for row in ours.values()) == 14
    assert ours[("pol", "spatial")][7] == "L1 cpu-x64 2.1e-09 PASS"
    assert ours[("nfsp_cpcsH1_TclcdH2", "spatial")][7] == "L3 cpu-x64 5.0e-01 **FAIL**"
    # the report lands beside the results, never on the JAX study scripts' files
    assert (tmp_path / "results" / "REPRODUCTION.md").is_file()
    with pytest.raises(ValueError, match="JAX study scripts"):
        write_report(results_dir=str(tmp_path / "results"), out_path=str(REPO / "REPRODUCTION.md"))


def test_adjudication_gates_levels_and_lists_those_without_a_record():
    from na_dd_tpu_torch.studies.run_all import adjudicate

    ref = [1.0e-5, 2.0e-6, 4.0e-7]
    res = dict(study="pol", kind="spatial", errors=[1.0e-5, 2.00001e-6, 4.00001e-7])
    # level 0 within the gate; 1 and 2 over it, only 1 with a CPU-x64 value
    adj = adjudicate(res, ref, cpu_x64={1: 2.00001e-6 * (1 + 5e-9)})
    assert adj["status"] == "ok" and adj["passed"] and adj["level"] == 1
    assert adj["skipped_over_budget_levels"] == [2]
    assert [row["level"] for row in adj["gated_levels"]] == [1]
    assert {"status", "level", "cpu_error", "reference", "cpu_rel_dev", "passed"} <= set(adj)
    assert adjudicate(res, ref, cpu_x64={}) == {
        "status": "skipped_over_budget", "over_gate_levels": [1, 2], "budget_node_steps": 5e7}
    failed = adjudicate(res, ref, cpu_x64={1: 2.00001e-6, 2: 4.1e-7})
    assert failed["status"] == "ok" and not failed["passed"] and failed["level"] == 2


def test_a_failed_gate_or_a_raising_run_makes_run_all_exit_nonzero(monkeypatch, tmp_path, capsys):
    from na_dd_tpu_torch.studies import run_all

    sweep = dict(study="expsin", kind="eta_batched", N=32, dt=5e-4, Tf=0.01,
                 etas=list(range(7)), errors=[8.2e-08] * 7, wallclock_s=[0.1], steady_s=[0.1])
    monkeypatch.setattr(run_all, "run_one", lambda *a, **k: dict(sweep))
    monkeypatch.setitem(run_all.CPU_X64_ERRORS, ("expsin", "eta"), dict.fromkeys(range(7), 8.1e-8))
    assert run_all.main(["--only", "expsin", "eta", "--cpu", "--results-dir", str(tmp_path)]) == 1
    assert "FAIL" in capsys.readouterr().out
    assert "**FAIL**" in (tmp_path / "REPRODUCTION.md").read_text()

    def raising(*a, **k):
        raise FloatingPointError("a run that raises")

    monkeypatch.setattr(run_all, "run_one", raising)
    assert run_all.main(["--only", "pol", "temporal", "--cpu", "--results-dir", str(tmp_path)]) == 1
    with pytest.raises(SystemExit, match="matches nothing"):
        run_all.main(["--only", "nosuch", "--cpu", "--results-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="JAX study scripts"):
        run_all.main(["--only", "pol", "--cpu", "--results-dir", str(RESULTS)])


def _ast_value(path, name):
    import ast

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == name:
            return eval(compile(ast.Expression(node.value), str(path), "eval"), {"dict": dict})
    raise AssertionError(f"no {name} in {path}")


def test_plan_and_reference_tables_equal_the_jax_scripts():
    from na_dd_tpu_torch.studies import reference_values as ours
    from na_dd_tpu_torch.studies.run_all import PLAN
    from na_dd_tpu_torch.studies.write_reproduction import ORDER
    from studies import reference_values as theirs
    from studies.write_reproduction import ORDER as J_ORDER

    assert PLAN == _ast_value(REPO / "studies" / "run_all_tpu.py", "PLAN")
    assert ORDER == J_ORDER
    assert ours.REFERENCE_ERRORS == theirs.REFERENCE_ERRORS
    assert ours.REFERENCE_FINAL_RATE == theirs.REFERENCE_FINAL_RATE
    assert ours.REFERENCE_FINEST_WALLCLOCK == theirs.REFERENCE_FINEST_WALLCLOCK
    assert ours.PARITY_GATE == 1e-8


def test_cpu_x64_errors_are_the_record():
    """CPU_X64_ERRORS is studies/results/reproduction_cpu_x64.json, whose pol
    spatial ladder is pol_cpu_x64.json's and eta sweep batched_cpu_x64.json's;
    each of the 18 runs has its levels up to the budget."""
    from na_dd_tpu_torch.studies.reference_values import CPU_X64_ERRORS

    record = json.loads((RESULTS / "reproduction_cpu_x64.json").read_text())
    assert record["budget_node_steps"] == 5e7 and len(record["runs"]) == 18
    copied = {tuple(key.split("/")): dict(enumerate(run["errors"]))
              for key, run in record["runs"].items()}
    assert CPU_X64_ERRORS == copied
    pol = json.loads((RESULTS / "pol_cpu_x64.json").read_text())
    assert list(CPU_X64_ERRORS[("pol", "spatial")].values()) == pol["spatial"]["errors"]
    assert list(CPU_X64_ERRORS[("pol", "temporal")].values()) == pol["temporal"]["errors"]
    eta = json.loads((RESULTS / "batched_cpu_x64.json").read_text())["eta_batched"]["errors"]
    assert list(CPU_X64_ERRORS[("pol", "eta")].values()) == eta
    for study in ("nfsp_cpcsH2_TclcdH3", "nfsp_cpcsH2_TclcdH2", "nfsp_cpcsH1_TclcdH2",
                  "peaks_fast1e1"):
        assert sorted(CPU_X64_ERRORS[(study, "spatial")]) == list(range(7))  # N=2..128


def test_guide_exponent_matches_jax():
    from na_dd_tpu.harness.plotting import guide_exponent as j_guide
    from na_dd_tpu_torch.harness.plotting import guide_exponent

    for xs, es in (([4, 8, 16], [1e-3, 2.5e-4, 6e-5]),
                   ([1e-2, 5e-3, 2.5e-3], [1e-4, 2.5e-5, 6e-6]),
                   ([1.0, 0.5, 0.25, 0.125, 0.0625], [0.0, 0.0, 0.71, 0.32, 0.085]),
                   ([1.0, 2.0], [0.0, 0.0])):
        assert guide_exponent(xs, es, 2.0) == j_guide(xs, es, 2.0)


def _drawn(fig):
    """Every array a figure draws: line data and mesh values, axis by axis."""
    out = []
    for ax in fig.axes:
        out += [np.asarray(line.get_xydata(), dtype=float) for line in ax.lines]
        out += [np.asarray(c.get_array(), dtype=float) for c in ax.collections
                if c.get_array() is not None]
    return out


def test_plots_draw_the_jax_plots_arrays():
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    from na_dd_tpu.harness.plotting import plot_errors_and_rates as j_plot
    from na_dd_tpu.harness.plotting import visualize_mms_solution as j_vis
    from na_dd_tpu.mms.cases import MMSCasePol as JPol
    from na_dd_tpu.models import default_model_consts as j_consts
    from na_dd_tpu_torch.harness.plotting import plot_errors_and_rates, visualize_mms_solution
    from na_dd_tpu_torch.models.consts import default_model_consts

    kw = dict(errors=[1e-3, 2.5e-4, 6e-5, 1.6e-5], rates=[2.0, 1.9], x_values=[4, 8, 16, 32],
              x_label="N", title="demo", expected_rate=2.0)
    figs = [(plot_errors_and_rates(**kw), j_plot(**kw))]
    case = TCase(grid=t_make_uniform_grid(8, 8, device="cpu"),
                 model=TModel02(consts_from_dict(j_consts._asdict())))
    j_case = JPol(j_make_uniform_grid(8, 8), model=JModel02(j_consts))
    assert default_model_consts._asdict() == j_consts._asdict()
    figs.append((visualize_mms_solution(case, time_point=0.1), j_vis(j_case, time_point=0.1)))
    for ours, theirs in figs:
        a, b = _drawn(ours), _drawn(theirs)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-13 * max(1.0, np.abs(y).max()))
        plt.close(ours)
        plt.close(theirs)


def test_newton_step_helper_matches_jax():
    from na_dd_tpu.utils import solve_newton_step_Fx_eq_C as j_step
    from na_dd_tpu_torch.utils import solve_newton_step_Fx_eq_C

    rng = np.random.default_rng(14)
    J = rng.standard_normal((6, 6)) + 6 * np.eye(6)
    x0, Fx0, C = (rng.standard_normal(6) for _ in range(3))
    ref = j_step(x0=x0, Fx0=Fx0, JacFx0=J, C=C)
    np.testing.assert_array_equal(solve_newton_step_Fx_eq_C(x0=x0, Fx0=Fx0, JacFx0=J, C=C), ref)
    np.testing.assert_array_equal(solve_newton_step_Fx_eq_C(
        x0=torch.from_numpy(x0), Fx0=torch.from_numpy(Fx0), JacFx0=torch.from_numpy(J),
        C=torch.from_numpy(C)), ref)
    for bad in (dict(x0=x0[None], Fx0=Fx0, JacFx0=J, C=C), dict(x0=x0, Fx0=Fx0[:5], JacFx0=J, C=C),
                dict(x0=x0, Fx0=Fx0, JacFx0=np.zeros((6, 6)), C=C)):
        with pytest.raises(Exception) as ours:
            solve_newton_step_Fx_eq_C(**bad)
        with pytest.raises(Exception) as theirs:
            j_step(**bad)
        assert type(ours.value) is type(theirs.value) and str(ours.value) == str(theirs.value)


def test_timing_helpers_on_the_cpu(tmp_path):
    import na_dd_tpu.utils as j_utils
    import na_dd_tpu_torch.utils as utils

    assert set(j_utils.__all__) <= set(utils.__all__)
    record = {}
    x = torch.ones(64, dtype=torch.float64)
    for _ in range(2):
        with utils.timed_block(record, "sum", sync=x):
            x.sum()
    assert record["sum"] > 0 and list(record) == ["sum"]
    first, best, out = utils.time_compile_and_run(lambda a: a * 2, x, reps=2)
    assert 0 < best and 0 < first and torch.equal(out, 2 * x)
    assert utils.xla_trace is utils.device_trace
    with utils.device_trace(str(tmp_path / "trace")):
        (x @ x).item()
    assert list((tmp_path / "trace").glob("*.json"))


def test_study_records_are_the_jax_runs():
    """reference_values' 3-D, ensemble and eta-gradient values are
    studies/results/drivers_cpu_x64.json and eta_gradient_study.json; its
    3-D RegHCs levels N=4..64 and its N=32 eta sweep agree with
    chip_smoke.py's THREE_D_CPU_X64 and ETA3_CPU_X64 (≤1e-12)."""
    from na_dd_tpu_torch.studies import reference_values as rv

    rec = json.loads((RESULTS / "drivers_cpu_x64.json").read_text())
    assert rec["command"] == "JAX_PLATFORMS=cpu python studies/drivers_cpu_x64.py"
    assert rv.DRIVERS_CPU_X64_RECORD == "studies/results/drivers_cpu_x64.json"
    assert rv.THREE_D_CONSTS == rec["consts"] == _ast_value(REPO / "chip_smoke.py", "THREE_D_CONSTS")
    assert (rv.THREE_D_TF, rv.THREE_D_ETA) == (rec["spatial"]["Tf"], rec["spatial"]["eta"])
    levels = {(variant, r["N"], r["dt"]): r["error"]
              for variant, rows in rec["spatial"]["variants"].items() for r in rows}
    self_ref = {}
    for ladder in rec["temporal"]["ladders"]:
        for r in ladder["levels"]:
            assert levels.setdefault(("reghcs", r["N"], r["dt"]), r["error"]) == r["error"]
            self_ref[("reghcs", r["N"], r["dt"], ladder["dt_ref"])] = r["self_ref_error"]
    assert rv.THREE_D_LEVELS_CPU_X64 == levels
    assert rv.THREE_D_SELF_REF_CPU_X64 == self_ref
    batched = rec["batched"]
    assert rv.THREE_D_BATCHED_CPU_X64 == {
        (N, batched["dt0"] / 2**k): e for k, (N, e) in enumerate(zip(batched["Ns"], batched["errors"]))}
    assert rv.ETA3_SWEEPS_CPU_X64 == {(sw["N"], sw["dt"]): sw["errors"] for sw in rec["eta3"]["sweeps"]}
    ens = rec["ensemble"]
    assert rv.ENSEMBLE_CPU_X64 == {k: ens[k] for k in ("study", "N", "Tf", "dt")}
    assert rv.ENSEMBLE_NORMS_CPU_X64 == {int(B): row["final_norms"] for B, row in ens["batches"].items()}
    for B, row in ens["batches"].items():
        assert row["etas"] == np.linspace(20.0, 200.0, int(B)).tolist()
    eg = json.loads((RESULTS / "eta_gradient_study.json").read_text())
    assert rv.ETA_GRADIENT_CPU_X64 == {k: eg[k] for k in ("N", "dt", "num_steps", "Kd", "rows",
                                                          "fd_checks")}
    assert eg["backend"] == "cpu"

    smoke_3d = _ast_value(REPO / "chip_smoke.py", "THREE_D_CPU_X64")
    assert sorted(smoke_3d) == [4, 8, 16, 32, 64]
    for N, ref in smoke_3d.items():
        assert abs(rv.THREE_D_LEVELS_CPU_X64[("reghcs", N, 1e-2 / (N // 4))] - ref) <= 1e-12 * ref
    smoke_eta3 = _ast_value(REPO / "chip_smoke.py", "ETA3_CPU_X64")
    for got, ref in zip(rv.ETA3_SWEEPS_CPU_X64[(32, 1.25e-3)], smoke_eta3, strict=True):
        assert abs(got - ref) <= 1e-12 * ref


_ERR = re.compile(r"err=([-+0-9.e]+)")


def _stream_errors(cell):
    """The err= numbers of a code cell's saved stream outputs, as printed."""
    text = "".join("".join(o["text"]) for o in cell["outputs"] if o["output_type"] == "stream")
    return _ERR.findall(text)


def _printed(errors):
    return [f"{e:.6e}" for e in errors]


def test_notebooks_mirror_the_jax_notebooks(tmp_path, monkeypatch):
    """make_notebook builds the seven notebooks from the committed
    studies/results_torch/: the JAX notebooks' cells in number, kind and
    order; code cells that compile and whose port imports resolve; no JAX,
    no JAX package, no TPU; the saved errors those of the archived runs.
    One rate plot is drawn for real (its arrays are the JAX plot's, tested
    above); the others are stubbed, to keep the test's time down."""
    import ast
    import importlib
    import importlib.util

    from na_dd_tpu_torch.studies import make_notebook
    from studies import make_notebook as j_make_notebook

    assert make_notebook.STUDY_KEYS == j_make_notebook.STUDY_KEYS
    pol = json.loads((REPO / "studies" / "results_torch" / "pol_spatial.json").read_text())
    if importlib.util.find_spec("matplotlib") is not None:
        png = make_notebook._rate_plot_png(pol, "Ns", "N", "pol spatial")
        assert png.startswith(b"\x89PNG")
    monkeypatch.setattr(make_notebook, "_rate_plot_png", lambda *a: b"\x89PNG stub")
    assert make_notebook.main(["--all", "--three-d", "--outdir", str(tmp_path)]) == 0
    names = sorted(p.name for p in tmp_path.glob("*.ipynb"))
    assert names == sorted(p.name for p in (REPO / "studies" / "notebooks").glob("*.ipynb"))
    assert len(names) == 7
    archive = REPO / "studies" / "results_torch"
    for name in names:
        nb = json.loads((tmp_path / name).read_text())
        study = name.split("_reghcstriple_")[0]
        if name.startswith("three_d"):
            ref = j_make_notebook.build_three_d_notebook(embed_results=False)
        else:
            ref = j_make_notebook.build_notebook(study, embed_results=False)
        assert [c["cell_type"] for c in nb["cells"]] == [c["cell_type"] for c in ref["cells"]]
        for cell in nb["cells"]:
            src = "".join(cell["source"])
            assert not re.search(r"\bjax\b", src) and "na_dd_tpu." not in src
            assert "TPU v5e" not in src and "TPU" not in src
            if cell["cell_type"] != "code":
                continue
            for node in ast.walk(ast.parse(compile(src, name, "exec", ast.PyCF_ONLY_AST))):
                if isinstance(node, ast.ImportFrom) and node.module.startswith("na_dd_tpu_torch"):
                    module = importlib.import_module(node.module)
                    for alias in node.names:
                        assert hasattr(module, alias.name), f"{node.module}.{alias.name}"
        code = [c for c in nb["cells"] if c["cell_type"] == "code"]
        if name.startswith("three_d"):
            errors = []
            for fname, _label in make_notebook.THREE_D_RESULTS:
                if (archive / fname).exists():
                    res = json.loads((archive / fname).read_text())
                    errors += [lv["error"] for lv in res["levels"]] if "levels" in res else res["errors"]
            assert errors and _stream_errors(code[-1]) == _printed(errors)
            ladder = json.loads((archive / "three_d_study.json").read_text())
            assert ladder["device"] in "".join(nb["cells"][0]["source"])
            continue
        runs = [json.loads((archive / f"{study}_{kind}.json").read_text())
                for kind in ("spatial", "temporal", "eta_batched")]
        for cell, run in zip(code[-3:], runs, strict=True):
            assert _stream_errors(cell) == _printed(run["errors"])
        assert runs[0]["device"] in "".join(nb["cells"][0]["source"])
    with pytest.raises(ValueError, match="JAX study scripts"):
        make_notebook.main(["--study", "pol", "--outdir", str(REPO / "studies" / "notebooks")])
