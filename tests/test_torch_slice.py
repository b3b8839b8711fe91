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
the analytic routes also within 1e-10 of the JAX package's CPU-x64 values."""

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
