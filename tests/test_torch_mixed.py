"""The port's production modes against the JAX package on CPU float64.

``precision="mixed"`` (float32 Krylov under float64 iterative refinement)
through ``na_dd_tpu_torch.harness.studies._make_trial``, beside the JAX
package's ``na_dd_tpu.harness.studies._make_trial`` in the same mode — the
twins of ``tests/test_mixed_precision.py`` (all but the ``mixed_df`` ones):

* the pol study level N=16 (Tf=0.01, dt=5e-4, budget 8) in the per-solve
  mixed mode (the JAX package with its jnp solves), the fused
  block-triangular mode (analytic
  couplings: the JAX triple-solve Pallas kernel in interpret mode, the
  port's ``kernels.triple_solve``), and ``mixed_fast`` (refine 1, no final
  check, the float32 error tail and the time tables; the JAX package's
  per-solve Pallas kernel): each error ≤1e-10 relative to the JAX
  package's, ≤1e-8 to the port's float64 level, every solve converged;
* one ``step_fn`` at N=8 of the per-solve and the fused mixed form (the
  JAX package's Pallas kernels in interpret mode: the f32-only kernels
  inside an f64 run): each field ≤1e-12 relative to its max-norm, the same
  Krylov iteration total;
* the validation, the iteration count over every pass, the rhs noise floor
  of a second Newton sweep and ``mixed_final_check=False`` (the same state
  bit for bit, the same iterations) on the port;
* ``mixed_df=True`` (the refinement's residuals in double-float): one step
  at N=8, per-solve and fused, against the JAX package's ``mixed_df`` step
  (≤1e-12), and the DF refinement of a random system against the float64
  one;
* ``precision="df"`` (the double-float step), the twins of
  ``tests/test_df_mode.py``: one step at N=8 (dt=1e-3, budget 8,
  ``mixed_refine=1``, no final check) on the fused (K4) and the per-solve
  (K1) route against the JAX package's float64 step, each field ≤1e-13
  relative to its max-norm, boundary rows included; the JAX package's
  refusals; the df ladder N=8, 16 against the JAX package's eager CPU-x64
  df record ``studies/results/df_cpu_x64.json`` (≤1e-8) and the df level
  with the time tables and the float32 tail on the port's float64 level
  (≤1e-8).  No JAX df step runs here: the JAX package's lifted step takes
  seconds a step even eagerly.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from na_dd_tpu.harness.studies import _make_trial as j_make_trial
from na_dd_tpu.harness.studies import study_consts as j_study_consts
from na_dd_tpu.mms import cases as j_cases
from na_dd_tpu.ops.shifts import LOCAL_OPS as J_OPS
from na_dd_tpu_torch.convert import state_from_numpy
from na_dd_tpu_torch.harness.studies import _make_trial, study_consts
from na_dd_tpu_torch.integrators import MIXED_INNER_TOL, KrylovBackend, MixedBackend
from na_dd_tpu_torch.mms import cases
from na_dd_tpu_torch.mms.engine import state_from_mms_when
from na_dd_tpu_torch.ops.linsolve import Stencil5
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS

RUN = dict(Tf=0.01, dt=5e-4)
FAST_RUN = dict(collect_tail="f32", collect_precompute=True)
FIELDS = ("cp", "T", "cl", "cd", "cs")
# mode: (the port's integrator kwargs, the JAX package's, run kwargs)
MODES = {
    "mixed": (dict(precision="mixed"), dict(precision="mixed"), {}),
    "mixed_fused": (
        dict(precision="mixed", coupling_source="analytic"),
        dict(precision="mixed", stencil_backend="pallas", coupling_source="analytic"),
        {},
    ),
    "mixed_fast": (
        dict(precision="mixed", mixed_refine=1, mixed_final_check=False),
        dict(precision="mixed", stencil_backend="pallas", mixed_refine=1, mixed_final_check=False),
        FAST_RUN,
    ),
}


def _port_trial(N, **kw):
    kw.setdefault("krylov_unroll", 8)
    return _make_trial(cases.MMSCasePol, N, 50.0, mc=study_consts("pol"), device="cpu", **kw)


def _jax_trial(N, **kw):
    return j_make_trial(j_cases.MMSCasePol, N, 50.0, mc=j_study_consts("pol"), krylov_unroll=8, **kw)


_PORT_RUNS = {}


def _port_run(port_kw, run_kw):
    """The port's N=16 level in one mode: (trial, summary, Krylov warnings),
    run once per mode."""
    key = (tuple(sorted(port_kw.items())), tuple(sorted(run_kw.items())))
    if key not in _PORT_RUNS:
        trial = _port_trial(16, **port_kw)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            summary = trial.run_for_errors(**RUN, **run_kw)
        _PORT_RUNS[key] = (trial, summary, [w for w in caught if "Krylov" in str(w.message)])
    return _PORT_RUNS[key]


@pytest.fixture(scope="module")
def port_f64():
    return _port_run({}, {})[1].overall_combined_error


@pytest.fixture(scope="module", params=list(MODES))
def mode_run(request):
    port_kw, jax_kw, run_kw = MODES[request.param]
    trial, summary, krylov_warnings = _port_run(port_kw, run_kw)
    j_summary = _jax_trial(16, **jax_kw).run_for_errors(**RUN, **run_kw)
    return request.param, trial, summary, krylov_warnings, float(j_summary.overall_combined_error)


def test_mode_matches_jax(mode_run):
    _, _, summary, _, j_err = mode_run
    assert abs(summary.overall_combined_error - j_err) <= 1e-10 * j_err


def test_mode_sits_on_the_f64_level(mode_run, port_f64):
    _, trial, summary, _, _ = mode_run
    assert trial.integrator.precision == "mixed"
    assert trial.initial_state.T.dtype == torch.float64  # only the Krylov runs in f32
    assert abs(summary.overall_combined_error - port_f64) <= 1e-8 * port_f64


def test_mode_solves_converged(mode_run):
    name, trial, summary, krylov_warnings, _ = mode_run
    assert not krylov_warnings
    assert summary.series.krylov_converged.all()
    assert isinstance(trial.integrator.solver, MixedBackend)
    refine = trial.integrator.mixed_refine
    assert (refine, trial.integrator.mixed_final_check) == ((1, False) if name == "mixed_fast" else (2, True))


def test_fused_mixed_refine_1_sits_on_the_f64_level(port_f64):
    _, summary, _ = _port_run(dict(precision="mixed", coupling_source="analytic", mixed_refine=1), {})
    assert abs(summary.overall_combined_error - port_f64) <= 1e-8 * port_f64
    assert summary.series.krylov_converged.all()


def _s0(trial):
    return state_from_mms_when(mms_case=trial.mms_case, t=0.0, grid=trial.grid)


@pytest.fixture(scope="module", params=["per_solve", "fused"])
def mixed_step(request):
    """One step at N=8, dt=1e-3, with residual tracking, in both packages,
    in the per-solve or the fused mixed form."""
    extra = dict(precision="mixed", track_residuals=True)
    j_extra = dict(extra, stencil_backend="pallas")
    if request.param == "fused":
        extra["coupling_source"] = j_extra["coupling_source"] = "analytic"
    jt = _jax_trial(8, **j_extra)
    j_state, j_diag = jax.jit(jt.integrator.step_fn, static_argnums=1)(
        jt.grid, J_OPS, jt.initial_state, 0.0, 1e-3
    )
    tt = _port_trial(8, **extra)
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
    t_state, t_diag = tt.integrator.step_fn(tt.grid, LOCAL_OPS, s0, 0.0, 1e-3)
    return request.param, j_state, j_diag, t_state, t_diag, calls


@pytest.mark.parametrize("field", FIELDS)
def test_mixed_step_field_matches_jax(mixed_step, field):
    _, j_state, _, t_state, _, _ = mixed_step
    ref = np.asarray(getattr(j_state, field))
    assert np.max(np.abs(getattr(t_state, field).numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_mixed_step_diagnostics_and_route(mixed_step):
    form, _, j_diag, _, t_diag, calls = mixed_step
    assert int(t_diag.krylov_iters) == int(j_diag.krylov_iters) > 0
    assert bool(t_diag.krylov_converged) and bool(j_diag.krylov_converged)
    for name in ("residual_T", "residual_cl", "residual_cd"):
        ref = np.asarray(getattr(j_diag, name))
        assert np.max(np.abs(getattr(t_diag, name).numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))
    assert calls == ({"solve": 0, "solve_triple": 1} if form == "fused" else {"solve": 3, "solve_triple": 0})


def test_precision_is_validated():
    with pytest.raises(ValueError, match="precision"):
        _port_trial(8, precision="half")
    assert _port_trial(8, precision="df").integrator.precision == "df"
    with pytest.raises(ValueError, match="mixed_refine"):
        _port_trial(8, precision="mixed", mixed_refine=-1)
    integ = _port_trial(8).integrator
    assert (integ.precision, integ.mixed_refine, integ.mixed_final_check) == ("full", 2, True)
    assert type(integ.solver) is KrylovBackend


def test_mixed_requires_a_float64_grid():
    with pytest.raises(ValueError, match="float64"):
        _port_trial(8, precision="mixed", dtype=torch.float32)


def _step(**kw):
    trial = _port_trial(8, **kw)
    return trial.integrator.step_fn(trial.grid, LOCAL_OPS, _s0(trial), 0.0, 1e-3)


@pytest.mark.parametrize("form", [{}, dict(coupling_source="analytic")], ids=["per_solve", "fused"])
def test_mixed_iters_count_every_pass(form):
    _, d64 = _step(**form)
    _, dm = _step(precision="mixed", **form)
    assert int(dm.krylov_iters) > int(d64.krylov_iters)
    assert bool(dm.krylov_converged)


@pytest.mark.parametrize("form", [{}, dict(coupling_source="analytic")], ids=["per_solve", "fused"])
def test_mixed_converged_under_a_second_newton_sweep(form):
    """The second sweep's rhs has mostly cancelled; its true residual sits
    at the rhs's rounding floor, which the verdict must accept."""
    _, diag = _step(precision="mixed", krylov_unroll=16, num_newton_steps=2, **form)
    assert bool(diag.krylov_converged), float(diag.krylov_resnorm_sq)


@pytest.mark.parametrize("form", [{}, dict(coupling_source="analytic")], ids=["per_solve", "fused"])
def test_mixed_final_check_off_gives_the_same_state(form):
    s_on, d_on = _step(precision="mixed", **form)
    s_off, d_off = _step(precision="mixed", mixed_final_check=False, **form)
    for a, b in zip(s_on, s_off):
        assert torch.equal(a, b)
    assert bool(d_on.krylov_converged) and bool(d_off.krylov_converged)
    assert int(d_on.krylov_iters) == int(d_off.krylov_iters)


def test_mixed_backend_refines_to_the_f64_tolerance():
    """A random diagonally dominant 5-point system: three passes bring the
    f64 true residual under 1e-13·‖b‖, where one f32 solve stops near its
    inner tolerance."""
    rng = np.random.default_rng(5)
    n = 33
    mask = torch.zeros((n, n), dtype=torch.float64)
    mask[1:-1, 1:-1] = 1.0
    off = [torch.as_tensor(rng.uniform(-1.0, 0.0, (n, n))) * mask for _ in range(4)]
    st = Stencil5(4.5 * mask + (1.0 - mask), *off)
    b = torch.as_tensor(rng.standard_normal((n, n))) * mask
    x, info = MixedBackend(iters=40).solve(st, b, mask)
    r = (b - st.apply(LOCAL_OPS, x)) * mask
    assert float(torch.sum(r * r)) <= (1e-13) ** 2 * float(torch.sum(b * b))
    assert bool(info["converged"]) and float(info["resnorm_sq"]) == float(torch.sum(r * r))
    x1, info1 = MixedBackend(iters=40, refine=0, final_check=False).solve(st, b, mask)
    r1 = (b - st.apply(LOCAL_OPS, x1)) * mask
    assert float(torch.sum(r1 * r1)) > (1e-13) ** 2 * float(torch.sum(b * b))
    assert float(torch.sum(r1 * r1)) <= (10 * MIXED_INNER_TOL) ** 2 * float(torch.sum(b * b))
    assert int(info["iters"]) > int(info1["iters"]) > 0


# ---------------------------------------------------------------------------
# precision="df" and mixed_df
# ---------------------------------------------------------------------------
import json  # noqa: E402
import os  # noqa: E402

from na_dd_tpu_torch.ops import doublefloat as dfm  # noqa: E402

DF_KW = dict(precision="df", mixed_refine=1, mixed_final_check=False)
DF_RECORD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "studies", "results", "df_cpu_x64.json")


@pytest.fixture(scope="module")
def jax_f64_step():
    """The JAX package's float64 step at N=8, dt=1e-3, budget 8 (the
    reference of tests/test_df_mode.py), and its initial state on the port."""
    jt = _jax_trial(8)
    j_state, _ = jax.jit(jt.integrator.step_fn, static_argnums=1)(
        jt.grid, J_OPS, jt.initial_state, 0.0, 1e-3
    )
    s0 = state_from_numpy({k: np.asarray(v) for k, v in jt.initial_state._asdict().items()},
                          device="cpu")
    return j_state, s0


def _counting(integ):
    """Count the backend calls of each route of the df sweep."""
    calls = {"solve_df": 0, "solve_triple_df": 0}
    solver = integ.solver
    for name in calls:
        def wrapped(*args, _name=name, _fn=getattr(solver, name)):
            calls[_name] += 1
            return _fn(*args)
        setattr(solver, name, wrapped)
    return calls


@pytest.fixture(scope="module", params=["fused", "per_solve"])
def df_step(request, jax_f64_step):
    extra = {} if request.param == "fused" else dict(fused_triple=False)
    tt = _port_trial(8, **DF_KW, **extra)
    calls = _counting(tt.integrator)
    t_state, t_diag = tt.integrator.step_fn(tt.grid, LOCAL_OPS, jax_f64_step[1], 0.0, 1e-3)
    return request.param, jax_f64_step[0], t_state, t_diag, calls


@pytest.mark.parametrize("field", FIELDS)
def test_df_step_field_matches_jax_f64(df_step, field):
    """Each field of the df step within 1e-13 of the JAX float64 step,
    relative to its max-norm; the boundary rows at the same gate (not bit
    for bit: the corrector's boundary zeros are exact, but cl/cd keep their
    boundary through a DF add)."""
    _, j_state, t_state, _, _ = df_step
    ref = np.asarray(getattr(j_state, field))
    got = getattr(t_state, field)
    assert got.dtype == torch.float64
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-13 * scale
    for row in (0, -1):
        assert np.max(np.abs(got.numpy()[row] - ref[row])) <= 1e-13 * scale


def test_df_step_diagnostics_and_route(df_step):
    form, _, _, t_diag, calls = df_step
    assert bool(t_diag.krylov_converged) and int(t_diag.krylov_iters) > 0
    assert bool(t_diag.hcs_denominator_ok)
    assert calls == ({"solve_df": 0, "solve_triple_df": 1} if form == "fused"
                     else {"solve_df": 3, "solve_triple_df": 0})


@pytest.mark.parametrize("form", [{}, dict(fused_triple=False)], ids=["fused", "per_solve"])
def test_df_converged_under_a_second_newton_sweep(form):
    """The second sweep's rhs has mostly cancelled; its DF true residual sits
    at the DF rounding floor of the Newton rhs, which the verdict accepts
    (the JAX package's df verdict takes the cancelled rhs's own floor and
    reports this step unconverged)."""
    _, diag = _step(precision="df", krylov_unroll=16, num_newton_steps=2, **form)
    assert bool(diag.krylov_converged), float(diag.krylov_resnorm_sq)


def test_df_validation_and_requirements():
    """The JAX package's refusals (tests/test_df_mode.py): assembled
    analytic planes, no adjoint; its "requires x64" is the port's "requires
    a float64 grid"; a sharded ops provider is refused at the step."""
    with pytest.raises(ValueError, match="assemble_stencil"):
        _port_trial(8, precision="df", assemble_stencil=False)
    with pytest.raises(ValueError, match="analytic"):
        _port_trial(8, precision="df", stencil_source="probe")
    with pytest.raises(ValueError, match="differentiable"):
        _port_trial(8, precision="df", differentiable=True)
    with pytest.raises(ValueError, match="float64"):
        _port_trial(8, precision="df", dtype=torch.float32)
    trial = _port_trial(8, precision="df")
    assert isinstance(trial.integrator.solver, MixedBackend)

    class Sharded(type(LOCAL_OPS)):
        sharded = True

    with pytest.raises(ValueError, match="sharded"):
        trial.integrator.step_fn(trial.grid, Sharded(), _s0(trial), 0.0, 1e-3)


@pytest.fixture(scope="module", params=["per_solve", "fused"])
def mixed_df_step(request):
    extra = dict(precision="mixed", mixed_df=True, track_residuals=True)
    j_extra = dict(extra)
    if request.param == "fused":
        extra["coupling_source"] = j_extra["coupling_source"] = "analytic"
        j_extra["stencil_backend"] = "pallas"
    jt = _jax_trial(8, **j_extra)
    j_state, j_diag = jax.jit(jt.integrator.step_fn, static_argnums=1)(
        jt.grid, J_OPS, jt.initial_state, 0.0, 1e-3
    )
    tt = _port_trial(8, **extra)
    assert tt.integrator.solver.df
    s0 = state_from_numpy({k: np.asarray(v) for k, v in jt.initial_state._asdict().items()},
                          device="cpu")
    t_state, t_diag = tt.integrator.step_fn(tt.grid, LOCAL_OPS, s0, 0.0, 1e-3)
    return j_state, j_diag, t_state, t_diag


@pytest.mark.parametrize("field", FIELDS)
def test_mixed_df_step_field_matches_jax(mixed_df_step, field):
    j_state, j_diag, t_state, t_diag = mixed_df_step
    ref = np.asarray(getattr(j_state, field))
    assert np.max(np.abs(getattr(t_state, field).numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))
    assert int(t_diag.krylov_iters) == int(j_diag.krylov_iters) > 0
    assert bool(t_diag.krylov_converged)


def _df_record():
    with open(DF_RECORD) as f:
        return json.load(f)


@pytest.mark.parametrize("N", [8, 16])
def test_df_ladder_matches_the_cpu_x64_record(N):
    """The df pol spatial level (Tf = 0.01, dt = h^1.5, the study's budget,
    refine 1, no final check, float64 norms) against the JAX package's
    eager CPU-x64 df record, ≤1e-8."""
    from na_dd_tpu_torch.harness.studies import STUDIES, _study_unroll

    rec = _df_record()["df"][str(N)]
    dt = (1.0 / N) ** 1.5
    mc = study_consts("pol")
    trial = _port_trial(N, krylov_unroll=_study_unroll(STUDIES["pol"], N, dt, mc), **DF_KW)
    err = trial.run_for_errors(Tf=0.01, dt=dt).overall_combined_error
    assert abs(err - rec["error"]) <= 1e-8 * rec["error"]


def test_df_fast_sits_on_the_f64_level(port_f64):
    """The df level with bench.py's df_fast knobs (time tables, float32
    error tail) on the port's float64 level (1e-8), every solve converged."""
    _, summary, krylov_warnings = _port_run(dict(DF_KW, coupling_source="analytic"), FAST_RUN)
    assert abs(summary.overall_combined_error - port_f64) <= 1e-8 * port_f64
    assert not krylov_warnings and summary.series.krylov_converged.all()


def test_mixed_df_backend_solve_matches_the_f64_refinement():
    """A random diagonally dominant system: the DF-residual refinement
    reaches the same float64 tolerance as the float64-residual one, its
    residual apply the DF one (the float64 apply unused)."""
    rng = np.random.default_rng(5)
    n = 33
    mask = torch.zeros((n, n), dtype=torch.float64)
    mask[1:-1, 1:-1] = 1.0
    off = [torch.as_tensor(rng.uniform(-1.0, 0.0, (n, n))) * mask for _ in range(4)]
    st = Stencil5(4.5 * mask + (1.0 - mask), *off)
    b = torch.as_tensor(rng.standard_normal((n, n))) * mask
    x_df, info_df = MixedBackend(iters=40, df=True).solve(st, b, mask)
    x, info = MixedBackend(iters=40).solve(st, b, mask)
    r = (b - st.apply(LOCAL_OPS, x_df)) * mask
    assert float(torch.sum(r * r)) <= (1e-13) ** 2 * float(torch.sum(b * b))
    assert bool(info_df["converged"]) and int(info_df["iters"]) == int(info["iters"])
    assert float(torch.max(torch.abs(x_df - x))) <= 1e-13 * float(torch.max(torch.abs(x)))
    # the DF refinement on DF planes (precision="df"): the same solve
    st_df = Stencil5(*(dfm.df_split(p) for p in st))
    z, info_z = MixedBackend(iters=40, final_check=True).solve_df(st_df, dfm.df_split(b), mask)
    assert float(torch.max(torch.abs(dfm.df_to(z, torch.float64) - x))) <= (
        1e-13 * float(torch.max(torch.abs(x))))
    assert bool(info_z["converged"])


@pytest.mark.parametrize("argv", [["--precision", "df"], ["--precision", "mixed", "--mixed-df"]],
                         ids=["df", "mixed_df"])
def test_run_study_cli_takes_the_double_float_modes(tmp_path, argv):
    """The study CLI's ``--precision df`` and ``--mixed-df`` (the JAX CLI's
    NA_DD_TPU_PRECISION=df and NA_DD_TPU_MIXED_DF=1) on the pol ladder
    N=2..16: N=8 and 16 on the JAX package's CPU-x64 df record (≤1e-8; the
    record is of refine 1, the CLI runs the integrator's default refine 2)."""
    from na_dd_tpu_torch.studies import run_study

    (res,) = run_study.main(["--study", "pol", "--kind", "spatial", "--levels", "4",
                             "--device", "cpu", "--results-dir", str(tmp_path), *argv])
    rec = _df_record()["df"]
    assert res["Ns"] == [2, 4, 8, 16]
    for N, err in zip(res["Ns"][2:], res["errors"][2:]):
        assert abs(err - rec[str(N)]["error"]) <= 1e-8 * rec[str(N)]["error"]
