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
  bit for bit, the same iterations) on the port.
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
    with pytest.raises(ValueError, match="precision"):
        _port_trial(8, precision="df")
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
