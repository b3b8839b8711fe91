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
