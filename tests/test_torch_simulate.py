"""The modeller's path of the port against the JAX package on CPU float64:
the production entry points (``simulate``, ``simulate_adaptive``, the released
and dissolved fractions), checkpoints (and ``.npz`` interop both ways), the
legacy study runner, ``Stencil5.transpose``, the block-cyclic-reduction
direct solve and ``linear_solver="direct"``, and the IFT gradients
(``differentiable=True``, ``build_simulator``, ``fit_parameters``), each a
twin of the JAX package's tests at their sizes (N = 5–16), with the inputs
made from one seed with numpy.

Tolerances, stated per comparison: states relative to the field's max-norm,
1e-13 after a fixed-step run, 1e-12 after an adaptive one (the same
accept/reject decisions, exactly); direct solves 1e-12 against dense ``torch.linalg.solve``;
study errors 1e-10 relative to JAX's; every gradient 1e-9 relative to
``jax.grad`` (the two run the same arithmetic: measured agreement ~1e-15),
and against central differences as the JAX tests have them; the solver
options (colour-probed planes, the matrix-free route, the while form) one
step against the JAX package's at 1e-12, their constructor checks, and the
while-form gradient (``krylov_unroll=None``) against ``jax.grad`` at 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from na_dd_tpu.core import FieldRegHCsTriple as JFieldReg
from na_dd_tpu.core import MMSForcingRegHCsTriple as JForcingReg
from na_dd_tpu.core.state import State as JState
from na_dd_tpu.harness import checkpoint as jckpt
from na_dd_tpu.harness.gradients import build_simulator as j_build_simulator
from na_dd_tpu.harness.gradients import fit_parameters as j_fit_parameters
from na_dd_tpu.harness.legacy import run_convergence_studies as j_run_convergence_studies
from na_dd_tpu.harness.simulate import dissolved_drug_fraction as j_dissolved
from na_dd_tpu.harness.simulate import make_integrator as j_make_integrator
from na_dd_tpu.harness.simulate import released_drug_fraction as j_released
from na_dd_tpu.harness.simulate import simulate as j_simulate
from na_dd_tpu.harness.simulate import simulate_adaptive as j_simulate_adaptive
from na_dd_tpu.harness.studies import _make_trial as j_make_trial
from na_dd_tpu.harness.studies import study_consts as j_study_consts
from na_dd_tpu.integrators import PCTrapezoidalRegHCsTriple as JIntegratorReg
from na_dd_tpu.mms import state_from_mms_when as j_state_from_mms
from na_dd_tpu.mms.cases import MMSCaseExpSin as JExpSin
from na_dd_tpu.mms.cases import MMSCasePol as JPol
from na_dd_tpu.models import Model02 as JModel02
from na_dd_tpu.models import default_model_consts as j_default_consts
from na_dd_tpu.ops import LOCAL_OPS as J_OPS
from na_dd_tpu.ops import linsolve as j_linsolve
from na_dd_tpu.ops import make_uniform_grid as j_make_uniform_grid
from na_dd_tpu.ops.direct_solve import stencil5_solve_direct as j_solve_direct
from na_dd_tpu.ops.inner_products import inner_H as j_inner_H
from na_dd_tpu.three_d import make_integrator3 as j_make_integrator3
from na_dd_tpu.three_d.grid import make_uniform_grid3 as j_make_uniform_grid3
from na_dd_tpu.three_d.shifts import LOCAL_OPS3 as J_OPS3
from na_dd_tpu_torch.convert import stencil5_from_numpy
from na_dd_tpu_torch.core import FieldRegHCsTriple, MMSForcingRegHCsTriple
from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.harness import (
    build_simulator,
    dissolved_drug_fraction,
    fit_parameters,
    make_integrator,
    released_drug_fraction,
    simulate,
    simulate_adaptive,
)
from na_dd_tpu_torch.harness.checkpoint import (
    latest_checkpoint,
    load_state,
    run_checkpointed,
    save_state,
)
from na_dd_tpu_torch.harness.legacy import run_convergence_studies
from na_dd_tpu_torch.harness.studies import _make_trial, study_consts
from na_dd_tpu_torch.integrators import (
    DirectMixedBackend,
    ForwardEulerIntegrator,
    PCTrapezoidalRegHCsTriple,
)
from na_dd_tpu_torch.mms import state_from_mms_when
from na_dd_tpu_torch.mms.cases import MMSCaseExpSin, MMSCasePol
from na_dd_tpu_torch.models.coefficients import Model02
from na_dd_tpu_torch.models.consts import default_model_consts
from na_dd_tpu_torch.ops import adjoint, kernels
from na_dd_tpu_torch.ops.direct_solve import block_tridiag_solve_bcr, stencil5_solve_direct
from na_dd_tpu_torch.ops.grid import make_uniform_grid
from na_dd_tpu_torch.ops.inner_products import inner_H
from na_dd_tpu_torch.ops.linsolve import Stencil5
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS
from na_dd_tpu_torch.three_d.harness import make_integrator3
from na_dd_tpu_torch.three_d.grid import make_uniform_grid3
from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

SEED = 20260808
CPU = "cpu"


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel_max(port, ref):
    """max|port − ref| / max|ref|."""
    port, ref = _np(port), _np(ref)
    assert port.shape == ref.shape
    return float(np.max(np.abs(port - ref))) / max(float(np.max(np.abs(ref))), 1e-300)


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def both_states(arrays):
    """The same five numpy planes (or volumes) as a JAX and a port State."""
    return (JState(*(jnp.asarray(a) for a in arrays)),
            State(*(torch.as_tensor(a) for a in arrays)))


def assert_states_close(port, ref, rtol):
    for name, a, b in zip(State._fields, port, ref):
        assert rel_max(a, b) <= rtol, name


# ---------------------------------------------------------------------------
# simulate and the drug fractions (tests/test_simulate.py)
# ---------------------------------------------------------------------------
SIM_MC = dict(Kd=1e-2, Sd=1.0)


@pytest.fixture(scope="module")
def bump():
    """N=12, the bump initial state of tests/test_simulate.py."""
    jg = j_make_uniform_grid(12, 12)
    g = make_uniform_grid(12, 12, device=CPU)
    b = np.sin(np.pi * np.asarray(jg.xx)) * np.sin(np.pi * np.asarray(jg.yy))
    js0, s0 = both_states([b, 0.5 * b, 0.2 * b, 0.0 * b, 0.3 * b])
    return jg, g, js0, s0


@pytest.fixture(scope="module")
def sim_runs(bump):
    """{variant: (JAX (final, times, snaps), port (final, times, snaps))}:
    cstriple 8 steps of 1e-3, every 4th kept; reghcstriple 20 steps of 2e-3,
    every 10th kept."""
    jg, g, js0, s0 = bump
    out = {}
    for variant, dt, steps, every in (("cstriple", 1e-3, 8, 4), ("reghcstriple", 2e-3, 20, 10)):
        ji = j_make_integrator(jg, JModel02(j_default_consts._replace(**SIM_MC)), variant=variant)
        ti = make_integrator(g, Model02(default_model_consts._replace(**SIM_MC)), variant=variant)
        out[variant] = (
            j_simulate(ji, jg, js0, dt=dt, num_steps=steps, snapshot_every=every),
            simulate(ti, g, s0, dt=dt, num_steps=steps, snapshot_every=every),
        )
    return out


@pytest.mark.parametrize("variant", ["cstriple", "reghcstriple"])
def test_simulate_with_snapshots_matches_jax(sim_runs, variant):
    (j_fin, j_times, j_snaps), (fin, times, snaps) = sim_runs[variant]
    assert_states_close(fin, j_fin, 1e-13)
    assert snaps.cp.shape == tuple(j_snaps.cp.shape)
    assert_states_close(snaps, j_snaps, 1e-13)
    np.testing.assert_array_equal(times.numpy(), np.asarray(j_times))
    for a, b in zip(snaps, fin):  # the last snapshot is the final state
        assert torch.equal(a[-1], b)


def test_simulate_without_snapshots_matches(bump, sim_runs):
    jg, g, _js0, s0 = bump
    ti = make_integrator(g, Model02(default_model_consts._replace(**SIM_MC)))
    fin, times, snaps = simulate(ti, g, s0, dt=2e-3, num_steps=20)
    assert times is None and snaps is None
    for a, b in zip(fin, sim_runs["reghcstriple"][1][0]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="divisible"):
        simulate(ti, g, s0, dt=2e-3, num_steps=20, snapshot_every=3)


def test_released_drug_fraction_monotone_and_matches_jax(bump, sim_runs):
    jg, g, js0, s0 = bump
    (j_fin, _, j_snaps), (fin, _, snaps) = sim_runs["reghcstriple"]
    f1 = released_drug_fraction(LOCAL_OPS, g, State(*(a[0] for a in snaps)), s0)
    f2 = released_drug_fraction(LOCAL_OPS, g, fin, s0)
    assert np.isfinite(float(f1)) and float(f2) >= float(f1) - 1e-12
    # absolute 1e-14: the fraction is 1 − a mass ratio near 1 (~7e-9 here),
    # so it keeps only the ratio's absolute rounding, ~1e-16
    j_f2 = j_released(J_OPS, jg, j_fin, js0)
    assert abs(float(f2) - float(j_f2)) <= 1e-14
    assert rel(dissolved_drug_fraction(LOCAL_OPS, g, fin), j_dissolved(J_OPS, jg, j_fin)) <= 1e-12


# ---------------------------------------------------------------------------
# simulate_adaptive (tests/test_adaptive.py)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def expsin8():
    """ExpSin MMS at N=8, RegHCs, krylov_unroll=8, in both packages."""
    model = j_default_consts
    jg = j_make_uniform_grid(8, 8)
    jcase = JExpSin(jg, model=JModel02(model))
    jf = JForcingReg(mms_case=jcase, model=JModel02(model), regularization_factor=50.0)
    ji = JIntegratorReg(JFieldReg(grid=jg, model=JModel02(model), forcing=jf, regularization_factor=50.0),
                        regularization_factor=50.0, track_residuals=False, krylov_unroll=8)
    g = make_uniform_grid(8, 8, device=CPU)
    case = MMSCaseExpSin(g, model=Model02(default_model_consts))
    f = MMSForcingRegHCsTriple(mms_case=case, model=Model02(default_model_consts),
                               regularization_factor=50.0)
    ti = PCTrapezoidalRegHCsTriple(
        FieldRegHCsTriple(grid=g, model=Model02(default_model_consts), forcing=f,
                          regularization_factor=50.0),
        regularization_factor=50.0, track_residuals=False, krylov_unroll=8)
    return (jg, jcase, ji, j_state_from_mms(mms_case=jcase, t=0.0, grid=jg),
            g, case, ti, state_from_mms_when(mms_case=case, t=0.0, grid=g))


def test_simulate_adaptive_matches_jax(expsin8):
    jg, _jcase, ji, js0, g, case, ti, s0 = expsin8
    Tf = 0.02
    j_s, j_info = j_simulate_adaptive(ji, jg, js0, t0=0.0, Tf=Tf, dt0=1e-3, tol=1e-7, max_steps=5000)
    s, info = simulate_adaptive(ti, g, s0, t0=0.0, Tf=Tf, dt0=1e-3, tol=1e-7, max_steps=5000)
    assert (info["steps"], info["rejected"]) == (j_info["steps"], j_info["rejected"])
    assert info["rejected"] > 0  # the controller was exercised both ways
    assert abs(info["t"] - j_info["t"]) <= 1e-15 and info["t"] == pytest.approx(Tf, abs=1e-12)
    # the next step follows from est, a norm of the difference of two
    # near-equal states: its last bits carry that cancellation's rounding
    assert abs(info["dt"] - j_info["dt"]) <= 1e-8 * j_info["dt"]
    assert_states_close(s, j_s, 1e-12)
    # the fixed-step run at the controller's mean step tracks the exact
    # solution no better than 10x the adaptive run (tests/test_adaptive.py)
    exact = state_from_mms_when(mms_case=case, t=Tf, grid=g)
    s_fix, _, _ = simulate(ti, g, s0, dt=Tf / info["steps"], num_steps=info["steps"])

    def err(x):
        return max(float(torch.sqrt(inner_H(LOCAL_OPS, g, a - b, a - b))) for a, b in zip(x, exact))

    assert err(s) <= 10 * max(err(s_fix), 1e-12)


def test_simulate_adaptive_tolerance_and_growth(expsin8):
    *_, g, _case, ti, s0 = expsin8
    _, loose = simulate_adaptive(ti, g, s0, Tf=0.02, dt0=5e-4, tol=1e-4)
    _, tight = simulate_adaptive(ti, g, s0, Tf=0.02, dt0=5e-4, tol=1e-7)  # 1e-8: 129 steps
    assert tight["steps"] > loose["steps"]
    _, grown = simulate_adaptive(ti, g, s0, Tf=0.02, dt0=1e-5, tol=1e-5, max_steps=10_000)
    assert grown["steps"] < 0.02 / 1e-5 / 5 and grown["dt"] > 1e-5
    _, none = simulate_adaptive(ti, g, s0, t0=0.02, Tf=0.02, dt0=1e-3)
    assert none["steps"] == none["rejected"] == 0


# ---------------------------------------------------------------------------
# 3-D: simulate and run_checkpointed (tests/test_three_d_model.py:383-480)
# ---------------------------------------------------------------------------
def _bump3(jg):
    b = (np.sin(np.pi * np.asarray(jg.xx)) * np.sin(np.pi * np.asarray(jg.yy))
         * np.sin(np.pi * np.asarray(jg.zz))) * np.asarray(jg.interior_mask)
    return both_states([0.2 * b, 0.1 * b, 0.0 * b, 0.05 * b, b])


def test_simulate_in_3d_matches_jax():
    model = j_default_consts
    jg, g = j_make_uniform_grid3(6, 6, 6), make_uniform_grid3(6, 6, 6, device=CPU)
    js0, s0 = _bump3(jg)
    j_fin, j_times, j_snaps = j_simulate(j_make_integrator3(jg, JModel02(model)), jg, js0, dt=1e-3,
                                         num_steps=4, snapshot_every=2, ops=J_OPS3)
    fin, times, snaps = simulate(make_integrator3(g, Model02(default_model_consts)), g, s0,
                                 dt=1e-3, num_steps=4, snapshot_every=2)
    assert snaps.T.shape == (2,) + tuple(jg.full_shape)
    assert_states_close(fin, j_fin, 1e-13)
    assert_states_close(snaps, j_snaps, 1e-13)
    frac = released_drug_fraction(LOCAL_OPS3, g, fin, s0)
    assert 0.0 <= float(frac) < 1.0
    assert abs(float(frac) - float(j_released(J_OPS3, jg, j_fin, js0))) <= 1e-14  # as in 2-D


def test_run_checkpointed_in_3d_equals_simulate_and_resumes(tmp_path):
    """A 3-D checkpointed run equals the straight simulate() bit for bit
    (the latter is held to JAX above), and so does its resume."""
    jg, g = j_make_uniform_grid3(5, 5, 5), make_uniform_grid3(5, 5, 5, device=CPU)
    _js0, s0 = _bump3(jg)
    ti = make_integrator3(g, Model02(default_model_consts))
    step_fn = lambda s, t, d: ti.step_fn(g, LOCAL_OPS3, s, t, d)[0]  # noqa: E731
    d = str(tmp_path / "ck3")
    s_ck, t_fin = run_checkpointed(step_fn, s0, t0=0.0, dt=1e-3, num_steps=4, directory=d, every=2)
    s_straight, _, _ = simulate(ti, g, s0, dt=1e-3, num_steps=4)
    assert abs(t_fin - 4e-3) < 1e-15
    for a, b in zip(s_ck, s_straight):
        assert torch.equal(a, b)
    s_res, _ = run_checkpointed(step_fn, s0, t0=0.0, dt=1e-3, num_steps=4, directory=d, every=2)
    for a, b in zip(s_res, s_ck):
        assert torch.equal(a, b)


def test_3d_integrators_refuse_what_is_not_ported():
    """The 3-D integrators take ``differentiable=True`` and
    ``linear_solver="direct"``, and refuse them together (or the adjoint
    with mixed solves), as the JAX 3-D integrators fail there."""
    g = make_uniform_grid3(4, 4, 4, device=CPU)
    for kw in (dict(differentiable=True), dict(linear_solver="direct")):
        make_integrator3(g, Model02(default_model_consts), **kw)
    for kw in (dict(differentiable=True, linear_solver="direct"),
               dict(differentiable=True, precision="mixed")):
        with pytest.raises(AttributeError, match="transpose"):
            make_integrator3(g, Model02(default_model_consts), **kw)


# ---------------------------------------------------------------------------
# checkpoints (tests/test_checkpoint_and_legacy.py), and .npz interop
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fe_pol6():
    """Forward Euler on the pol MMS case at N=6 (port)."""
    g = make_uniform_grid(6, 6, device=CPU)
    model = Model02(default_model_consts)
    mms = MMSCasePol(g, model=model)
    forcing = MMSForcingRegHCsTriple(mms_case=mms, model=model, regularization_factor=50.0)
    field = FieldRegHCsTriple(grid=g, model=model, forcing=forcing, regularization_factor=50.0)
    return ForwardEulerIntegrator(field), state_from_mms_when(mms_case=mms, t=0.0, grid=g)


def test_save_load_roundtrip(fe_pol6, tmp_path):
    _integ, s0 = fe_pol6
    path = save_state(str(tmp_path / "ck"), s0, t=0.25, step=7, extra={"note": "x"})
    state, t, step, meta = load_state(path, device=CPU)
    assert (t, step, meta["extra"]["note"]) == (0.25, 7, "x")
    for a, b in zip(state, s0):
        assert torch.equal(a, b)
    assert latest_checkpoint(str(tmp_path / "none")) is None


def test_run_checkpointed_resume_matches_straight_run(fe_pol6, tmp_path):
    integ, s0 = fe_pol6
    dt = 1e-3

    def step_fn(s, t, dtv):
        return integ.step(s, t0=t, dt=dtv)

    s_ref = s0
    for k in range(10):
        s_ref = step_fn(s_ref, k * dt, dt)
    d = str(tmp_path / "ckpts")
    run_checkpointed(step_fn, s0, t0=0.0, dt=dt, num_steps=6, directory=d, every=3)
    assert latest_checkpoint(d).endswith("ckpt_00000006.npz")
    s_fin, t_fin = run_checkpointed(step_fn, s0, t0=0.0, dt=dt, num_steps=10, directory=d, every=3)
    assert t_fin == pytest.approx(10 * dt)
    assert_states_close(s_fin, s_ref, 1e-14)


def test_checkpoints_interoperate_with_the_jax_package(tmp_path):
    """A JAX checkpoint loads into the port and a port checkpoint into the
    JAX package, arrays bit for bit, metadata as written."""
    rng = np.random.default_rng(SEED)
    arrays = [rng.standard_normal((7, 9)) for _ in range(5)]
    js, ts = both_states(arrays)
    jpath = jckpt.save_state(str(tmp_path / "from_jax"), js, t=0.5, step=3, extra={"by": "jax"})
    state, t, step, meta = load_state(jpath, device=CPU)
    assert (t, step, meta["extra"]) == (0.5, 3, {"by": "jax"})
    for a, b in zip(state, arrays):
        np.testing.assert_array_equal(a.numpy(), b)
    tpath = save_state(str(tmp_path / "from_port"), ts, t=0.75, step=4)
    jstate, jt, jstep, _ = jckpt.load_state(tpath)
    assert (jt, jstep) == (0.75, 4)
    for a, b in zip(jstate, arrays):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert jckpt.latest_checkpoint(str(tmp_path)) in (jpath, tpath)


# ---------------------------------------------------------------------------
# the legacy study runner
# ---------------------------------------------------------------------------
def _legacy_params(model):
    """tests/test_checkpoint_and_legacy.py's study, its ladders halved (N
    2, 4, 8; the temporal ladder at N = 4), three levels each so that rates
    exist, and a budget of 4 iterations a solve, which every solve there
    meets (the errors are those of budgets 8 and 16, bit for bit)."""
    return dict(
        Tf=0.005, model=model, N_base_spatial=2, num_spatial_refinements=3,
        dt_fixed_spatial=1e-3, N_fixed_temporal=4, dt_base_temporal=2e-3,
        num_temporal_refinements=3, forcing_terms_params=dict(regularization_factor=50.0),
        field_params=dict(regularization_factor=50.0),
        integrator_params=dict(regularization_factor=50.0, track_residuals=False, krylov_unroll=4),
    )


@pytest.fixture(scope="module")
def legacy_jax():
    """The JAX package's run_convergence_studies at _legacy_params."""
    return j_run_convergence_studies(
        [(JFieldReg, JPol, JForcingReg, JIntegratorReg, "pol_reg")],
        _legacy_params(JModel02(j_default_consts)),
    )["pol_reg"]


def test_legacy_run_convergence_studies_matches_jax(legacy_jax):
    """Every error within 1e-10 of the JAX package's, the rates within 1e-6
    (NaN where JAX's is NaN: the temporal ladder sits at its spatial floor)
    and the same statuses."""
    rep = run_convergence_studies(
        [(FieldRegHCsTriple, MMSCasePol, MMSForcingRegHCsTriple, PCTrapezoidalRegHCsTriple,
          "pol_reg")],
        _legacy_params(Model02(default_model_consts)), device=CPU,
    )["pol_reg"]
    for kind in ("spatial", "temporal"):
        assert len(rep[kind]["errors"]) == len(legacy_jax[kind]["errors"]) == 3
        for a, b in zip(rep[kind]["errors"], legacy_jax[kind]["errors"]):
            assert rel(a, b) <= 1e-10
        np.testing.assert_allclose(rep[kind]["rates"], legacy_jax[kind]["rates"], rtol=1e-6)
        assert len(rep[kind]["rates"]) == 1
        assert rep[kind]["statuses"] == legacy_jax[kind]["statuses"]
    assert rep["spatial"]["errors"][0] > rep["spatial"]["errors"][-1]


# ---------------------------------------------------------------------------
# Stencil5.transpose and the direct solver (tests/test_direct_solve.py)
# ---------------------------------------------------------------------------
def _random_planes(rng, shape, diag_shift=4.0):
    return [rng.random(shape) + diag_shift] + [rng.random(shape) * 0.5 for _ in range(4)]


def test_stencil5_transpose_matches_jax_and_is_the_transpose():
    rng = np.random.default_rng(SEED + 1)
    planes = [rng.standard_normal((13, 17)) for _ in range(5)]
    st = stencil5_from_numpy(planes, device=CPU)
    st_t = st.transpose(LOCAL_OPS)
    j_t = j_linsolve.Stencil5(*(jnp.asarray(p) for p in planes)).transpose(J_OPS)
    for a, b in zip(st_t, j_t):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    u, v = (torch.as_tensor(rng.standard_normal((13, 17))) for _ in range(2))
    # <A u, v> = <u, Aᵀ v>
    lhs, rhs = torch.sum(st.apply(LOCAL_OPS, u) * v), torch.sum(u * st_t.apply(LOCAL_OPS, v))
    assert abs(float(lhs - rhs)) <= 1e-13 * abs(float(lhs))


def _dense_from_masked_stencil(st, mask):
    """Dense matrix of u ↦ mask·(st·(mask·u)) with identity rows on the dead
    nodes (the direct solver's convention)."""
    n = mask.numel()
    cols = []
    for idx in range(n):
        e = torch.zeros(n, dtype=torch.float64)
        e[idx] = 1.0
        cols.append((mask * st.apply(LOCAL_OPS, e.reshape(mask.shape) * mask)).reshape(-1).numpy())
    dense = np.stack(cols, axis=1)
    dense[np.diag_indices(n)] += 1.0 - mask.reshape(-1).numpy()
    return dense


def _bcr_case(N, M):
    rng = np.random.RandomState(97531)
    planes = _random_planes(rng, (N + 1, M + 1))
    mask = make_uniform_grid(N, M, device=CPU).interior_mask
    b = torch.as_tensor(rng.rand(N + 1, M + 1)) * mask
    return planes, stencil5_from_numpy(planes, device=CPU), b, mask


@pytest.mark.parametrize("nm", [(6, 5), (9, 9), (16, 11)])
def test_bcr_matches_dense(nm):
    """stencil5_solve_direct == dense torch.linalg.solve (1e-12), residual at
    rounding level, at block counts that need the 2^k − 1 padding."""
    N, M = nm
    _planes, st, b, mask = _bcr_case(N, M)
    x = stencil5_solve_direct(st, b, mask)
    x_dense = torch.linalg.solve(torch.as_tensor(_dense_from_masked_stencil(st, mask)), b.reshape(-1))
    assert rel_max(x, x_dense.reshape(N + 1, M + 1)) <= 1e-12
    r = (mask * (b - st.apply(LOCAL_OPS, x))).numpy()
    assert np.linalg.norm(r) <= 1e-11 * float(torch.linalg.norm(b))


def test_bcr_matches_jax():
    """The port's BCR against the JAX package's (1e-13: the same batched
    inverses and products, summed in LAPACK's order on both sides)."""
    planes, st, b, mask = _bcr_case(16, 11)
    jx = jax.jit(j_solve_direct)(j_linsolve.Stencil5(*(jnp.asarray(p) for p in planes)),
                                 jnp.asarray(b.numpy()), jnp.asarray(mask.numpy()))
    assert rel_max(stencil5_solve_direct(st, b, mask), jx) <= 1e-13


def test_bcr_with_dead_interior_rows():
    g = make_uniform_grid(10, 7, device=CPU)
    rng = np.random.RandomState(97532)
    mask = g.interior_mask.clone()
    mask[-4:, :] = 0.0
    mask[:, -3:] = 0.0
    st = Stencil5(*(p * mask for p in stencil5_from_numpy(_random_planes(rng, (11, 8)), device=CPU)))
    b = torch.as_tensor(rng.rand(11, 8)) * mask
    x = stencil5_solve_direct(st, b, mask)
    x_dense = torch.linalg.solve(torch.as_tensor(_dense_from_masked_stencil(st, mask)), b.reshape(-1))
    assert rel_max(x, x_dense.reshape(11, 8)) <= 1e-12
    assert torch.all(x[mask == 0] == 0.0)


def test_bcr_single_block_float32_and_block_count():
    rng = np.random.RandomState(97533)
    m = 5
    B = torch.as_tensor(rng.rand(1, m, m) + 4.0 * np.eye(m))
    A, C = torch.zeros(1, m, m, dtype=torch.float64), torch.zeros(1, m, m, dtype=torch.float64)
    b = torch.as_tensor(rng.rand(1, m))
    x = block_tridiag_solve_bcr(A, B, C, b)
    assert rel_max(x[0], np.linalg.solve(B[0].numpy(), b[0].numpy())) <= 1e-13
    with pytest.raises(ValueError, match="2\\^k - 1"):
        block_tridiag_solve_bcr(*(torch.zeros(2, m, m),) * 3, torch.zeros(2, m))
    # float32 (the mixed inner solve): about float32's epsilon
    g = make_uniform_grid(9, 9, device=CPU)
    st = stencil5_from_numpy(_random_planes(rng, (10, 10)), dtype=torch.float32, device=CPU)
    mask = g.interior_mask.float()
    b32 = torch.as_tensor(rng.rand(10, 10), dtype=torch.float32) * mask
    x32 = stencil5_solve_direct(st, b32, mask)
    x64 = stencil5_solve_direct(Stencil5(*(p.double() for p in st)), b32.double(), mask.double())
    assert x32.dtype == torch.float32 and rel_max(x32.double(), x64) <= 1e-6


@pytest.fixture(scope="module")
def pol16_krylov():
    """The pol N=16 study level (Tf = 0.01, dt = 5e-4) with krylov_unroll=8
    in the port, and its JAX twin's error."""
    e_k = _make_trial(MMSCasePol, 16, 50.0, device=CPU, mc=study_consts("pol"), krylov_unroll=8
                      ).run_for_errors(Tf=0.01, dt=5e-4).overall_combined_error
    return e_k


def test_direct_newton_matches_krylov_and_jax(pol16_krylov):
    """linear_solver='direct' reproduces the Krylov study error (both drive
    the same Newton iteration) and JAX's direct error (1e-10)."""
    e_k = pol16_krylov
    trial = _make_trial(MMSCasePol, 16, 50.0, device=CPU, mc=study_consts("pol"),
                        linear_solver="direct")
    assert trial.integrator.linear_solver == "direct"
    summary = trial.run_for_errors(Tf=0.01, dt=5e-4)
    assert summary.series.krylov_converged.all()
    assert np.all(summary.series.krylov_iters == 3)  # one "iteration" a direct solve
    e_d = summary.overall_combined_error
    assert rel(e_d, e_k) < 1e-8
    j_e = j_make_trial(JPol, 16, 50.0, mc=j_study_consts("pol"), linear_solver="direct").run_for_errors(
        Tf=0.01, dt=5e-4).overall_combined_error
    assert rel(e_d, j_e) <= 1e-10


def test_direct_inside_mixed_refinement(pol16_krylov):
    """precision='mixed' + linear_solver='direct': float32 BCR inner solves
    under f64 refinement reach the f64 study error."""
    e_k = pol16_krylov
    trial = _make_trial(MMSCasePol, 16, 50.0, device=CPU, mc=study_consts("pol"), precision="mixed",
                        linear_solver="direct")
    assert isinstance(trial.integrator.solver, DirectMixedBackend)
    e_md = trial.run_for_errors(Tf=0.01, dt=5e-4).overall_combined_error
    assert rel(e_md, e_k) < 1e-8


def test_linear_solver_is_checked():
    g = make_uniform_grid(4, 4, device=CPU)
    with pytest.raises(ValueError, match="linear_solver"):
        make_integrator(g, Model02(default_model_consts), linear_solver="superlu")


# ---------------------------------------------------------------------------
# the IFT adjoint of one plane solve
# ---------------------------------------------------------------------------
def test_plane_solve_vjp_matches_jax_custom_linear_solve():
    """Each plane's gradient and the rhs's, on random non-symmetric planes
    at a ragged 13×17 shape, against JAX's VJP of custom_linear_solve with
    the same BiCGStab (1e-12 relative to each gradient's max-norm): a plane
    gradient off by one shift, or blind to the boundary rows, fails here."""
    rng = np.random.default_rng(SEED + 2)
    shape = (13, 17)
    mask = np.zeros(shape)
    mask[1:-1, 1:-1] = 1.0
    # as every Newton-plane assembly has them: no coupling into a masked node
    tm = torch.as_tensor(mask)
    into_alive = [(tm * LOCAL_OPS.shift_xm(tm)).numpy(), (tm * LOCAL_OPS.shift_xp(tm)).numpy(),
                  (tm * LOCAL_OPS.shift_ym(tm)).numpy(), (tm * LOCAL_OPS.shift_yp(tm)).numpy()]
    planes = [(4.0 + rng.random(shape)) * mask] + [rng.standard_normal(shape) * m for m in into_alive]
    b, gbar = rng.standard_normal(shape) * mask, rng.standard_normal(shape)
    inv = np.where(mask > 0, 1.0 / np.where(planes[0] == 0, 1.0, planes[0]), 0.0)

    def j_solve(mv, bb):
        return j_linsolve.bicgstab_unrolled(mv, bb, jnp.zeros_like(bb), dot=lambda u, v: jnp.sum(u * v),
                                            minv=lambda r: r * inv, tol=1e-13, iters=30)

    def j_fn(ps, bb):
        st = j_linsolve.Stencil5(*ps)
        x, _ = jax.lax.custom_linear_solve(lambda w: st.apply(J_OPS, w), bb, solve=j_solve,
                                           transpose_solve=j_solve, has_aux=True)
        return x * mask

    j_x, vjp = jax.vjp(j_fn, tuple(jnp.asarray(p) for p in planes), jnp.asarray(b))
    j_gp, j_gb = vjp(jnp.asarray(gbar))

    tp = [torch.tensor(p, requires_grad=True) for p in planes]
    tb = torch.tensor(b, requires_grad=True)
    tmask, tinv = torch.as_tensor(mask), torch.as_tensor(inv)

    def solver(st, bb):
        x, info = kernels.bicgstab_solve(st, bb, tinv, tmask, tol=1e-13, iters=30)
        return x, info

    x, info = adjoint.plane_solve(solver, Stencil5(*tp), tb, tmask)
    assert bool(info["converged"]) and not info["resnorm_sq"].requires_grad
    assert rel_max(x, j_x) <= 1e-12
    grads = torch.autograd.grad(x, [*tp, tb], grad_outputs=torch.as_tensor(gbar))
    for name, a, ref in zip([*Stencil5._fields, "b"], grads, [*j_gp, j_gb]):
        assert rel_max(a, ref) <= 1e-12, name


def test_cpu_plain_versions_stay_traceable():
    """On CPU tensors the wrappers run their plain versions, which autograd
    traces as before: the unrolled-backprop route."""
    rng = np.random.default_rng(SEED + 3)
    shape = (9, 8)
    mask = torch.zeros(shape, dtype=torch.float64)
    mask[1:-1, 1:-1] = 1.0
    planes = [(torch.as_tensor(4.0 + rng.random(shape)) * mask).requires_grad_()] + [
        (torch.as_tensor(rng.standard_normal(shape)) * mask).requires_grad_() for _ in range(4)]
    st = Stencil5(*planes)
    u = torch.as_tensor(rng.standard_normal(shape))
    (g_apply,) = torch.autograd.grad(kernels.stencil5_apply(st, u).sum(), [planes[0]])
    assert torch.equal(g_apply, u)
    x, _ = kernels.bicgstab_solve(st, u * mask, torch.where(mask > 0, 1.0 / planes[0].detach(), 0.0),
                                  mask, tol=1e-13, iters=30)
    assert all(g is not None for g in torch.autograd.grad(x.sum(), planes))


# ---------------------------------------------------------------------------
# gradients of whole simulations (tests/test_gradients.py)
# ---------------------------------------------------------------------------
N_GRAD = 12
DT = 2e-3
NUM_STEPS = 4
MC = default_model_consts._replace(Kd=1e-2)
J_MC = j_default_consts._replace(Kd=1e-2)
BASE = {"Dl_max": 8.01e-4, "Dd_max": 2.46e-6, "Kd": 1e-2, "K3": 1e-2, "regularization_factor": 50.0}
_H_REL = {"Dd_max": 1e-3}  # FD steps per key, as tests/test_gradients.py has them
SOLVER_CONFIGS = {
    "full_krylov": dict(krylov_unroll=8),
    "direct": dict(linear_solver="direct"),
    # each float32 pass takes one iteration here, so a budget of 2 gives
    # the bits of tests/test_gradients.py's 8 at a quarter of JAX's compile
    "mixed": dict(precision="mixed", krylov_unroll=2),
}


@pytest.fixture(scope="module")
def blob():
    jg = j_make_uniform_grid(N_GRAD, N_GRAD)
    g = make_uniform_grid(N_GRAD, N_GRAD, device=CPU)
    b = np.exp(-60.0 * ((np.asarray(jg.xx) - 0.5) ** 2 + (np.asarray(jg.yy) - 0.5) ** 2))
    b = b * np.asarray(jg.interior_mask)
    js0, s0 = both_states([0.5 * b, 0.1 * b, 0.2 * b, 0.05 * b, b])
    rng = np.random.default_rng(7)
    direction = [rng.standard_normal(b.shape) * np.asarray(jg.interior_mask) for _ in range(5)]
    return jg, g, js0, s0, direction


def energy(g, s):
    return sum(inner_H(LOCAL_OPS, g, u, u) for u in s)


def j_energy(jg, s):
    return sum(j_inner_H(J_OPS, jg, u, u) for u in s)


def _leaves(params):
    return {k: torch.tensor(v, dtype=torch.float64, requires_grad=True) for k, v in params.items()}


@pytest.fixture(scope="module")
def grads_base(blob):
    """The BASE-parameter and initial-state gradients of the energy after
    NUM_STEPS steps (krylov_unroll=8), by jax.grad and by the port."""
    jg, g, js0, s0, direction = blob
    jsim = j_build_simulator(jg, dt=DT, num_steps=NUM_STEPS, base_consts=J_MC, krylov_unroll=8)
    j_gp, j_gs = jax.grad(lambda p, s: j_energy(jg, jsim(p, s)), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in BASE.items()}, js0)
    sim = build_simulator(g, dt=DT, num_steps=NUM_STEPS, base_consts=MC, krylov_unroll=8)
    params = _leaves(BASE)
    s_leaf = State(*(u.clone().requires_grad_() for u in s0))
    loss = energy(g, sim(params, s_leaf))
    gs = torch.autograd.grad(loss, [*params.values(), *s_leaf])
    port_p = dict(zip(params, gs[:len(params)]))
    return j_gp, j_gs, port_p, State(*gs[len(params):]), sim


def test_differentiable_forward_is_identical(blob):
    """differentiable=True changes no forward bit (the Function returns the
    solver's own output), for each solver config."""
    _jg, g, _js0, s0, _dir = blob
    for kw in SOLVER_CONFIGS.values():
        ref = make_integrator(g, Model02(MC), **kw)
        diff = make_integrator(g, Model02(MC), differentiable=True, **kw)
        s_ref, d_ref = ref.step_fn(g, LOCAL_OPS, s0, 0.0, DT)
        s_diff, d_diff = diff.step_fn(g, LOCAL_OPS, s0, 0.0, DT)
        for a, b in zip(s_ref, s_diff):
            assert torch.equal(a, b)
        assert int(d_ref.krylov_iters) == int(d_diff.krylov_iters)
        assert bool(d_diff.krylov_converged)


@pytest.mark.parametrize("key", sorted(BASE))
def test_parameter_gradient_matches_jax_and_fd(blob, grads_base, key):
    jg, g, _js0, s0, _dir = blob
    j_gp, _j_gs, port_p, _gs, sim = grads_base
    assert rel(port_p[key], j_gp[key]) <= 1e-9
    val = BASE[key]
    h = abs(val) * _H_REL.get(key, 1e-5)
    with torch.no_grad():
        fd = (float(energy(g, sim(dict(BASE, **{key: val + h}), s0)))
              - float(energy(g, sim(dict(BASE, **{key: val - h}), s0)))) / (2 * h)
    assert float(port_p[key]) == pytest.approx(fd, rel=1e-3)


def test_initial_state_gradient_matches_jax_and_fd(blob, grads_base):
    jg, g, _js0, s0, direction = blob
    _j_gp, j_gs, _port_p, gs, sim = grads_base
    assert_states_close(gs, j_gs, 1e-9)
    ad = sum(float(torch.sum(gu * torch.as_tensor(du))) for gu, du in zip(gs, direction))
    h = 1e-6
    with torch.no_grad():
        sp = State(*(u + h * torch.as_tensor(du) for u, du in zip(s0, direction)))
        sm = State(*(u - h * torch.as_tensor(du) for u, du in zip(s0, direction)))
        fd = (float(energy(g, sim(BASE, sp))) - float(energy(g, sim(BASE, sm)))) / (2 * h)
    assert ad == pytest.approx(fd, rel=1e-6)


def test_ift_adjoint_matches_unrolled_backprop(blob, grads_base):
    """Two derivative routes of the port: the IFT adjoint, and autograd
    through the unrolled BiCGStab iterations of the CPU plain versions."""
    _jg, g, _js0, s0, _dir = blob

    def grad_kd(differentiable, remat):
        sim = build_simulator(g, dt=DT, num_steps=2, base_consts=MC, differentiable=differentiable,
                              krylov_unroll=8, remat=remat)
        params = _leaves({"Kd": 1e-2})
        return float(torch.autograd.grad(energy(g, sim(params, s0)), [params["Kd"]])[0])

    g_ift = grad_kd(True, True)
    assert g_ift == pytest.approx(grad_kd(False, False), rel=1e-7)
    assert g_ift == pytest.approx(grad_kd(True, False), rel=1e-13)  # remat changes nothing


def test_differentiable_rejects_incompatible_modes(blob):
    _jg, g, _js0, _s0, _dir = blob
    with pytest.raises(ValueError, match="num_newton_iterations"):
        make_integrator(g, Model02(MC), differentiable=True, num_newton_iterations=40)
    with pytest.raises(ValueError, match="unknown parameter"):
        build_simulator(g, dt=DT, num_steps=1)({"eta": 1.0}, None)


@pytest.mark.parametrize("config", sorted(SOLVER_CONFIGS))
def test_parameter_gradient_across_solver_configs(blob, grads_base, config):
    """Kd gradient of each solver config against jax.grad (1e-9) and
    central differences (1e-5); full_krylov is the BASE run's."""
    jg, g, js0, s0, _dir = blob
    kw = SOLVER_CONFIGS[config]
    if config == "full_krylov":
        j_g, ad, sim = grads_base[0]["Kd"], float(grads_base[2]["Kd"]), grads_base[4]
    else:
        jsim = j_build_simulator(jg, dt=DT, num_steps=NUM_STEPS, base_consts=J_MC, **kw)
        j_g = jax.grad(lambda p: j_energy(jg, jsim(p, js0)))({"Kd": jnp.asarray(1e-2)})["Kd"]
        sim = build_simulator(g, dt=DT, num_steps=NUM_STEPS, base_consts=MC, **kw)
        params = _leaves({"Kd": 1e-2})
        ad = float(torch.autograd.grad(energy(g, sim(params, s0)), [params["Kd"]])[0])
    assert rel(ad, j_g) <= 1e-9
    h = 1e-2 * 1e-5
    with torch.no_grad():
        fd = (float(energy(g, sim({"Kd": 1e-2 + h}, s0)))
              - float(energy(g, sim({"Kd": 1e-2 - h}, s0)))) / (2 * h)
    assert ad == pytest.approx(fd, rel=1e-5)


def test_mixed_k3_gradient_moves_only_by_float32_underflow(blob):
    """The K3 gradient of the dissolved fraction (~1.5e-17) runs through T
    adjoints so small that the float32 inner solves of precision="mixed"
    reach float32's subnormal range, where XLA:CPU flushes to zero and the
    port keeps gradual underflow.  Scaling the observable by 2**32 (exact in
    every normal-range operation) lifts them out of it: there the JAX
    package's mixed K3 and the port's agree to 1e-13, and the port's
    unscaled K3 (subnormals kept) lies within 1e-10 of them, while JAX's
    unscaled K3 is more than 1e-9 off (measured 1.7e-8).  With
    torch.set_flush_denormal(True) the port comes within 5e-9 of JAX's
    unscaled value (measured 2.1e-9); the rest is the two implementations'
    float32 operation order deciding which values underflow."""
    jg, g, js0, s0, _dir = blob
    kw = SOLVER_CONFIGS["mixed"]
    jsim = j_build_simulator(jg, dt=DT, num_steps=NUM_STEPS, base_consts=J_MC, **kw)
    j_grad = jax.jit(jax.grad(lambda p, scale: scale * j_dissolved(J_OPS, jg, jsim(p, js0))))
    sim = build_simulator(g, dt=DT, num_steps=NUM_STEPS, base_consts=MC, **kw)

    def jax_k3(scale):
        return float(j_grad({"K3": jnp.asarray(1e-2)}, jnp.asarray(scale))["K3"]) / scale

    def port_k3(scale, flush=False):
        params = _leaves({"K3": 1e-2})
        torch.set_flush_denormal(flush)
        try:
            value = scale * dissolved_drug_fraction(LOCAL_OPS, g, sim(params, s0))
            return float(torch.autograd.grad(value, [params["K3"]])[0]) / scale
        finally:
            torch.set_flush_denormal(False)

    lifted, flushed = jax_k3(2.0**32), jax_k3(1.0)
    readings = {
        "port lifted vs JAX lifted": rel(port_k3(2.0**32), lifted),
        "port unscaled vs JAX lifted": rel(port_k3(1.0), lifted),
        "JAX unscaled vs JAX lifted": rel(flushed, lifted),
        "port flushed vs JAX unscaled": rel(port_k3(1.0, flush=True), flushed),
    }
    print(readings)
    assert readings["port lifted vs JAX lifted"] <= 1e-13
    assert readings["port unscaled vs JAX lifted"] <= 1e-10
    assert readings["JAX unscaled vs JAX lifted"] > 1e-9
    assert readings["port flushed vs JAX unscaled"] <= 5e-9


def test_released_fraction_is_kd_blind(blob, grads_base):
    _jg, g, _js0, s0, _dir = blob
    sim = grads_base[4]
    with torch.no_grad():
        s_lo, s_hi = sim({"Kd": 1e-2}, s0), sim({"Kd": 2e-2}, s0)
    rel_lo, rel_hi = (float(released_drug_fraction(LOCAL_OPS, g, s, s0)) for s in (s_lo, s_hi))
    dis_lo, dis_hi = (float(dissolved_drug_fraction(LOCAL_OPS, g, s)) for s in (s_lo, s_hi))
    assert abs(rel_hi - rel_lo) < 1e-8
    assert abs(dis_hi - dis_lo) / abs(dis_lo) > 1e-2


def test_fit_parameters_recovers_kd_as_jax_does(blob, grads_base):
    """Kd 2e-2 → 1e-2 by Adam in log space on the dissolved fraction, 25
    iterations: the loss falls by 1e-2, Kd lands within 5 %, and the first
    10 losses match the JAX package's (optax.adam) to 1e-6 relative; the
    later ones are not compared, Adam's normalization amplifying the last
    bits once the loss nears 0."""
    jg, g, js0, s0, _dir = blob
    sim = grads_base[4]
    jsim = j_build_simulator(jg, dt=DT, num_steps=NUM_STEPS, base_consts=J_MC, krylov_unroll=8)

    def obs(s):
        return dissolved_drug_fraction(LOCAL_OPS, g, s)

    def j_obs(s):
        return j_dissolved(J_OPS, jg, s)

    with torch.no_grad():
        target = obs(sim({"Kd": 1e-2}, s0))
    fitted, history = fit_parameters(sim, obs, target, {"Kd": 2e-2}, s0, num_iterations=25,
                                     learning_rate=0.2)
    j_target = j_obs(jsim({"Kd": jnp.asarray(1e-2)}, js0))
    assert rel(target, j_target) <= 1e-12
    _j_fitted, j_history = j_fit_parameters(jsim, j_obs, j_target, {"Kd": 2e-2}, js0,
                                            num_iterations=10, learning_rate=0.2)
    for a, b in zip(history[:10], j_history):
        assert rel(a, b) <= 1e-6
    assert history[-1] < history[0] * 1e-2
    assert fitted["Kd"] == pytest.approx(1e-2, rel=0.05)


# ---------------------------------------------------------------------------
# the solver options: probed planes, matrix-free, the while form
# ---------------------------------------------------------------------------
OPTIONS = {
    "probe": dict(stencil_source="probe"),
    "matrix_free": dict(assemble_stencil=False),
    "matrix_free_while": dict(assemble_stencil=False, krylov_unroll=None),
    "while_form": dict(krylov_unroll=None, krylov_maxiter=60),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_solver_option_step_matches_jax(blob, option):
    """One step of the release blob at N=12 with each option, against the
    JAX package's step (1e-12); ``differentiable=True`` changes no forward
    bit."""
    jg, g, js0, s0, _dir = blob
    kw = dict(OPTIONS[option])
    kw.setdefault("krylov_unroll", 8)
    j_state, j_diag = jax.jit(j_make_integrator(jg, JModel02(J_MC), **kw).step_fn,
                              static_argnums=1)(jg, J_OPS, js0, 0.0, DT)
    port = make_integrator(g, Model02(MC), **kw)
    t_state, t_diag = port.step_fn(g, LOCAL_OPS, s0, 0.0, DT)
    assert_states_close(t_state, j_state, 1e-12)
    assert abs(int(t_diag.krylov_iters) - int(j_diag.krylov_iters)) <= 1
    assert bool(t_diag.krylov_converged) and bool(j_diag.krylov_converged)
    d_state, _ = make_integrator(g, Model02(MC), differentiable=True, **kw).step_fn(
        g, LOCAL_OPS, s0, 0.0, DT)
    for a, b in zip(d_state, t_state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw,match", [
    (dict(stencil_source="nope"), "stencil_source"),
    (dict(precision="mixed", assemble_stencil=False), "assemble_stencil"),
    (dict(linear_solver="direct", assemble_stencil=False), "assemble_stencil"),
    (dict(krylov_unroll="many"), "krylov_unroll"),
])
def test_solver_options_are_checked_as_jax_checks_them(kw, match):
    jg = j_make_uniform_grid(4, 4)
    with pytest.raises(ValueError, match=match):
        j_make_integrator(jg, JModel02(J_MC), **kw)
    g = make_uniform_grid(4, 4, device=CPU)
    with pytest.raises(ValueError, match=match):
        make_integrator(g, Model02(MC), **kw)


def test_grad_works_with_while_loop_solver(blob):
    """tests/test_gradients.py:152's twin: ``krylov_unroll=None`` (the
    kernels' budget is ``krylov_maxiter``) is reverse-differentiable through
    the IFT adjoint; its gradient is the JAX package's while-loop one."""
    jg, g, js0, s0, _dir = blob
    jsim = j_build_simulator(jg, dt=DT, num_steps=1, base_consts=J_MC, krylov_unroll=None)
    ref = float(jax.grad(lambda p: j_energy(jg, jsim(p, js0)))(
        {"Dl_max": jnp.asarray(8.01e-4)})["Dl_max"])
    sim = build_simulator(g, dt=DT, num_steps=1, base_consts=MC, krylov_unroll=None)
    params = _leaves({"Dl_max": 8.01e-4})
    (got,) = torch.autograd.grad(energy(g, sim(params, s0)), [params["Dl_max"]])
    assert np.isfinite(float(got)) and float(got) != 0.0
    assert rel(got, ref) <= 1e-8


# ---------------------------------------------------------------------------
# the eta-gradient study (studies/eta_gradient_study.py)
# ---------------------------------------------------------------------------
def test_eta_gradient_study_matches_jax(monkeypatch):
    """``eta_gradient_study.run`` at N=8 on two eta against the JAX study's
    ``make_loss`` at N=8 (its module's ``N`` global, read at call time):
    Obs and dObs/deta ≤1e-10 relative to ``jax.value_and_grad``; the port's
    adjoint against its central differences ≤1e-4, as the study gates."""
    import studies.eta_gradient_study as j_study
    from na_dd_tpu_torch.studies.eta_gradient_study import run

    etas = [float(x) for x in np.logspace(1, 3, 7)][2::4]  # 46.4 and 1000, the FD points
    monkeypatch.setattr(j_study, "N", 8)
    j_val_grad = jax.jit(jax.value_and_grad(j_study.make_loss()))
    res = run(etas, N=8, device=CPU, fd_etas=etas, verbose=False)
    assert [row["eta"] for row in res["rows"]] == etas
    for row in res["rows"]:
        obs, grad = j_val_grad(jnp.asarray(row["eta"]))
        assert rel(row["obs"], obs) <= 1e-10
        assert rel(row["dobs_deta"], grad) <= 1e-10
    assert [c["eta"] for c in res["fd_checks"]] == etas
    assert all(c["rel_dev"] <= 1e-4 for c in res["fd_checks"])
