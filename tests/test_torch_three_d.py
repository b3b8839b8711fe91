"""The port's 3-D RegHCs study path (na_dd_tpu_torch.three_d) against the JAX
package (na_dd_tpu.three_d) on CPU float64, fed the same numpy inputs:

* Grid3 metrics (exact), the six shifts and the reductions, the mimetic
  operators, the inner products and ``avg_int3`` on a uniform and a
  non-uniform grid, ``Stencil7.apply`` and the plane builders: ≤1e-14
  relative to the reference's max-norm;
* the MMSCaseExpSin3 pack, the five forcing terms, the five fields on a
  random state and the three self-Jacobian planes at N=6: ≤1e-12 (the JAX
  package evaluates the closures in separated Σ f(t)·g(x,y,z) form on the
  CPU, the port in full form);
* one ``step_fn`` at N=6 against the JAX integrator with
  ``stencil_backend="pallas"`` (its K5/K6 Pallas kernels in interpret mode):
  ≤1e-12 per field, the same Krylov iteration total; and one step at N=4
  with ``coupling_source="analytic"`` (the per-solve route through K5: the
  fused kernel is 2-D only in both packages), the same tolerances;
* ``run_trial3`` at N=4 and N=8 (the three_d_study protocol: Tf=0.02, two
  Newton sweeps, dt = 1e-2/2^k): ≤1e-10 relative to the JAX trial and to the
  CPU-x64 values of the JAX package;
* the 3-D study CLI ``na_dd_tpu_torch.studies.three_d_study`` on the CPU
  at two levels: the RegHCs ladder against the JAX trials above; the Cs
  and HCs ladders, the temporal ladder with its self-reference errors, the
  batched ladder and the eta sweep against the JAX package's CPU-x64 record
  of the same calls (``studies/drivers_cpu_x64.py``; one compile a level
  would cost ~10 s here); each ≤1e-10 relative; the JSON's keys against the
  JAX script's; a level off its record fails the CLI;
* the solver options: 7-colour probed planes against the JAX package's
  probes and the closed-form planes (≤1e-12); ``Stencil7.transpose``
  against ``jax.linear_transpose`` of ``Stencil7.apply`` (≤1e-14); the
  x-plane BCR direct solve against the JAX one (≤1e-10); the Crank–Nicolson
  heat step and ``heat_mms_error`` at N=4..8 (≤1e-12); the probed,
  matrix-free and direct steps against the JAX steps (≤1e-12); value and
  gradients of ``differentiable=True`` runs against ``jax.grad`` (≤1e-8);
  and the modes the JAX 3-D integrators cannot run refused alike."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from na_dd_tpu.core.state import State as JState
from na_dd_tpu.models import Model02 as JModel02
from na_dd_tpu.models import default_model_consts as J_DEFAULT_CONSTS
from na_dd_tpu.three_d import diffusion as j_diff
from na_dd_tpu.three_d import grid as j_grid
from na_dd_tpu.three_d import inner_products as j_ip
from na_dd_tpu.three_d import stencils as j_st
from na_dd_tpu.three_d.harness import make_setup3 as j_make_setup3
from na_dd_tpu.three_d.harness import run_trial3 as j_run_trial3
from na_dd_tpu.three_d.mms import MMSCaseExpSin3 as JCase
from na_dd_tpu.three_d.quadrature import avg_int3 as j_avg_int3
from na_dd_tpu.three_d.shifts import LOCAL_OPS3 as J_OPS
from na_dd_tpu_torch.convert import (
    consts_from_dict,
    grid3_from_nodes,
    state_from_numpy,
    stencil7_from_numpy,
    tensor_from_numpy,
)
from na_dd_tpu_torch.models.coefficients import Model02 as TModel02
from na_dd_tpu_torch.three_d import diffusion as t_diff
from na_dd_tpu_torch.three_d import grid as t_grid
from na_dd_tpu_torch.three_d import inner_products as t_ip
from na_dd_tpu_torch.three_d import stencils as t_st
from na_dd_tpu_torch.three_d.harness import make_setup3 as t_make_setup3
from na_dd_tpu_torch.three_d.harness import run_trial3 as t_run_trial3
from na_dd_tpu_torch.three_d.mms import MMSCaseExpSin3 as TCase
from na_dd_tpu_torch.three_d.quadrature import avg_int3 as t_avg_int3
from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3 as T_OPS

RTOL = 1e-14
RTOL_PHYSICS = 1e-12
ETA = 50.0
T_EVAL = 0.007
FIELDS = ("cp", "T", "cl", "cd", "cs")
# the three_d_study constants and the CPU-x64 errors of the JAX package's
# build_runner3 (MMSCaseExpSin3, RegHCs, eta=50, Tf=0.02, two Newton sweeps)
STUDY_CONSTS = dict(K1=1e-3, K2=1e-3, K3=1e-3, K4=1e-3, Dl_max=1e-5, Kd=1e-2, Sd=1.0, Dd_max=1e-6)
CPU_X64 = {4: 0.0005209171734887429, 8: 0.000133542682516219}


def assert_close(port, ref, rtol=RTOL):
    port = np.asarray(port.detach().cpu() if isinstance(port, torch.Tensor) else port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    assert float(np.max(np.abs(port - ref))) <= rtol * scale


def _t(a):
    return tensor_from_numpy(a, device="cpu")


def _nodes(kind):
    if kind == "uniform":
        return np.linspace(0.0, 1.0, 7), np.linspace(0.0, 1.0, 6), np.linspace(0.0, 1.0, 5)
    rng = np.random.default_rng(41)
    inner = [np.sort(rng.uniform(0.05, 0.95, n)) for n in (5, 4, 3)]
    return tuple(np.concatenate([[0.0], c, [1.0]]) for c in inner)


SHAPE = (7, 6, 5)


@pytest.fixture(scope="module", params=["uniform", "nonuniform"])
def grids(request):
    x, y, z = _nodes(request.param)
    return j_grid.make_grid3(x, y, z), grid3_from_nodes(x, y, z, device="cpu")


def _fields(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE) for _ in range(n)]


GRID_FIELDS = [f.name for f in dataclasses.fields(t_grid.Grid3) if f.name not in ("N", "M", "P")]


@pytest.mark.parametrize("name", GRID_FIELDS)
def test_grid3_metric(grids, name):
    jg, tg = grids
    assert (tg.N, tg.M, tg.P) == (jg.N, jg.M, jg.P)
    assert getattr(tg, name).dtype == (torch.int32 if name == "color7" else torch.float64)
    assert_close(getattr(tg, name), getattr(jg, name), rtol=0.0)


def test_uniform_grid3_float32_on_request():
    g = t_grid.make_uniform_grid3(6, 5, 4, dtype=torch.float32, device="cpu")
    assert g.xx.dtype == torch.float32 and g.full_shape == (7, 6, 5) == tuple(g.xx.shape)
    assert_close(g.inv_ll, np.asarray(j_grid.make_uniform_grid3(6, 5, 4).inv_ll), rtol=1e-7)


@pytest.mark.parametrize(
    "name", ["shift_xm", "shift_xp", "shift_ym", "shift_yp", "shift_zm", "shift_zp", "asum", "amax"]
)
def test_shift_and_reduction(name):
    (u,) = _fields(1)
    # the shifts are exact; a sum may be taken in another order
    rtol = RTOL if name == "asum" else 0.0
    assert_close(getattr(T_OPS, name)(_t(u)), getattr(J_OPS, name)(jnp.asarray(u)), rtol=rtol)


@pytest.mark.parametrize(
    "name",
    ["Mx3", "My3", "Mz3", "Dx_reg3", "Dy_reg3", "Dz_reg3", "Dx_star3", "Dy_star3", "Dz_star3"],
)
def test_stencil_operator(grids, name):
    jg, tg = grids
    (u,) = _fields(1)
    assert_close(getattr(t_st, name)(T_OPS, tg, _t(u)), getattr(j_st, name)(J_OPS, jg, jnp.asarray(u)))


def test_grad_H3(grids):
    jg, tg = grids
    (u,) = _fields(1)
    for port, ref in zip(t_st.grad_H3(T_OPS, tg, _t(u)), j_st.grad_H3(J_OPS, jg, jnp.asarray(u))):
        assert_close(port, ref)


def test_inner_products(grids):
    jg, tg = grids
    f = _fields(6, seed=6)
    assert_close(t_ip.inner_H3(T_OPS, tg, _t(f[0]), _t(f[1])),
                 j_ip.inner_H3(J_OPS, jg, jnp.asarray(f[0]), jnp.asarray(f[1])))
    assert_close(t_ip.inner_p3(T_OPS, tg, *(_t(a) for a in f)),
                 j_ip.inner_p3(J_OPS, jg, *(jnp.asarray(a) for a in f)))


def test_avg_int3(grids):
    jg, tg = grids
    port = t_avg_int3(lambda x, y, z: torch.sin(3.0 * x) * torch.exp(y) * torch.cos(z) + x * y * z**2, tg, T_OPS)
    ref = j_avg_int3(lambda x, y, z: jnp.sin(3.0 * x) * jnp.exp(y) * jnp.cos(z) + x * y * z**2, jg, J_OPS)
    assert_close(port, ref)


def test_stencil7_apply():
    planes = _fields(8, seed=7)
    port = stencil7_from_numpy(planes[:7], device="cpu").apply(T_OPS, _t(planes[7]))
    ref = j_diff.Stencil7(*map(jnp.asarray, planes[:7])).apply(J_OPS, jnp.asarray(planes[7]))
    assert_close(port, ref)


@pytest.mark.parametrize("builder", ["diffusion_planes3", "advection_planes3"])
def test_plane_builder(grids, builder):
    jg, tg = grids
    coeffs = _fields(3, seed=8)
    port = getattr(t_diff, builder)(tg, T_OPS, *(_t(a) for a in coeffs))
    ref = getattr(j_diff, builder)(jg, J_OPS, *(jnp.asarray(a) for a in coeffs))
    for p, r in zip(port, ref):
        assert_close(p, r)


def test_diffusion_apply3_matches_jax_and_its_planes(grids):
    """The matrix-free 3-D diffusion operator against the JAX package's at
    1e-13 of its max-norm, and its closed-form planes applied to the same
    field give it too (the JAX package's own check of the planes)."""
    jg, tg = grids
    ax, ay, az, u = _fields(4, seed=10)
    ax, ay, az = (0.5 + np.abs(a) for a in (ax, ay, az))
    port = t_diff.diffusion_apply3(T_OPS, tg, _t(ax), _t(ay), _t(az), _t(u))
    ref = j_diff.diffusion_apply3(J_OPS, jg, *map(jnp.asarray, (ax, ay, az, u)))
    assert_close(port, ref, rtol=1e-13)
    planes = t_diff.diffusion_planes3(tg, T_OPS, _t(ax), _t(ay), _t(az))
    assert_close(planes.apply(T_OPS, _t(u)), ref, rtol=1e-13)


def test_newton_planes3_and_add_diag(grids):
    jg, tg = grids
    ax, ay, az, d = _fields(4, seed=9)
    port = t_diff.diffusion_planes3(tg, T_OPS, _t(ax), _t(ay), _t(az))
    ref = j_diff.diffusion_planes3(jg, J_OPS, *map(jnp.asarray, (ax, ay, az)))
    port = t_diff.stencil_add_diag3(t_diff.newton_planes3(tg, T_OPS, port, 2.5e-3), _t(d))
    ref = j_diff.stencil_add_diag3(j_diff.newton_planes3(jg, J_OPS, ref, 2.5e-3), jnp.asarray(d))
    for p, r in zip(port, ref):
        assert_close(p, r)


# ---------------------------------------------------------------------------
# physics at N=6
# ---------------------------------------------------------------------------
def _models():
    jm = JModel02(J_DEFAULT_CONSTS._replace(**STUDY_CONSTS))
    return jm, TModel02(consts_from_dict(jm.consts()._asdict()))


@pytest.fixture(scope="module")
def physics():
    jm, tm = _models()
    jg, jcase, jfield, jinteg = j_make_setup3(JCase, N=6, model=jm, eta=ETA)
    tg, tcase, tfield, tinteg = t_make_setup3(TCase, N=6, model=tm, eta=ETA, device="cpu")
    rng = np.random.default_rng(3)
    state = {v: 0.05 * rng.standard_normal((7, 7, 7)) for v in FIELDS}
    return dict(jg=jg, tg=tg, jm=jm, tm=tm, jcase=jcase, tcase=tcase, jfield=jfield,
                tfield=tfield, state=state)


@pytest.mark.parametrize("d", [0, 1])
def test_model_V3(physics, d):
    x = np.random.default_rng(4).uniform(-2.0, 2.0, (4, 4, 4))
    port = physics["tm"].V3(_t(x), d=d)
    assert_close(port, physics["jm"].V3(jnp.asarray(x), d=d), rtol=0.0)


@pytest.mark.parametrize(
    "name",
    [f"{p}cp" for p in ("", "dt_", "dtt_", "dx_", "dy_", "dz_", "dxx_", "dyy_", "dzz_", "lap_")]
    + ["T", "cl", "cd", "cs"],
)
def test_expsin3_pack(physics, name):
    tg, jg = physics["tg"], physics["jg"]
    port = getattr(physics["tcase"], name)(T_EVAL, tg.xx, tg.yy, tg.zz)
    ref = getattr(physics["jcase"], name)(T_EVAL, jg.xx, jg.yy, jg.zz)
    assert port.shape == (7, 7, 7)
    assert_close(port, ref, RTOL_PHYSICS)


@pytest.mark.parametrize("name", ["cp", "dt_cp", "dz_cp", "dxx_cp", "lap_cp"])
def test_pol3_pack(physics, name):
    from na_dd_tpu.three_d.mms import MMSCasePol3 as JPol3
    from na_dd_tpu_torch.three_d.mms import MMSCasePol3 as TPol3

    tg, jg = physics["tg"], physics["jg"]
    port = getattr(TPol3(tg, physics["tm"], ampl=2.0, speed=3.0), name)(T_EVAL, tg.xx, tg.yy, tg.zz)
    ref = getattr(JPol3(jg, physics["jm"], ampl=2.0, speed=3.0), name)(T_EVAL, jg.xx, jg.yy, jg.zz)
    assert_close(port, ref, RTOL_PHYSICS)


@pytest.mark.parametrize("term", ["fcp", "fT", "fcl", "fcd", "fcs"])
def test_forcing_term(physics, term):
    port = getattr(physics["tfield"].forcing, term)(physics["tg"], T_OPS, torch.tensor(T_EVAL, dtype=torch.float64))
    ref = getattr(physics["jfield"].forcing, term)(physics["jg"], J_OPS, T_EVAL)
    assert_close(port, ref, RTOL_PHYSICS)


def _states(physics):
    ts = state_from_numpy(physics["state"], device="cpu")
    js = JState(**{k: jnp.asarray(v) for k, v in physics["state"].items()})
    return ts, js


@pytest.mark.parametrize("fname", ["Fcp", "FT", "Fcl", "Fcd", "Fcs"])
def test_field(physics, fname):
    ts, js = _states(physics)
    t = torch.tensor(T_EVAL, dtype=torch.float64)
    port = getattr(physics["tfield"], fname)(physics["tg"], T_OPS, ts, t)
    ref = getattr(physics["jfield"], fname)(physics["jg"], J_OPS, js, T_EVAL)
    assert_close(port, ref, RTOL_PHYSICS)


@pytest.mark.parametrize("planes", ["stencil_dFT_dT", "stencil_dFcl_dcl", "stencil_dFcd_dcd"])
def test_self_jacobian_planes(physics, planes):
    ts, js = _states(physics)
    port = getattr(physics["tfield"], planes)(physics["tg"], T_OPS, ts)
    ref = getattr(physics["jfield"], planes)(physics["jg"], J_OPS, js)
    assert isinstance(port, t_diff.Stencil7)
    for p, r in zip(port, ref):
        assert_close(p, r, RTOL_PHYSICS)


# ---------------------------------------------------------------------------
# the integrator and the trial
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_step():
    """One step at N=6, dt=5e-3, two Newton sweeps, from the exact initial
    state, in both packages; JAX through its Pallas kernels in interpret
    mode with the port's Krylov budget."""
    jm, tm = _models()
    dt = 5e-3
    loops = dict(num_newton_steps=2, track_residuals=False, krylov_unroll=24)
    jg, jcase, _, jinteg = j_make_setup3(
        JCase, N=6, model=jm, eta=ETA, integrator_params=dict(stencil_backend="pallas", **loops)
    )
    tg, tcase, _, tinteg = t_make_setup3(TCase, N=6, model=tm, eta=ETA, integrator_params=loops, device="cpu")
    from na_dd_tpu.three_d.mms import state_from_mms_when3

    js0 = state_from_mms_when3(mms_case=jcase, t=0.0, grid=jg)
    j_state, j_diag = jax.jit(jinteg.step_fn, static_argnums=1)(jg, J_OPS, js0, 0.0, dt)
    ts0 = state_from_numpy({k: np.asarray(v) for k, v in js0._asdict().items()}, device="cpu")
    t_state, t_diag = tinteg.step_fn(tg, T_OPS, ts0, 0.0, dt)
    return j_state, j_diag, t_state, t_diag


@pytest.mark.parametrize("field", FIELDS)
def test_one_step_field_matches_jax_pallas(one_step, field):
    j_state, _, t_state, _ = one_step
    assert_close(getattr(t_state, field), getattr(j_state, field), RTOL_PHYSICS)


def test_one_step_krylov_diagnostics_match_jax_pallas(one_step):
    _, j_diag, _, t_diag = one_step
    assert int(t_diag.krylov_iters) == int(j_diag.krylov_iters) > 0
    assert bool(t_diag.krylov_converged) and bool(j_diag.krylov_converged)


@pytest.fixture(scope="module")
def analytic_step():
    """One step at N=4, dt=1e-2, two Newton sweeps, analytic couplings, in
    both packages, and the port's solver calls by kind."""
    jm, tm = _models()
    dt = 1e-2
    loops = dict(num_newton_steps=2, track_residuals=False, krylov_unroll=24,
                 coupling_source="analytic")
    jg, jcase, _, jinteg = j_make_setup3(
        JCase, N=4, model=jm, eta=ETA, integrator_params=dict(stencil_backend="pallas", **loops)
    )
    tg, tcase, _, tinteg = t_make_setup3(TCase, N=4, model=tm, eta=ETA, integrator_params=loops, device="cpu")
    from na_dd_tpu.three_d.mms import state_from_mms_when3

    js0 = state_from_mms_when3(mms_case=jcase, t=0.0, grid=jg)
    j_state, j_diag = jax.jit(jinteg.step_fn, static_argnums=1)(jg, J_OPS, js0, 0.0, dt)
    calls = []
    solver = tinteg.solver

    class Counting:
        def solve(self, *args):
            calls.append("solve")
            return solver.solve(*args)

        def solve_triple(self, *args):
            calls.append("solve_triple")
            return solver.solve_triple(*args)

    tinteg.solver = Counting()
    ts0 = state_from_numpy({k: np.asarray(v) for k, v in js0._asdict().items()}, device="cpu")
    t_state, t_diag = tinteg.step_fn(tg, T_OPS, ts0, 0.0, dt)
    return j_state, j_diag, t_state, t_diag, calls


@pytest.mark.parametrize("field", FIELDS)
def test_analytic_step_field_matches_jax(analytic_step, field):
    j_state, _, t_state, _, _ = analytic_step
    assert_close(getattr(t_state, field), getattr(j_state, field), RTOL_PHYSICS)


def test_analytic_step_takes_the_per_solve_route(analytic_step):
    _, j_diag, _, t_diag, calls = analytic_step
    assert calls == ["solve"] * 6
    assert int(t_diag.krylov_iters) == int(j_diag.krylov_iters) > 0
    assert bool(t_diag.krylov_converged) and bool(j_diag.krylov_converged)


@pytest.fixture(scope="module")
def jax_trial3():
    """``trial(N, dt)``: (grid, result) of the JAX package's ``run_trial3`` on
    the three_d_study protocol (RegHCs, MMSCaseExpSin3, STUDY_CONSTS, eta=50,
    Tf=0.02, two Newton sweeps), each (N, dt) run once for the module."""
    jm, _tm = _models()
    done = {}

    def trial(N, dt):
        if (N, dt) not in done:
            jg, jcase, _, jinteg = j_make_setup3(JCase, N=N, model=jm, eta=ETA,
                                                 integrator_params=dict(num_newton_steps=2))
            done[(N, dt)] = jg, j_run_trial3(jg, jcase, jinteg, Tf=0.02, dt=dt)
        return done[(N, dt)]

    return trial


@pytest.mark.parametrize("N", [4, 8])
def test_run_trial3_matches_jax_and_cpu_x64(N, jax_trial3):
    jm, tm = _models()
    dt = 1e-2 / (N // 4)
    params = dict(num_newton_steps=2)
    ref = jax_trial3(N, dt)[1]
    tg, tcase, _, tinteg = t_make_setup3(TCase, N=N, model=tm, eta=ETA, integrator_params=params, device="cpu")
    port = t_run_trial3(tg, tcase, tinteg, Tf=0.02, dt=dt)
    assert port["krylov_converged"] and ref["krylov_converged"]
    assert abs(port["error"] - ref["error"]) <= 1e-10 * ref["error"]
    assert abs(port["error"] - CPU_X64[N]) <= 1e-10 * CPU_X64[N]
    for v in FIELDS:
        # a final per-field error can be far below the combined one, so it
        # is held to 1e-10 of the combined error
        a, b = port["errors_final"][v], ref["errors_final"][v]
        assert abs(a - b) <= 1e-10 * ref["error"]
        assert_close(getattr(port["state"], v), getattr(ref["state"], v), 1e-10)


def test_mixed_precision_3d_matches_jax_and_full():
    """Twin of tests/test_three_d_model.py's mixed test: precision="mixed"
    on Stencil7 planes (float32 K5 solves under float64 refinement) at N=5,
    against the JAX package's mixed run at 1e-10 and the port's full-f64
    run at 1e-8."""
    from na_dd_tpu.three_d.harness import mms_error3 as j_mms_error3
    from na_dd_tpu_torch.integrators import MixedBackend
    from na_dd_tpu_torch.three_d.harness import mms_error3 as t_mms_error3

    jm = JModel02(J_DEFAULT_CONSTS._replace(**STUDY_CONSTS, gamma_T=1e-2))
    tm = TModel02(consts_from_dict(jm.consts()._asdict()))
    common = dict(N=5, Tf=0.01, dt=2.5e-3)
    mixed = dict(precision="mixed")
    ref = j_mms_error3(JCase, model=jm, **common, integrator_params=mixed)
    port = t_mms_error3(TCase, model=tm, **common, integrator_params=mixed, device="cpu")
    full = t_mms_error3(TCase, model=tm, **common, device="cpu")
    assert abs(port - ref) <= 1e-10 * ref
    assert abs(port - full) <= 1e-8 * full
    _, _, _, integ = t_make_setup3(TCase, N=5, model=tm, integrator_params=mixed, device="cpu")
    assert isinstance(integ.solver, MixedBackend) and integ.precision == "mixed"


@pytest.mark.parametrize("nodes", [([0.0, 1.0], [0.0, 0.5, 1.0]), ([0.0, 0.6, 0.5, 1.0], [0.0, 0.5, 1.0])])
def test_make_grid3_refuses_bad_nodes(nodes):
    x, y = nodes
    with pytest.raises(ValueError):
        t_grid.make_grid3(x, y, y, device="cpu")


# ---------------------------------------------------------------------------
# the solver options: probing, transposed planes, direct, heat, gradients
# ---------------------------------------------------------------------------
RTOL_SOLVE = 1e-12
SEED = 86420


@pytest.mark.parametrize("fname,var,planes", [("FT", "T", "stencil_dFT_dT"),
                                              ("Fcl", "cl", "stencil_dFcl_dcl"),
                                              ("Fcd", "cd", "stencil_dFcd_dcd")])
def test_probe_stencil3_matches_jax_and_analytic(physics, fname, var, planes):
    ts, js = _states(physics)
    jg, tg, dt = physics["jg"], physics["tg"], 1e-3
    _f0, jlin = jax.linearize(
        lambda w: getattr(physics["jfield"], fname)(jg, J_OPS, js._replace(**{var: w}), T_EVAL),
        getattr(js, var))
    jm = jg.interior_mask
    j_probed = j_diff.probe_stencil3(lambda w: (2.0 * (w * jm) - dt * jlin(w * jm)) * jm, jg)
    from na_dd_tpu_torch.ops.linsolve import linearized

    _tf0, tlin = linearized(
        lambda w: getattr(physics["tfield"], fname)(tg, T_OPS, ts._replace(**{var: w}), T_EVAL),
        getattr(ts, var))
    tm = tg.interior_mask
    t_probed = t_diff.probe_stencil3(lambda w: (2.0 * (w * tm) - dt * tlin(w * tm)) * tm, tg)
    analytic = t_diff.newton_planes3(tg, T_OPS, getattr(physics["tfield"], planes)(tg, T_OPS, ts), dt)
    for p, jp, a in zip(t_probed, j_probed, analytic):
        assert_close(p, jp, RTOL_SOLVE)
        assert_close(p, a.numpy(), RTOL_SOLVE)


def _newton_like_stencil7(shape, seed, dead=()):
    """Random Stencil7 volumes with the Newton planes' structure: rows and
    off-diagonals masked (``mask·shift(mask)``), diagonally dominant."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(shape)
    mask[1:-1, 1:-1, 1:-1] = 1.0
    for node in dead:
        mask[node] = 0.0
    tmask = _t(mask)
    shifts = (T_OPS.shift_xm, T_OPS.shift_xp, T_OPS.shift_ym, T_OPS.shift_yp, T_OPS.shift_zm,
              T_OPS.shift_zp)
    c0 = (rng.random(shape) * 0.5 + 6.0) * mask
    offs = [rng.random(shape) * 0.5 * mask * sh(tmask).numpy() for sh in shifts]
    return [c0, *offs], mask


def test_stencil7_transpose_matches_jax_linear_transpose():
    """Aᵀv by the transposed planes equals ``jax.linear_transpose`` of the
    JAX package's ``Stencil7.apply`` (zero inflow at the faces included),
    on a volume of every node, not only the interior."""
    planes, _mask = _newton_like_stencil7(SHAPE, SEED)
    planes = [p + 0.1 for p in planes]  # couplings into the frame too
    v = np.random.default_rng(SEED + 1).standard_normal(SHAPE)
    jst = j_diff.Stencil7(*(jnp.asarray(p) for p in planes))
    (ref,) = jax.linear_transpose(lambda w: jst.apply(J_OPS, w), jnp.zeros(SHAPE))(jnp.asarray(v))
    tst = stencil7_from_numpy(planes, device="cpu")
    assert_close(tst.transpose(T_OPS).apply(T_OPS, _t(v)), ref, 1e-14)


@pytest.mark.parametrize("dead", [(), ((2, 2, 2), (3, 1, 2))])
def test_direct_solve3_matches_jax(dead):
    """The x-plane BCR against the JAX package's (tests/test_three_d_direct_
    solve.py:75,92): interior mask, and dead interior nodes."""
    from na_dd_tpu.three_d.direct_solve import stencil7_solve_direct as j_direct3
    from na_dd_tpu_torch.three_d.direct_solve import stencil7_solve_direct as t_direct3

    shape = (6, 5, 7)
    rng = np.random.default_rng(SEED + 2)
    planes = [rng.random(shape) * 0.5 + (6.0 if k == 0 else 0.0) for k in range(7)]
    mask = np.zeros(shape)
    mask[1:-1, 1:-1, 1:-1] = 1.0
    for node in dead:
        mask[node] = 0.0
    b = rng.random(shape) * mask
    ref = j_direct3(j_diff.Stencil7(*(jnp.asarray(p) for p in planes)), jnp.asarray(b),
                    jnp.asarray(mask))
    port = t_direct3(stencil7_from_numpy(planes, device="cpu"), _t(b), _t(mask))
    assert_close(port, ref, 1e-10)
    assert float((port * (1 - _t(mask))).abs().max()) == 0.0


def test_crank_nicolson_heat_step_matches_jax():
    """tests/test_three_d.py:104 on both packages: one CN step at N=6."""
    jg, tg = j_grid.make_uniform_grid3(6, 6, 6), t_grid.make_uniform_grid3(6, 6, 6, device="cpu")
    rng = np.random.default_rng(3)
    u = rng.random((7, 7, 7)) * np.asarray(jg.interior_mask)
    f = rng.random((7, 7, 7)) * np.asarray(jg.interior_mask)
    jst = j_diff.diffusion_planes3(jg, J_OPS, *(jnp.full((7, 7, 7), 0.2),) * 3)
    tst = t_diff.diffusion_planes3(tg, T_OPS, *(torch.full((7, 7, 7), 0.2, dtype=torch.float64),) * 3)
    ju, jinfo = j_diff.crank_nicolson_heat_step(jg, J_OPS, jst, jnp.asarray(u), jnp.asarray(f),
                                                jnp.asarray(f), 1e-2)
    tu, tinfo = t_diff.crank_nicolson_heat_step(tg, T_OPS, tst, _t(u), _t(f), _t(f), 1e-2)
    assert bool(tinfo["converged"]) and int(tinfo["iters"]) == int(jinfo["iters"])
    assert_close(tu, ju, RTOL_SOLVE)
    mask, tu0 = tg.interior_mask, _t(u)
    res = (mask * (tu - 0.5e-2 * tst.apply(T_OPS, tu))
           - mask * (tu0 + 0.5e-2 * tst.apply(T_OPS, tu0) + 1e-2 * _t(f)))
    assert float(res.abs().max()) < 1e-11


@pytest.mark.parametrize("N", [4, 8])
def test_heat_mms_error_matches_jax(N):
    """≤1e-11: the port applies the CN operator as assembled planes (the K5
    kernel's form), the JAX package as ``m·(w − dt/2·L w)``; the rounding of
    the two forms differs by a few ulp an apply, 4.4e-12 of the error at
    N=8 after 16 steps."""
    port = t_diff.heat_mms_error(N, D=0.1, Tf=0.05, dt=0.05 / (2 * N), device="cpu")
    ref = float(j_diff.heat_mms_error(N, D=0.1, Tf=0.05, dt=0.05 / (2 * N)))
    assert abs(port - ref) <= 1e-11 * ref


def _one_step_pair(N, dt, **kw):
    """One step at N from the exact ExpSin3 state in both packages, the same
    integrator options (one Newton sweep)."""
    from na_dd_tpu.three_d.mms import state_from_mms_when3

    jm, tm = _models()
    params = dict(num_newton_steps=1, track_residuals=False, krylov_unroll=None)
    params.update(kw)
    jg, jcase, _, jinteg = j_make_setup3(JCase, N=N, model=jm, eta=ETA, integrator_params=params)
    tg, _, _, tinteg = t_make_setup3(TCase, N=N, model=tm, eta=ETA, integrator_params=params,
                                     device="cpu")
    js0 = state_from_mms_when3(mms_case=jcase, t=0.0, grid=jg)
    j_state, j_diag = jax.jit(jinteg.step_fn, static_argnums=1)(jg, J_OPS, js0, 0.0, dt)
    ts0 = state_from_numpy({k: np.asarray(v) for k, v in js0._asdict().items()}, device="cpu")
    t_state, t_diag = tinteg.step_fn(tg, T_OPS, ts0, 0.0, dt)
    return j_state, j_diag, t_state, t_diag


@pytest.mark.parametrize("option", ["probe", "matrix_free", "while_form", "direct"])
def test_solver_option_step_matches_jax(option):
    """tests/test_three_d_model.py:354 on both packages: the probed, the
    matrix-free (while form), the while-form and the direct step at N=4
    against the JAX steps."""
    kw = {"probe": dict(stencil_source="probe"),
          "matrix_free": dict(assemble_stencil=False, krylov_unroll=None),
          "while_form": dict(krylov_unroll=None),
          "direct": dict(linear_solver="direct")}[option]
    j_state, j_diag, t_state, t_diag = _one_step_pair(4, 1e-3, **kw)
    for v in FIELDS:
        assert_close(getattr(t_state, v), getattr(j_state, v), RTOL_SOLVE)
    assert bool(t_diag.krylov_converged) and bool(j_diag.krylov_converged)
    if option != "direct":
        assert abs(int(t_diag.krylov_iters) - int(j_diag.krylov_iters)) <= 1


def _bump_loss_pair(N, steps, dt, kw):
    """Value and gradients (Kd, initial amplitude) of Σ w_H·cd after
    ``steps`` steps of the 3-D sin bump, differentiable=True, in both
    packages."""
    from na_dd_tpu.three_d.harness import make_integrator3 as j_make_integrator3
    from na_dd_tpu_torch.core.state import State as TState
    from na_dd_tpu_torch.three_d.harness import make_integrator3 as t_make_integrator3

    mc = J_DEFAULT_CONSTS._replace(gamma_T=1e-2, **STUDY_CONSTS)
    jg = j_grid.make_uniform_grid3(N, N, N)
    jb = jnp.sin(jnp.pi * jg.xx) * jnp.sin(jnp.pi * jg.yy) * jnp.sin(jnp.pi * jg.zz) * jg.interior_mask

    def jloss(Kd, amp):
        integ = j_make_integrator3(jg, JModel02(mc._replace(Kd=Kd)), differentiable=True, **kw)
        s = JState(0.2 * amp * jb, 0.1 * amp * jb, 0.0 * jb, 0.05 * amp * jb, amp * jb)
        for k in range(steps):
            s, _ = integ.step_fn(jg, J_OPS, s, k * dt, dt)
        return J_OPS.asum(jg.w_H * s.cd)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(jnp.asarray(mc.Kd),
                                                                       jnp.asarray(1.0))
    tg = t_grid.make_uniform_grid3(N, N, N, device="cpu")
    tb = torch.sin(np.pi * tg.xx) * torch.sin(np.pi * tg.yy) * torch.sin(np.pi * tg.zz) * tg.interior_mask
    Kd = torch.tensor(mc.Kd, dtype=torch.float64, requires_grad=True)
    amp = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    tmc = consts_from_dict(mc._asdict())._replace(Kd=Kd)
    integ = t_make_integrator3(tg, TModel02(tmc), differentiable=True, **kw)
    s = TState(0.2 * amp * tb, 0.1 * amp * tb, 0.0 * tb, 0.05 * amp * tb, amp * tb)
    for k in range(steps):
        s, _ = integ.step_fn(tg, T_OPS, s, k * dt, dt)
    val = T_OPS.asum(tg.w_H * s.cd)
    tgrads = torch.autograd.grad(val, (Kd, amp))
    return (float(jval), [float(v) for v in jgrads]), (float(val), [float(v) for v in tgrads])


@pytest.mark.parametrize("option", ["krylov", "matrix_free"])
def test_differentiable_3d_matches_jax_grad(option):
    """IFT gradients in 3-D (K5 on ``Stencil7.transpose`` volumes for the
    Krylov route; the probed volumes' transpose behind the matrix-free
    forward) against ``jax.grad`` of the same run: ≤1e-8."""
    kw = {"krylov": dict(krylov_unroll=None),
          "matrix_free": dict(assemble_stencil=False, krylov_unroll=None)}[option]
    (jval, jgrads), (tval, tgrads) = _bump_loss_pair(4, 2, 1e-3, kw)
    assert abs(tval - jval) <= 1e-12 * abs(jval)
    for a, b in zip(tgrads, jgrads):
        assert b != 0.0 and abs(a - b) <= 1e-8 * abs(b)


@pytest.mark.parametrize("kw", [dict(precision="mixed", krylov_unroll=8), dict(linear_solver="direct")],
                         ids=["mixed", "direct"])
def test_differentiable_3d_refuses_what_jax_cannot_run(kw):
    """The JAX 3-D integrators fail with AttributeError (no Stencil7
    transpose) at their first step; the port refuses the same modes with the
    same exception type when it is built."""
    from na_dd_tpu.three_d.harness import make_integrator3 as j_make_integrator3
    from na_dd_tpu_torch.three_d.harness import make_integrator3 as t_make_integrator3

    jm, tm = _models()
    jg = j_grid.make_uniform_grid3(4, 4, 4)
    integ = j_make_integrator3(jg, jm, differentiable=True, **kw)
    s0 = JState(*(jg.interior_mask,) * 5)
    with pytest.raises(AttributeError, match="transpose"):
        jax.grad(lambda a: J_OPS.asum(integ.step_fn(jg, J_OPS, s0._replace(cs=a * s0.cs), 0.0,
                                                    1e-3)[0].cd))(1.0)
    tg = t_grid.make_uniform_grid3(4, 4, 4, device="cpu")
    with pytest.raises(AttributeError, match="transpose"):
        t_make_integrator3(tg, tm, differentiable=True, **kw)


# ---------------------------------------------------------------------------
# the 3-D study CLI
# ---------------------------------------------------------------------------
#: the JAX script's JSON keys: the serial ladders', and those it adds to the
#: batched ladder's and the eta sweep's result dicts
JAX_LADDER_KEYS = {"backend", "x64", "variant", "kind", "precision", "Tf", "eta", "levels",
                   "rates", "self_reference_rates", "adjudication", "timestamp"}
JAX_BATCHED_KEYS = {"kind", "Ns", "Tf", "eta", "errors", "converged", "compile_plus_run_s",
                    "steady_s", "krylov_unroll", "rates", "statuses", "backend", "x64",
                    "timestamp"}
JAX_SWEEP_KEYS = {"etas", "errors", "converged", "backend", "x64", "N", "Tf", "dt",
                  "wallclock_s", "timestamp"}


def _study(tmp_path, *argv):
    """``three_d_study.main`` on the CPU into ``tmp_path``: (rc, its JSON)."""
    from na_dd_tpu_torch.studies import three_d_study

    rc = three_d_study.main([*argv, "--device", "cpu", "--results-dir", str(tmp_path)])
    (path,) = tmp_path.glob("*.json")
    return rc, json.loads(path.read_text())


def _rel(a, b):
    return abs(a - b) / abs(b)


def _assert_adjudicated(res, gated):
    adj = res["adjudication"]
    assert {"passed", "cpu_error", "rel_dev", "tol", "gated_levels", "skipped_no_record"} <= set(adj)
    assert adj["passed"] is True and adj["tol"] == 1e-8
    assert len(adj["gated_levels"]) == gated


@pytest.mark.parametrize("variant", ["reghcs", "cs", "hcs"])
def test_three_d_study_ladder_matches_jax(tmp_path, jax_trial3, variant):
    from na_dd_tpu_torch.studies.reference_values import THREE_D_LEVELS_CPU_X64

    rc, res = _study(tmp_path, "--levels", "2", "--n0", "4", "--variant", variant)
    assert rc == 0 and set(res) == JAX_LADDER_KEYS | {"device"}
    assert (res["variant"], res["kind"], res["device"], res["x64"]) == (variant, "spatial", "cpu", True)
    for k, lv in enumerate(res["levels"]):
        N, dt = 4 * 2**k, 1e-2 / 2**k
        assert (lv["N"], lv["dt"], lv["converged"]) == (N, dt, True)
        if variant == "reghcs":
            ref = jax_trial3(N, dt)[1]["error"]
        else:
            ref = THREE_D_LEVELS_CPU_X64[(variant, N, dt)]
        assert _rel(lv["error"], ref) <= 1e-10
        assert lv["cold_s"] > 0 and lv["warm_s"] > 0
    assert len(res["rates"]) == 1
    _assert_adjudicated(res, 2)


def test_three_d_study_temporal_self_reference_matches_the_jax_record(tmp_path):
    from na_dd_tpu_torch.studies.reference_values import (
        THREE_D_LEVELS_CPU_X64,
        THREE_D_SELF_REF_CPU_X64,
    )

    rc, res = _study(tmp_path, "--temporal", "--self-reference", "--n0", "4", "--levels", "2")
    assert rc == 0 and res["kind"] == "temporal" and set(res) == JAX_LADDER_KEYS | {"device"}
    for k, lv in enumerate(res["levels"]):
        dt = 1e-2 / 2**k
        assert (lv["N"], lv["dt"]) == (4, dt)
        assert _rel(lv["error"], THREE_D_LEVELS_CPU_X64[("reghcs", 4, dt)]) <= 1e-10
        ref = THREE_D_SELF_REF_CPU_X64[("reghcs", 4, dt, 1e-2 / 2**3)]
        assert _rel(lv["self_ref_error"], ref) <= 1e-10
    assert len(res["self_reference_rates"]) == 1
    _assert_adjudicated(res, 4)


def test_three_d_study_batched_and_eta_sweep_match_the_jax_record(tmp_path):
    from na_dd_tpu_torch.studies.reference_values import (
        ETA3_SWEEPS_CPU_X64,
        THREE_D_BATCHED_CPU_X64,
    )

    rc, res = _study(tmp_path / "batched", "--batched", "--levels", "2")
    assert rc == 0 and set(res) == JAX_BATCHED_KEYS | {"adjudication", "device"}
    for k, (N, err) in enumerate(zip(res["Ns"], res["errors"])):
        assert _rel(err, THREE_D_BATCHED_CPU_X64[(N, 1e-2 / 2**k)]) <= 1e-10
    _assert_adjudicated(res, 2)

    rc, res = _study(tmp_path / "sweep", "--eta-sweep")
    assert rc == 0 and set(res) == JAX_SWEEP_KEYS | {"adjudication", "device"}
    assert res["etas"] == [float(x) for x in np.logspace(1, 3, 7)] and all(res["converged"])
    for err, ref in zip(res["errors"], ETA3_SWEEPS_CPU_X64[(4, 1e-2)], strict=True):
        assert _rel(err, ref) <= 1e-10
    _assert_adjudicated(res, 7)


def test_three_d_study_level_off_its_record_fails(tmp_path, monkeypatch):
    from na_dd_tpu_torch.studies import three_d_study

    key = ("reghcs", 4, 1e-2)
    monkeypatch.setitem(three_d_study.THREE_D_LEVELS_CPU_X64, key,
                        three_d_study.THREE_D_LEVELS_CPU_X64[key] * (1 + 1e-6))
    rc, res = _study(tmp_path, "--levels", "1")
    adj = res["adjudication"]
    assert rc == 1 and adj["passed"] is False and adj["rel_dev"] > 1e-8
    # off the record's protocol (another Tf) nothing is gated, nothing fails
    rc, res = _study(tmp_path, "--levels", "1", "--tf", "0.01")
    assert rc == 0 and res["adjudication"]["passed"] is None
    assert len(res["adjudication"]["skipped_no_record"]) == 1


# ---------------------------------------------------------------------------
# precision="df" and mixed_df in 3-D (through K5's plain twin here)
# ---------------------------------------------------------------------------
DF3 = dict(krylov_unroll=8, precision="df", mixed_refine=1, mixed_final_check=False)
_STEP3 = {}  # the 3-D mixed_df steps, made once for the module


def _step3(jparams, tparams, N=4, dt=1e-3):
    """One step of each package's 3-D RegHCs integrator on MMSCaseExpSin3
    from the exact state at t = 0 (the JAX step jitted), and the port's
    backend calls by kind."""
    jm, tm = _models()
    jg, jcase, _, jinteg = j_make_setup3(JCase, N=N, model=jm, eta=ETA, integrator_params=jparams)
    tg, _, _, tinteg = t_make_setup3(TCase, N=N, model=tm, eta=ETA, integrator_params=tparams,
                                     device="cpu")
    from na_dd_tpu.three_d.mms import state_from_mms_when3

    js0 = state_from_mms_when3(mms_case=jcase, t=0.0, grid=jg)
    j_state, j_diag = jax.jit(jinteg.step_fn, static_argnums=1)(jg, J_OPS, js0, 0.0, dt)
    calls = []
    for name in ("solve", "solve_df", "solve_triple_df"):
        if hasattr(tinteg.solver, name):
            fn = getattr(tinteg.solver, name)
            setattr(tinteg.solver, name,
                    lambda *a, _n=name, _f=fn: (calls.append(_n), _f(*a))[1])
    ts0 = state_from_numpy({k: np.asarray(v) for k, v in js0._asdict().items()}, device="cpu")
    t_state, t_diag = tinteg.step_fn(tg, T_OPS, ts0, 0.0, dt)
    return j_state, j_diag, t_state, t_diag, calls


@pytest.fixture(scope="module")
def df_step3():
    """The 3-D df step (N=4, dt=1e-3, budget 8, refine 1, no final check)
    and the JAX package's 3-D float64 step."""
    return _step3(dict(krylov_unroll=8), DF3)


@pytest.mark.parametrize("field", FIELDS)
def test_df_step3_field_matches_jax_f64(df_step3, field):
    j_state, _, t_state, _, _ = df_step3
    assert getattr(t_state, field).dtype == torch.float64
    assert_close(getattr(t_state, field), getattr(j_state, field), 1e-13)


def test_df_step3_route_and_record(df_step3):
    """Three DF refinements a sweep through the 7-point solve (K5 on the
    card), every solve converged; the state's norms on the JAX package's
    eager CPU-x64 df record (``studies/results/df_cpu_x64.json``, ≤1e-12)."""
    import os

    _, _, t_state, t_diag, calls = df_step3
    assert calls == ["solve_df"] * 3
    assert bool(t_diag.krylov_converged) and bool(t_diag.hcs_denominator_ok)
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "studies", "results", "df_cpu_x64.json")
    with open(path) as f:
        rec = json.load(f)["df3"]["df"]
    for name in FIELDS:
        v = getattr(t_state, name)
        assert abs(float(torch.linalg.vector_norm(v)) - rec["norm2"][name]) <= (
            1e-12 * rec["norm2"][name])
        assert abs(float(v.abs().max()) - rec["max"][name]) <= 1e-12 * rec["max"][name]


@pytest.mark.parametrize("field", FIELDS)
def test_mixed_df_step3_matches_jax(field):
    """mixed_df in 3-D (DF residuals around the float32 7-point solves)
    against the JAX package's 3-D mixed_df step, ≤1e-12."""
    kw = dict(krylov_unroll=8, precision="mixed", mixed_df=True)
    key = "mixed_df3"
    if key not in _STEP3:
        _STEP3[key] = _step3(kw, kw)
    j_state, j_diag, t_state, t_diag, calls = _STEP3[key]
    assert_close(getattr(t_state, field), getattr(j_state, field), RTOL_PHYSICS)
    assert int(t_diag.krylov_iters) == int(j_diag.krylov_iters) > 0 and calls == ["solve"] * 3



def test_three_d_study_takes_precision_df(tmp_path):
    """``three_d_study --precision df`` (the JAX script's
    NA_DD_TPU_PRECISION=df): the N=4 level through the 3-D df step (two
    Newton sweeps a step, every solve converged) on the JAX package's CPU-x64
    float64 record at the parity gate."""
    rc, res = _study(tmp_path, "--levels", "1", "--n0", "4", "--precision", "df")
    assert rc == 0 and res["precision"] == "df" and res["levels"][0]["converged"]
    _assert_adjudicated(res, 1)
