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
  CPU-x64 values of the JAX package."""

import dataclasses

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
    assert getattr(tg, name).dtype == torch.float64
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


@pytest.mark.parametrize("N", [4, 8])
def test_run_trial3_matches_jax_and_cpu_x64(N):
    jm, tm = _models()
    dt = 1e-2 / (N // 4)
    params = dict(num_newton_steps=2)
    jg, jcase, _, jinteg = j_make_setup3(JCase, N=N, model=jm, eta=ETA, integrator_params=params)
    ref = j_run_trial3(jg, jcase, jinteg, Tf=0.02, dt=dt)
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
