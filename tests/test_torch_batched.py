"""The port's batch axis (the written-out ``jax.vmap``) against the JAX
package on CPU float64, fed the same numpy inputs:

* ``pad_grid``/``pad_state`` and ``pad_grid3``/``pad_state3`` against the
  JAX package's, field by field, exactly; padding is inert (a PC step on a
  padded grid is the unpadded step at the real nodes, to 1e-13, and exactly
  0 at the dead ones);
* the batch-safe shifts: a plane (volume) of ones stacked beside one of
  zeros leaks nothing into it, and the batched reductions are each plane's;
* the batched plain K1/K2/K5/K6 against their unbatched plain versions
  element by element, with a b = 0 element, one that the budget cuts and
  one that converges, each with its own iteration count: ≤1e-13 relative;
* ``run_spatial_ladder_batched("pol", levels=3)`` against the JAX package's
  and the port's serial ladder (1e-10 each); ``run_eta_study_batched`` at
  N=6 with two η against the JAX package's (1e-10) and the port's serial
  sweep (1e-12); ``run_spatial_ladder3_batched(levels=2)`` and
  ``run_eta_sweep3`` at N=4 with two η against the JAX package's (1e-10)
  and the port's serial ``mms_error3`` (1e-12);
* both ladders with ``precision="mixed"`` (float32 solves under per-level
  float64 refinement, per-level verdicts) against the JAX package's mixed
  ladders (1e-10) and the float64 levels (the port's batched ladder in 2-D,
  CPU-x64 in 3-D; 1e-12).

Each JAX run is made once, in a module-scoped fixture."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from na_dd_tpu.harness import batched_ladder as j_bl
from na_dd_tpu.harness.studies import run_eta_study_batched as j_run_eta_study_batched
from na_dd_tpu.models import Model02 as JModel02
from na_dd_tpu.models import default_model_consts as J_DEFAULT_CONSTS
from na_dd_tpu.ops import make_uniform_grid as j_make_uniform_grid
from na_dd_tpu.three_d import MMSCaseExpSin3 as JCase3
from na_dd_tpu.three_d import batched_ladder as j_bl3
from na_dd_tpu.three_d.grid import make_uniform_grid3 as j_make_uniform_grid3
from na_dd_tpu.three_d.harness import run_eta_sweep3 as j_run_eta_sweep3
from na_dd_tpu_torch.convert import consts_from_dict, stencil5_from_numpy, stencil7_from_numpy
from na_dd_tpu_torch.convert import tensor_from_numpy
from na_dd_tpu_torch.core.fields import FieldRegHCsTriple
from na_dd_tpu_torch.core.forcing import MMSForcingRegHCsTriple
from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.harness.batched_ladder import pad_grid, pad_state, run_spatial_ladder_batched
from na_dd_tpu_torch.harness.studies import run_eta_study, run_eta_study_batched, run_spatial_study
from na_dd_tpu_torch.integrators.pc_trapezoidal import PCTrapezoidalRegHCsTriple
from na_dd_tpu_torch.mms.cases import MMSCasePol
from na_dd_tpu_torch.mms.engine import state_from_mms_when
from na_dd_tpu_torch.models.coefficients import Model02
from na_dd_tpu_torch.ops import kernels
from na_dd_tpu_torch.ops.grid import make_uniform_grid
from na_dd_tpu_torch.ops.shifts import BATCHED_OPS, LOCAL_OPS
from na_dd_tpu_torch.three_d import MMSCaseExpSin3, mms_error3, run_eta_sweep3
from na_dd_tpu_torch.three_d.batched_ladder import (
    pad_grid3,
    pad_state3,
    run_spatial_ladder3_batched,
)
from na_dd_tpu_torch.three_d.grid import make_uniform_grid3
from na_dd_tpu_torch.three_d.shifts import BATCHED_OPS3, LOCAL_OPS3

# the 3-D study's constants (studies/three_d_study.py)
THREE_D_CONSTS = dict(K1=1e-3, K2=1e-3, K3=1e-3, K4=1e-3, Dl_max=1e-5, Kd=1e-2, Sd=1.0, Dd_max=1e-6)
ETA_KW = dict(N=6, dt=2.5e-3, Tf=0.005, etas=[10.0, 100.0])
SWEEP3_KW = dict(N=4, Tf=0.02, dt=1e-2, etas=[10.0, 100.0])
# CPU-x64 errors of the JAX package's 3-D study levels (chip_smoke.py)
THREE_D_CPU_X64 = {4: 0.0005209171734887429, 8: 0.000133542682516219}


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.fixture(scope="module")
def model3():
    mc = J_DEFAULT_CONSTS._replace(**THREE_D_CONSTS)
    return JModel02(mc), Model02(consts_from_dict(mc._asdict()))


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------
def test_pad_grid_and_state_match_jax():
    jg = j_bl.pad_grid(j_make_uniform_grid(6, 5), 11, 9)
    tg = pad_grid(make_uniform_grid(6, 5, device="cpu"), 11, 9)
    assert (tg.N, tg.M) == (jg.N, jg.M) == (11, 9)
    for f in dataclasses.fields(tg):
        if isinstance(getattr(tg, f.name), torch.Tensor):
            np.testing.assert_array_equal(getattr(tg, f.name).numpy(), np.asarray(getattr(jg, f.name)))
    rng = np.random.default_rng(90)
    fields = [rng.standard_normal((7, 6)) for _ in range(5)]
    js = j_bl.pad_state(tuple(jax.numpy.asarray(a) for a in fields), 11, 9)
    ts = pad_state(State(*(torch.as_tensor(a) for a in fields)), 11, 9)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pad_grid3_and_state3_match_jax():
    jg = j_bl3.pad_grid3(j_make_uniform_grid3(3, 4, 2), 5, 6, 4)
    tg = pad_grid3(make_uniform_grid3(3, 4, 2, device="cpu"), 5, 6, 4)
    assert (tg.N, tg.M, tg.P) == (jg.N, jg.M, jg.P) == (5, 6, 4)
    for f in dataclasses.fields(tg):
        if isinstance(getattr(tg, f.name), torch.Tensor):
            np.testing.assert_array_equal(getattr(tg, f.name).numpy(), np.asarray(getattr(jg, f.name)))
    rng = np.random.default_rng(91)
    fields = [rng.standard_normal((4, 5, 3)) for _ in range(5)]
    js = j_bl3.pad_state3(tuple(jax.numpy.asarray(a) for a in fields), 5, 6, 4)
    ts = pad_state3(State(*(torch.as_tensor(a) for a in fields)), 5, 6, 4)
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_padded_grid_is_inert():
    """The twin of the JAX package's test: reductions, gradients and a whole
    PC step on a zero-padded grid are the unpadded ones, and the dead nodes
    stay exactly 0."""
    from na_dd_tpu_torch.ops import inner_products, stencils

    g = make_uniform_grid(6, 6, device="cpu")
    gp = pad_grid(g, 11, 11)
    model = Model02(consts_from_dict(J_DEFAULT_CONSTS._asdict()))
    case = MMSCasePol(grid=g, model=model)
    s = state_from_mms_when(mms_case=case, t=0.3, grid=g)
    sp = pad_state(s, 11, 11)
    a = float(inner_products.inner_H(LOCAL_OPS, g, s.T, s.T))
    b = float(inner_products.inner_H(LOCAL_OPS, gp, sp.T, sp.T))
    assert b == pytest.approx(a, rel=1e-14)
    gx, gy = stencils.grad_H(LOCAL_OPS, g, s.T)
    gxp, gyp = stencils.grad_H(LOCAL_OPS, gp, sp.T)
    np.testing.assert_array_equal(gxp[:7, :7].numpy(), gx.numpy())
    assert bool((gxp[7:, :] == 0).all()) and bool((gyp[:, 7:] == 0).all())

    forcing = MMSForcingRegHCsTriple(mms_case=case, model=model, regularization_factor=50.0)
    field = FieldRegHCsTriple(grid=g, model=model, forcing=forcing, regularization_factor=50.0)
    integ = PCTrapezoidalRegHCsTriple(field, regularization_factor=50.0, krylov_unroll=8)
    s1, _ = integ.step_fn(g, LOCAL_OPS, s, 0.3, 1e-3)
    s1p, _ = integ.step_fn(gp, LOCAL_OPS, sp, 0.3, 1e-3)
    for v in State._fields:
        real, padded = getattr(s1, v).numpy(), getattr(s1p, v).numpy()
        assert np.all(padded[7:, :] == 0.0) and np.all(padded[:, 7:] == 0.0), v
        np.testing.assert_allclose(padded[:7, :7], real, rtol=0, atol=1e-13)


# ---------------------------------------------------------------------------
# batch-safe shifts and reductions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dim", [2, 3])
def test_batched_shifts_leak_nothing(dim):
    ops, batched = (LOCAL_OPS, BATCHED_OPS) if dim == 2 else (LOCAL_OPS3, BATCHED_OPS3)
    shape = (5, 4) if dim == 2 else (5, 4, 3)
    ones = torch.ones(shape, dtype=torch.float64)
    stack = torch.stack([ones, torch.zeros(shape, dtype=torch.float64), ones])
    names = [n for n in dir(ops) if n.startswith("shift_")]
    assert len(names) == 2 * dim
    for name in names:
        out = getattr(batched, name)(stack)
        assert bool((out[1] == 0).all()), name
        assert torch.equal(out[0], getattr(ops, name)(ones)), name
        assert torch.equal(out[2], getattr(ops, name)(ones)), name
    rng = np.random.default_rng(92)
    u = torch.as_tensor(rng.standard_normal((3, *shape)))
    sums, maxes = batched.asum(u), batched.amax(u)
    assert sums.shape == maxes.shape == (3,) + (1,) * dim
    for k in range(3):
        assert float(sums[k].squeeze()) == pytest.approx(float(ops.asum(u[k])), rel=1e-15)
        assert float(maxes[k].squeeze()) == float(ops.amax(u[k]))


# ---------------------------------------------------------------------------
# batched plain kernels against the unbatched ones, element by element
# ---------------------------------------------------------------------------
def _system(seed, shape):
    """A diagonally dominant Stencil5 (2-D) or Stencil7 (3-D) Newton-shaped
    system: planes, rhs, inverse diagonal, mask (numpy)."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(shape)
    mask[(slice(1, -1),) * len(shape)] = 1.0
    c0 = (2.2 + 2.0 * (len(shape) - 2) + rng.random(shape)) * mask
    planes = [c0] + [-rng.random(shape) * mask for _ in range(2 * len(shape))]
    b = rng.standard_normal(shape) * mask
    inv = np.where(mask > 0, 1.0 / np.where(c0 == 0, 1.0, c0), 0.0)
    return planes, b, inv, mask


def _batch(shape):
    """Three systems: b = 0, A = c0·I (one iteration) and a dominant one."""
    systems = [_system(93 + k, shape) for k in range(3)]
    systems[0] = (systems[0][0], np.zeros(shape), *systems[0][2:])
    planes1 = systems[1][0]
    systems[1] = ([planes1[0]] + [np.zeros(shape)] * (len(planes1) - 1), *systems[1][1:])
    to_st = stencil5_from_numpy if len(shape) == 2 else stencil7_from_numpy
    one = [(to_st(p, torch.float64, "cpu"), *(tensor_from_numpy(a, torch.float64, "cpu")
                                                for a in (b, inv, m))) for p, b, inv, m in systems]
    stacked = (type(one[0][0])(*(torch.stack(c) for c in zip(*(s[0] for s in one)))),
               *(torch.stack([s[k] for s in one]) for k in (1, 2, 3)))
    return one, stacked


@pytest.mark.parametrize("shape", [(9, 8), (6, 7, 5)], ids=["planes", "volumes"])
@pytest.mark.parametrize("budget", [4, 60])
def test_batched_plain_solve_is_each_system_alone(shape, budget):
    solve = kernels.bicgstab_solve if len(shape) == 2 else kernels.bicgstab_solve3
    one, (st, b, inv, mask) = _batch(shape)
    x, info = solve(st, b, inv, mask, tol=1e-13, iters=budget)
    assert info["iters"].shape == (3,)
    assert info["resnorm_sq"].shape == info["converged"].shape == (3,) + (1,) * len(shape)
    used = info["iters"].tolist()
    assert used[:2] == [0, 1]
    if budget == 4:
        assert used[2] == 4 and not bool(info["converged"][2])  # the budget cuts it
    else:
        assert 4 < used[2] < budget and bool(info["converged"].all())
    for k, (st_k, b_k, inv_k, mask_k) in enumerate(one):
        x_k, info_k = solve(st_k, b_k, inv_k, mask_k, tol=1e-13, iters=budget)
        assert int(info_k["iters"]) == used[k]
        scale = max(float(x_k.abs().max()), 1e-300)
        assert float((x[k] - x_k).abs().max()) <= 1e-13 * scale
        assert float(info["resnorm_sq"][k].squeeze()) == pytest.approx(
            float(info_k["resnorm_sq"]), rel=1e-10, abs=1e-300)


@pytest.mark.parametrize("shape", [(9, 8), (6, 7, 5)], ids=["planes", "volumes"])
def test_batched_plain_apply_is_each_system_alone(shape):
    apply = kernels.stencil5_apply if len(shape) == 2 else kernels.stencil7_apply
    one, (st, b, _inv, _mask) = _batch(shape)
    rng = np.random.default_rng(94)
    u = torch.as_tensor(rng.standard_normal(b.shape))
    out = apply(st, u)
    for k, (st_k, *_rest) in enumerate(one):
        torch.testing.assert_close(out[k], apply(st_k, u[k]), rtol=0, atol=0)


def test_triple_solve_takes_a_stack_up_to_the_batch_limit():
    """K4 takes a stack (one info entry a system and solve) with one dt or
    one a system, and refuses more systems than one launch holds
    (``bicgstab::kMaxBatch``), on the CPU as on the card."""
    one, (st, b, inv, mask) = _batch((9, 8))
    dts = torch.tensor([1e-3, 2e-3, 4e-3], dtype=torch.float64).reshape(3, 1, 1)
    *_x, info = kernels.triple_solve(st, st, st, st, st, b, b, b, b, inv, inv, inv, mask, dts,
                                     tol=1e-13, iters=4)
    assert all(v.shape == (3, 3) for v in info.values())
    many = kernels.MAX_BATCH + 1
    big = type(st)(*(c[:1].expand(many, -1, -1) for c in st))
    bb, ii, mm = (t[:1].expand(many, -1, -1) for t in (b, inv, mask))
    with pytest.raises(ValueError, match="at most 32 systems"):
        kernels.triple_solve(big, big, big, big, big, bb, bb, bb, bb, ii, ii, ii, mm, 1e-3,
                             tol=1e-13, iters=4)


# ---------------------------------------------------------------------------
# batched K4 (the fused triple solve) against the JAX kernel under jax.vmap
# ---------------------------------------------------------------------------
class _TripleRecorder:
    """Solver backend that records each triple solve's operands."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def solve_triple(self, *args):
        self.calls.append(args)
        return self.inner.solve_triple(*args)


@pytest.fixture(scope="module")
def ladder_triple():
    """The K4 operands of step 1 of the fused batched pol ladder (levels=3,
    three 9 x 9 systems, each level's own dt), as ``kernels.triple_solve``
    takes them, and the Krylov budget."""
    from na_dd_tpu_torch.harness.batched_ladder import build_spatial_ladder_batched
    from na_dd_tpu_torch.integrators.pc_trapezoidal import _batch_shape
    from na_dd_tpu_torch.ops.linsolve import jacobi_from_diag

    build = build_spatial_ladder_batched("pol", levels=3, coupling_source="analytic", device="cpu")
    integ = build["integrator"]
    rec = integ.solver = _TripleRecorder(integ.solver)
    integ.step_fn(build["grid"], BATCHED_OPS, build["state"], torch.zeros_like(build["dt"]),
                  build["dt"])
    integ.solver = rec.inner
    assert len(rec.calls) == 1
    *stencils, d, rhs_T, base_cl, base_cd, mask, dt, _noise = rec.calls[0]
    (J_T, J_cl, J_cd, C_clT, C_cdT), (d, rhs_T, base_cl, base_cd, mask) = _batch_shape(
        stencils, (d, rhs_T, base_cl, base_cd, mask))
    invs = tuple(jacobi_from_diag(J.c0, mask) for J in (J_T, J_cl, J_cd))
    operands = (J_T, J_cl, J_cd, C_clT, C_cdT, d, rhs_T, base_cl, base_cd, *invs, mask, dt)
    return operands, rec.inner.iters


def _to_jax(operands):
    import jax.numpy as jnp

    def conv(t):
        if isinstance(t, tuple):
            return tuple(conv(c) for c in t)
        return jnp.asarray(t.numpy())

    *planes, dt = operands
    return [conv(tuple(t)) if isinstance(t, tuple) else conv(t) for t in planes], \
        jnp.asarray(dt.reshape(-1).numpy())


def test_batched_plain_triple_solve_matches_jax_vmap(ladder_triple):
    """The plain batched K4 against ``jax.vmap`` of the TPU kernel in
    interpret mode on the ladder's step-1 stack: every increment of every
    system to 1e-12 of the system's max-norm, the (B, 3) iteration counts
    equal; and each system of the batch against the unbatched plain K4 on it
    alone (equal counts, increments to 1e-15)."""
    from na_dd_tpu.ops.pallas_kernels import triple_solve_pallas

    operands, iters = ladder_triple
    tol = 1e-13
    *xs, info = kernels.triple_solve(*operands, tol=tol, iters=iters)
    planes, dt = _to_jax(operands)
    *jxs, jinfo = jax.vmap(
        lambda *a: triple_solve_pallas(*a, tol=tol, iters=iters, interpret=True)
    )(*planes, dt)
    assert info["iters"].shape == tuple(jinfo["iters"].shape) == (3, 3)
    np.testing.assert_array_equal(info["iters"].numpy(), np.asarray(jinfo["iters"]))
    np.testing.assert_array_equal(info["converged"].numpy(), np.asarray(jinfo["converged"]))
    assert int(info["iters"].sum()) > 0
    for x, jx in zip(xs, jxs):
        jx = np.asarray(jx)
        for k in range(3):
            scale = max(float(np.abs(jx[k]).max()), 1e-300)
            assert float(np.abs(x[k].numpy() - jx[k]).max()) <= 1e-12 * scale
    for k in range(3):
        one = tuple(type(t)(*(c[k] for c in t)) if isinstance(t, tuple) else t[k]
                    for t in operands)
        *xk, info_k = kernels.triple_solve(*one, tol=tol, iters=iters)
        assert info_k["iters"].tolist() == info["iters"][k].tolist()
        for x, x1 in zip(xs, xk):
            scale = max(float(x1.abs().max()), 1e-300)
            assert float((x[k] - x1).abs().max()) <= 1e-15 * scale


# ---------------------------------------------------------------------------
# the batched entry points against the JAX package and the serial port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ladder():
    return (
        j_bl.run_spatial_ladder_batched("pol", levels=3, verbose=False),
        run_spatial_ladder_batched("pol", levels=3, verbose=False, device="cpu"),
        run_spatial_study("pol", levels=3, verbose=False, device="cpu"),
    )


def test_spatial_ladder_batched_matches_jax_and_serial(ladder):
    jax_res, port, serial = ladder
    assert port["Ns"] == jax_res["Ns"] == serial["Ns"] == [2, 4, 8]
    assert port["kind"] == jax_res["kind"] and port["krylov_unroll"] == jax_res["krylov_unroll"]
    assert set(port) >= set(jax_res)
    for e_p, e_j, e_s in zip(port["errors"], jax_res["errors"], serial["errors"]):
        assert _rel(e_p, e_j) <= 1e-10
        assert _rel(e_p, e_s) <= 1e-10


@pytest.fixture(scope="module")
def eta_sweep():
    return (
        j_run_eta_study_batched("pol", verbose=False, **ETA_KW),
        run_eta_study_batched("pol", verbose=False, device="cpu", **ETA_KW),
        run_eta_study("pol", verbose=False, device="cpu", **ETA_KW),
    )


def test_eta_study_batched_matches_jax_and_serial(eta_sweep):
    jax_res, port, serial = eta_sweep
    assert port["etas"] == jax_res["etas"] == ETA_KW["etas"]
    assert port["dt"] == jax_res["dt"] and set(port) == set(jax_res)
    for e_p, e_j, e_s in zip(port["errors"], jax_res["errors"], serial["errors"]):
        assert _rel(e_p, e_j) <= 1e-10
        assert _rel(e_p, e_s) <= 1e-12


def test_spatial_ladder3_batched_matches_jax_and_serial(model3):
    j_model, t_model = model3
    jax_res = j_bl3.run_spatial_ladder3_batched(JCase3, model=j_model, levels=2, base_N=4,
                                                verbose=False)
    port = run_spatial_ladder3_batched(MMSCaseExpSin3, model=t_model, levels=2, base_N=4,
                                       verbose=False, device="cpu")
    assert port["Ns"] == jax_res["Ns"] == [4, 8] and all(port["converged"])
    assert set(port) == set(jax_res)
    for k, (N, e_p, e_j) in enumerate(zip(port["Ns"], port["errors"], jax_res["errors"])):
        assert _rel(e_p, e_j) <= 1e-10
        e_s = mms_error3(MMSCaseExpSin3, N=N, model=t_model, Tf=0.02, dt=1e-2 / 2**k,
                         integrator_params=dict(num_newton_steps=2), device="cpu")
        assert _rel(e_p, e_s) <= 1e-12


def test_eta_sweep3_matches_jax_and_serial(model3):
    j_model, t_model = model3
    jax_res = j_run_eta_sweep3(JCase3, model=j_model, **SWEEP3_KW)
    port = run_eta_sweep3(MMSCaseExpSin3, model=t_model, device="cpu", **SWEEP3_KW)
    assert port["etas"] == jax_res["etas"] and port["converged"] == jax_res["converged"] == [True] * 2
    for eta, e_p, e_j in zip(port["etas"], port["errors"], jax_res["errors"]):
        assert _rel(e_p, e_j) <= 1e-10
        e_s = mms_error3(MMSCaseExpSin3, N=SWEEP3_KW["N"], model=t_model, Tf=SWEEP3_KW["Tf"],
                         dt=SWEEP3_KW["dt"], eta=eta, device="cpu")
        assert _rel(e_p, e_s) <= 1e-12


def test_spatial_ladder_batched_mixed_matches_jax_and_f64(ladder, monkeypatch):
    """The 2-D ladder with ``precision="mixed"`` (a keyword here; the JAX
    function reads NA_DD_TPU_PRECISION) against the JAX mixed ladder and the
    port's float64 batched ladder."""
    monkeypatch.setenv("NA_DD_TPU_PRECISION", "mixed")
    jax_res = j_bl.run_spatial_ladder_batched("pol", levels=3, verbose=False)
    port = run_spatial_ladder_batched("pol", levels=3, verbose=False, device="cpu",
                                      precision="mixed")
    f64 = ladder[1]
    assert port["Ns"] == jax_res["Ns"] == [2, 4, 8]
    for e_p, e_j, e_f in zip(port["errors"], jax_res["errors"], f64["errors"]):
        assert _rel(e_p, e_j) <= 1e-10
        assert _rel(e_p, e_f) <= 1e-12


def test_spatial_ladder3_batched_mixed_matches_jax_and_f64(model3):
    """The 3-D ladder with ``precision="mixed"`` against the JAX mixed ladder
    (1e-10) and the JAX package's CPU-x64 float64 levels (1e-12)."""
    j_model, t_model = model3
    jax_res = j_bl3.run_spatial_ladder3_batched(JCase3, model=j_model, levels=2, base_N=4,
                                                verbose=False, precision="mixed")
    port = run_spatial_ladder3_batched(MMSCaseExpSin3, model=t_model, levels=2, base_N=4,
                                       verbose=False, precision="mixed", device="cpu")
    assert port["Ns"] == jax_res["Ns"] == [4, 8] and all(port["converged"])
    for N, e_p, e_j in zip(port["Ns"], port["errors"], jax_res["errors"]):
        assert _rel(e_p, e_j) <= 1e-10
        assert _rel(e_p, THREE_D_CPU_X64[N]) <= 1e-12


def test_mixed_backend_verdicts_are_per_system():
    """A batched mixed solve reports one verdict and one iteration count a
    system, (B, 1, 1) and (B,), each the unbatched solve's."""
    from na_dd_tpu_torch.integrators.pc_trapezoidal import MixedBackend

    rng = np.random.default_rng(92)
    shape = (9, 8)
    mask = np.zeros(shape)
    mask[1:-1, 1:-1] = 1.0
    m = torch.as_tensor(mask)
    sh = (LOCAL_OPS.shift_xm, LOCAL_OPS.shift_xp, LOCAL_OPS.shift_ym, LOCAL_OPS.shift_yp)
    systems = []
    for _ in range(3):
        c0 = (rng.random(shape) + 4.0) * mask
        offs = [0.5 * rng.random(shape) * mask * f(m).numpy() for f in sh]
        systems.append(([c0, *offs], rng.random(shape) * mask))
    backend = MixedBackend(iters=16)
    st = stencil5_from_numpy([np.stack([p[k] for p, _ in systems]) for k in range(5)], device="cpu")
    b = tensor_from_numpy(np.stack([r for _, r in systems]), device="cpu")
    x, info = backend.solve(st, b, m)
    assert info["converged"].shape == (3, 1, 1) and info["iters"].shape == (3,)
    for k, (planes, rhs) in enumerate(systems):
        xk, info_k = backend.solve(stencil5_from_numpy(planes, device="cpu"),
                                   tensor_from_numpy(rhs, device="cpu"), m)
        assert torch.allclose(x[k], xk, rtol=1e-13, atol=0.0)
        assert int(info["iters"][k]) == int(info_k["iters"]) and bool(info["converged"][k])


# ---------------------------------------------------------------------------
# the fused analytic batched entry points (batched K4) against the JAX
# package's, whose vmapped sweep runs the TPU kernel in interpret mode
# ---------------------------------------------------------------------------
FUSED_ETA_KW = dict(N=8, dt=2e-3)


def _jax_fused_env(monkeypatch, precision="full"):
    monkeypatch.setenv("NA_DD_TPU_COUPLING", "analytic")
    monkeypatch.setenv("NA_DD_TPU_STENCIL", "pallas")
    monkeypatch.setenv("NA_DD_TPU_PRECISION", precision)


def test_fused_spatial_ladder_batched_matches_jax(ladder, monkeypatch):
    """``coupling_source="analytic"`` on the batched ladder (one batched K4 a
    Newton sweep) against the JAX ladder under NA_DD_TPU_COUPLING=analytic
    (``krylov_scanned=False``, which its fused branch needs): each level to
    1e-10, and to the port's jvp-route batched ladder to 1e-10."""
    _jax_fused_env(monkeypatch)
    jax_res = j_bl.run_spatial_ladder_batched("pol", levels=3, verbose=False, krylov_scanned=False)
    port = run_spatial_ladder_batched("pol", levels=3, verbose=False, device="cpu",
                                      coupling_source="analytic")
    assert port["Ns"] == jax_res["Ns"] == [2, 4, 8]
    for e_p, e_j, e_jvp in zip(port["errors"], jax_res["errors"], ladder[1]["errors"]):
        assert _rel(e_p, e_j) <= 1e-10
        assert _rel(e_p, e_jvp) <= 1e-10


@pytest.mark.parametrize("precision", ["full", "mixed"])
def test_fused_eta_study_batched_matches_jax(precision, monkeypatch):
    """The η sweep with analytic couplings (one batched K4 a sweep for all η;
    in "mixed" the float32 K4 under per-η block refinement) against the JAX
    sweep under the same environment: each η to 1e-10; the mixed sweep also
    to the port's float64 fused sweep to 1e-12."""
    _jax_fused_env(monkeypatch, precision)
    jax_res = j_run_eta_study_batched("pol", verbose=False, **FUSED_ETA_KW)
    port = run_eta_study_batched("pol", verbose=False, device="cpu", precision=precision,
                                 coupling_source="analytic", **FUSED_ETA_KW)
    assert port["etas"] == jax_res["etas"] and len(port["etas"]) == 7
    for e_p, e_j in zip(port["errors"], jax_res["errors"]):
        assert _rel(e_p, e_j) <= 1e-10
    if precision == "mixed":
        f64 = run_eta_study_batched("pol", verbose=False, device="cpu",
                                    coupling_source="analytic", **FUSED_ETA_KW)
        for e_p, e_f in zip(port["errors"], f64["errors"]):
            assert _rel(e_p, e_f) <= 1e-12


def test_eta_study_batched_splits_past_the_batch_limit(monkeypatch):
    """More η than one launch takes (33 > ``kernels.MAX_BATCH``): the fused
    analytic sweep runs them as consecutive batches of at most 32, each η
    within 1e-10 of the JAX sweep (one vmap of all 33).  The wrapper still
    refuses 33 systems in one launch
    (``test_triple_solve_takes_a_stack_up_to_the_batch_limit``)."""
    etas = [float(e) for e in np.geomspace(10.0, 1000.0, 33)]
    kw = dict(N=8, dt=5e-3, Tf=0.01, etas=etas)
    _jax_fused_env(monkeypatch)
    jax_res = j_run_eta_study_batched("pol", verbose=False, **kw)
    sweep_kw = dict(coupling_source="analytic", device="cpu", **kw)
    port = run_eta_study_batched("pol", verbose=False, **sweep_kw)
    assert port["etas"] == jax_res["etas"] == etas
    for e_p, e_j in zip(port["errors"], jax_res["errors"]):
        assert _rel(e_p, e_j) <= 1e-10
    from na_dd_tpu_torch.harness.studies import build_eta_study_batched

    sweep = build_eta_study_batched("pol", **sweep_kw)
    assert [len(p["etas"]) for p in sweep["parts"]] == [kernels.MAX_BATCH, 1]
    assert sweep["state"].T.shape[0] == kernels.MAX_BATCH


# ---------------------------------------------------------------------------
# precision="df" on the batch axis: the double-float step of every system in
# one batch, its solves one batched launch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("coupling_source", ["jvp", "analytic"])
def test_spatial_ladder_batched_df_matches_serial_df(coupling_source):
    """The 2-D ladder with ``precision="df"`` (df always takes the analytic
    couplings; "analytic" is the fused batched K4 route, "jvp" the per-solve
    batched K1 one) against the port's serial df levels, ≤1e-12."""
    port = run_spatial_ladder_batched("pol", levels=3, verbose=False, device="cpu",
                                      precision="df", coupling_source=coupling_source)
    serial = run_spatial_study("pol", levels=3, verbose=False, device="cpu", precision="df")
    assert port["Ns"] == serial["Ns"] == [2, 4, 8]
    for e_p, e_s in zip(port["errors"], serial["errors"]):
        assert _rel(e_p, e_s) <= 1e-12


def test_eta_study_batched_df_matches_serial_df():
    port = run_eta_study_batched("pol", verbose=False, device="cpu", precision="df",
                                 coupling_source="analytic", **ETA_KW)
    serial = run_eta_study("pol", verbose=False, device="cpu", precision="df", **ETA_KW)
    for e_p, e_s in zip(port["errors"], serial["errors"]):
        assert _rel(e_p, e_s) <= 1e-12


def test_spatial_ladder3_batched_df_matches_serial_df(model3):
    """The 3-D ladder with ``precision="df"`` (batched K5 a solve; Tf = 0.01,
    one and two steps) against the port's serial 3-D df levels, ≤1e-12."""
    _, t_model = model3
    port = run_spatial_ladder3_batched(MMSCaseExpSin3, model=t_model, levels=2, base_N=4,
                                       Tf=0.01, verbose=False, precision="df", device="cpu")
    assert port["Ns"] == [4, 8] and all(port["converged"])
    for k, (N, e_p) in enumerate(zip(port["Ns"], port["errors"])):
        e_s = mms_error3(MMSCaseExpSin3, N=N, model=t_model, Tf=0.01, dt=1e-2 / 2**k,
                         integrator_params=dict(num_newton_steps=2, precision="df"),
                         device="cpu")
        assert _rel(e_p, e_s) <= 1e-12
