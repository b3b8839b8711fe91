"""The port's parallel layer (``na_dd_tpu_torch.parallel``) on gloo CPU
ranks, held to the JAX package's sharded path on the CPU.

Two module-scoped worlds of 4 ranks run every check once
(``tests/torch_parallel_ranks.py`` holds their bodies): a (4,) x mesh, and a
(2, 2) mesh.  The JAX references run here on 4 of conftest's 8 virtual
devices: ``HaloOps`` under ``shard_map``, ``build_sharded_step`` /
``build_sharded_simulation`` on the same mesh shapes, and the local steps
(which the JAX package's own tests hold equal to its sharded ones) for
``mixed``, ``direct`` and the 3-D paths.  The port's local steps run here
too.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as R
from na_dd_tpu.core import FieldRegHCsTriple as JField, MMSForcingRegHCsTriple as JForcing
from na_dd_tpu.core import State as JState
from na_dd_tpu.integrators import PCTrapezoidalRegHCsTriple as JInteg
from na_dd_tpu.mms import state_from_mms_when as j_state_from_mms_when
from na_dd_tpu.mms.cases import MMSCasePol as JMMSCasePol
from na_dd_tpu.models import Model02 as JModel02, default_model_consts as j_consts
from na_dd_tpu.ops import LOCAL_OPS as J_LOCAL_OPS, make_grid as j_make_grid
from na_dd_tpu.parallel import HaloOps as JHaloOps
from na_dd_tpu.parallel import build_sharded_simulation as j_build_sharded_simulation
from na_dd_tpu.parallel import build_sharded_step as j_build_sharded_step
from na_dd_tpu.parallel import make_mesh as j_make_mesh
from na_dd_tpu.parallel import shard_grid_and_state as j_shard_grid_and_state
from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.harness.checkpoint import load_state_sharded
from na_dd_tpu_torch.harness.ensemble import simulate_ensemble
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS
from na_dd_tpu_torch.ops import kernels
from na_dd_tpu_torch.parallel import dryrun_multichip, run_ranks
from na_dd_tpu_torch.three_d.harness import run_trial3
from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

FIELDS = ("cp", "T", "cl", "cd", "cs")
WORLD_TIMEOUT_S = 300.0


def _np(v):
    return np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(_np(a) - _np(b))))


# ---------------------------------------------------------------------------
# the two worlds
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def xmesh():
    return run_ranks(R.xmesh_world, 4, backend="gloo", device="cpu", timeout_s=WORLD_TIMEOUT_S)[0]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded_ckpt"))


@pytest.fixture(scope="module")
def mesh22_ranks(ckpt_dir):
    return run_ranks(R.mesh22_world, 4, backend="gloo", device="cpu", args=(ckpt_dir,),
                     timeout_s=WORLD_TIMEOUT_S)


@pytest.fixture(scope="module")
def mesh22(mesh22_ranks):
    return mesh22_ranks[0]


# ---------------------------------------------------------------------------
# JAX references
# ---------------------------------------------------------------------------
def _jax_pol(N, **kw):
    g = j_make_grid(np.linspace(0, 1, N + 1), np.linspace(0, 1, N + 1))
    model = JModel02(j_consts)
    mms = JMMSCasePol(g, model=model)
    forcing = JForcing(mms_case=mms, model=model, regularization_factor=50.0)
    field = JField(grid=g, model=model, forcing=forcing, regularization_factor=50.0)
    integ = JInteg(field, regularization_factor=50.0, **kw)
    return g, mms, integ, j_state_from_mms_when(mms_case=mms, t=0.0, grid=g)


def _jax_mesh(shape):
    names = ("x", "y") if len(shape) == 2 else ("x",)
    return j_make_mesh(shape, names, devices=jax.devices()[:4])


HALO_LAYOUTS = {
    "x": ((4,), ("x",), dict(axis_x="x", nx=4)),
    "y": ((4,), ("y",), dict(axis_y="y", ny=4)),
    "xy": ((2, 2), ("x", "y"), dict(axis_x="x", nx=2, axis_y="y", ny=2)),
}


@pytest.fixture(scope="module")
def jax_halo():
    """JAX HaloOps under shard_map on each layout: the four shifts,
    asum(u²) and amax(u)."""
    u = jnp.asarray(R.halo_inputs().numpy())
    out = {}
    for key, (shape, names, fields) in HALO_LAYOUTS.items():
        mesh = j_make_mesh(shape, names, devices=jax.devices()[:4])
        spec = P(fields.get("axis_x"), fields.get("axis_y"))
        hops = JHaloOps(**fields)

        def f(v, hops=hops):
            return (hops.shift_xm(v), hops.shift_xp(v), hops.shift_ym(v), hops.shift_yp(v),
                    hops.asum(v * v), hops.amax(v))

        sharded = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(spec,),
                                        out_specs=(spec,) * 4 + (P(), P()), check_vma=False))
        out[key] = sharded(jax.device_put(u, NamedSharding(mesh, spec)))
    return u, out


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX build_sharded_step on (4,) and (2, 2), and the 2-step
    build_sharded_simulation on (4,), pol N=15 with two Newton sweeps."""
    g, mms, integ, s0 = _jax_pol(15, num_newton_steps=2)
    out = {}
    for key, shape in (("x", (4,)), ("xy", (2, 2))):
        mesh = _jax_mesh(shape)
        ay = "y" if len(shape) == 2 else None
        gs, ss = j_shard_grid_and_state(mesh, g, s0, axis_x="x", axis_y=ay)
        out[key] = j_build_sharded_step(integ, mesh, axis_x="x", axis_y=ay)(gs, ss, 0.0, 1e-3)
    mesh = _jax_mesh((4,))
    gs, ss = j_shard_grid_and_state(mesh, g, s0)
    out["sim"] = j_build_sharded_simulation(integ, mesh, mms_case=mms, num_steps=2, t0=0.0,
                                            dt=1e-3)(gs, ss)
    return out


@pytest.fixture(scope="module")
def jax_local():
    """The JAX package's local steps of the mixed, direct and 3-D cases
    (and two 3-D steps), on the CPU."""
    from na_dd_tpu.three_d import (
        LOCAL_OPS3 as J_LOCAL_OPS3, MMSCaseExpSin3 as JExpSin3, make_setup3 as j_make_setup3,
        make_uniform_grid3 as j_make_uniform_grid3, state_from_mms_when3 as j_state3,
    )

    out = {}
    for key, N, kw in (("mixed", 15, dict(precision="mixed", krylov_unroll=8)),
                       ("direct", 7, dict(linear_solver="direct", num_newton_steps=2))):
        g, _mms, integ, s0 = _jax_pol(N, **kw)
        out[key] = jax.jit(integ.step_fn, static_argnums=1)(g, J_LOCAL_OPS, s0, 0.0, 1e-3)[0]
    for key, kw in (("step3", dict(krylov_unroll=24)), ("direct3", dict(linear_solver="direct"))):
        g3, case3, _f, integ3 = j_make_setup3(
            JExpSin3, model=JModel02(j_consts), grid=j_make_uniform_grid3(*R.GRID3),
            integrator_params=kw)
        s03 = j_state3(mms_case=case3, t=0.0, grid=g3)
        out[key] = integ3.step_fn(g3, J_LOCAL_OPS3, s03, 0.0, 1e-3)[0]
        if key == "step3":
            out["sim3"] = integ3.step_fn(g3, J_LOCAL_OPS3, out[key], 1e-3, 1e-3)[0]
    return out


# ---------------------------------------------------------------------------
# the port's local references
# ---------------------------------------------------------------------------
def _port_local_step(N, **kw):
    g, _mms, integ, s0 = R.build_pol(N, "cpu", **kw)
    return integ.step_fn(g, LOCAL_OPS, s0, torch.zeros((), dtype=g.dtype), 1e-3)


def _port_local3(**kw):
    g3, case3, integ3, s03 = R.build_expsin3("cpu", **kw)
    return g3, case3, integ3, s03


# ---------------------------------------------------------------------------
# halos
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", sorted(HALO_LAYOUTS))
def test_halo_shifts_and_reductions_match_local_and_jax(layout, xmesh, mesh22, jax_halo):
    got = {"x": xmesh["halo_x"], "y": xmesh["halo_y"], "xy": mesh22["halo_xy"]}[layout]
    u = R.halo_inputs()
    local = [LOCAL_OPS.shift_xm(u), LOCAL_OPS.shift_xp(u), LOCAL_OPS.shift_ym(u),
             LOCAL_OPS.shift_yp(u)]
    _u_jax, jout = jax_halo
    for k, (port, ref) in enumerate(zip(got["shifts"], local)):
        assert torch.equal(port, ref), f"shift {k}"
        np.testing.assert_array_equal(port.numpy(), np.asarray(jout[layout][k]))
    assert torch.equal(got["gather"], u)
    # reductions: the order of the partial sums only
    assert float(got["asum"]) == pytest.approx(float(torch.sum(u * u)), rel=1e-14)
    assert float(got["asum"]) == pytest.approx(float(jout[layout][4]), rel=1e-14)
    assert float(got["amax"]) == float(torch.amax(u)) == float(jout[layout][5])


# ---------------------------------------------------------------------------
# 2-D step and simulation against the JAX package's sharded step and simulation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["x", "xy"])
def test_sharded_step_matches_jax_sharded_step(layout, xmesh, mesh22, jax_sharded):
    got = (xmesh if layout == "x" else mesh22)["step"]
    j_state, j_small = jax_sharded[layout]
    for v in FIELDS:
        d = _max_abs(getattr(got["state"], v), getattr(j_state, v))
        assert d <= 1e-12, f"{v}: {d}"
    assert bool(got["small"]["hcs_ok"]) and bool(got["small"]["krylov_converged"])
    assert bool(j_small["krylov_converged"])
    # the all-reduced sums may flip one tolerance comparison
    assert abs(int(got["small"]["krylov_iters"]) - int(j_small["krylov_iters"])) <= 3


def test_sharded_step_matches_port_local_step(xmesh):
    local, diag = _port_local_step(15, num_newton_steps=2)
    for v in FIELDS:
        assert _max_abs(getattr(xmesh["step"]["state"], v), getattr(local, v)) <= 1e-12, v
    assert abs(int(xmesh["step"]["small"]["krylov_iters"]) - int(diag.krylov_iters)) <= 3
    stats = xmesh["step"]["stats"]
    assert stats["exchanges"] > 0 and stats["reductions"] > 0 and stats["staged_bytes"] == 0


def test_sharded_simulation_matches_jax_sharded_simulation(xmesh, jax_sharded):
    """The states to 1e-12; each error norm (the square root of each
    squared norm of ``_collect_errors``) to 1e-12 of itself or 1e-15
    absolute, the rounding floor of the O(1) state it is taken of: at this
    protocol (the JAX package's own) the errors are 2.5e-7 (cp) and ~3e-11
    (T, cl, cd, cs), so the order of the all-reduced sums alone moves cp's
    squared norm by ~2e-11 of itself and the others' by ~1e-7."""
    state, (h0, g0, (h_sq, grad_sq, small)) = xmesh["sim"]["state"], xmesh["sim"]["errors"]
    j_state, (jh0, jg0, (jh_sq, jg_sq, j_small)) = jax_sharded["sim"]
    for v in FIELDS:
        assert _max_abs(getattr(state, v), getattr(j_state, v)) <= 1e-12, v
        for port, ref in ((h0[v], jh0[v]), (g0[v], jg0[v]), (h_sq[v], jh_sq[v]),
                          (grad_sq[v], jg_sq[v])):
            e_port, e_ref = np.sqrt(_np(port)), np.sqrt(np.asarray(ref))
            assert np.all(np.abs(e_port - e_ref) <= 1e-12 * e_ref + 1e-15), (v, e_port, e_ref)
    assert bool(small["hcs_ok"].all()) and bool(np.all(np.asarray(j_small["hcs_ok"])))
    assert small["krylov_iters"].shape == (2,)


# ---------------------------------------------------------------------------
# mixed, direct and 3-D on 2 x 2 against the local steps
# ---------------------------------------------------------------------------
SHARDED_CASES = ("mixed", "direct", "step3", "direct3")


def _port_local(case):
    if case == "mixed":
        return _port_local_step(15, precision="mixed", krylov_unroll=8)[0]
    if case == "direct":
        return _port_local_step(7, linear_solver="direct", num_newton_steps=2)[0]
    kw = dict(krylov_unroll=24) if case == "step3" else dict(linear_solver="direct")
    g3, _case3, integ3, s03 = _port_local3(**kw)
    return integ3.step_fn(g3, LOCAL_OPS3, s03, torch.zeros((), dtype=g3.dtype), 1e-3)[0]


@pytest.mark.parametrize("case", SHARDED_CASES)
def test_sharded_case_matches_port_local_step(case, mesh22):
    local = _port_local(case)
    got = mesh22[case]["state"]
    for v in FIELDS:
        d = _max_abs(getattr(got, v), getattr(local, v))
        assert d <= 1e-12, f"{case} {v}: {d}"


@pytest.mark.parametrize("case", SHARDED_CASES)
def test_sharded_case_matches_jax_local_step(case, mesh22, jax_local):
    got = mesh22[case]["state"]
    for v in FIELDS:
        d = _max_abs(getattr(got, v), getattr(jax_local[case], v))
        assert d <= 1e-12, f"{case} {v}: {d}"
    if case in ("step3", "direct3"):
        assert bool(mesh22[case]["converged"])


def test_sharded_simulation3_matches_local(mesh22, jax_local):
    got = mesh22["sim3"]
    g3, case3, integ3, _s03 = _port_local3(krylov_unroll=24)
    local = run_trial3(g3, case3, integ3, Tf=2e-3, dt=1e-3)
    assert got["converged"] and local["krylov_converged"]
    assert got["error"] == pytest.approx(local["error"], rel=1e-12)
    for v in FIELDS:
        assert got["errors_final"][v] == pytest.approx(local["errors_final"][v], rel=1e-12)
        assert _max_abs(getattr(got["state"], v), getattr(local["state"], v)) <= 1e-12, v
        assert _max_abs(getattr(got["state"], v), getattr(jax_local["sim3"], v)) <= 1e-12, v


# ---------------------------------------------------------------------------
# distributed gradient, ensemble, checkpoint
# ---------------------------------------------------------------------------
def test_sharded_step_gradient_matches_local(xmesh):
    g, _mms, integ, s0 = R.build_pol(15, "cpu", krylov_unroll=8, differentiable=True)
    leaves = State(*(v.clone().requires_grad_(True) for v in s0))
    s1, _ = integ.step_fn(g, LOCAL_OPS, leaves, torch.zeros((), dtype=g.dtype), 1e-3)
    loss = torch.sum(s1.T * s1.T) + torch.sum(s1.cd)
    loss.backward()
    assert float(xmesh["loss"]) == pytest.approx(float(loss.detach()), rel=1e-13)
    for v in FIELDS:
        np.testing.assert_allclose(_np(getattr(xmesh["grad"], v)), _np(getattr(leaves, v).grad),
                                   rtol=1e-10, atol=1e-12, err_msg=v)


@pytest.fixture(scope="module")
def jax_grad():
    """``jax.grad`` of the distributed-gradient loss through the JAX
    package's local step, on the CPU (its own tests hold the sharded
    gradient equal to it)."""
    g, _mms, integ, s0 = _jax_pol(15, krylov_unroll=8, differentiable=True)

    def loss(s):
        s1, _d = integ.step_fn(g, J_LOCAL_OPS, s, 0.0, 1e-3)
        return jnp.sum(s1.T * s1.T) + jnp.sum(s1.cd)

    return jax.jit(jax.value_and_grad(loss))(s0)


def test_sharded_step_gradient_matches_jax_grad(xmesh, jax_grad):
    value, grads = jax_grad
    assert float(xmesh["loss"]) == pytest.approx(float(value), rel=1e-13)
    for v in FIELDS:
        np.testing.assert_allclose(_np(getattr(xmesh["grad"], v)), np.asarray(getattr(grads, v)),
                                   rtol=1e-10, atol=1e-12, err_msg=v)


@pytest.fixture(scope="module")
def ensemble_dp1():
    return simulate_ensemble(device="cpu", **R.ENSEMBLE)


@pytest.fixture(scope="module")
def jax_ensemble():
    """The JAX study's ensemble (``studies/ensemble_throughput.py``'s
    ``jax.vmap(simulate_one)``) at the test's size: the RegHCs step loop on
    the local ops with the study's Krylov budget and no residual tracking,
    one member a regularization factor."""
    import math

    from na_dd_tpu.harness.studies import STUDIES, _study_unroll, study_consts
    from na_dd_tpu.ops import make_uniform_grid as j_make_uniform_grid

    cfg, mc = STUDIES[R.ENSEMBLE["study"]], study_consts(R.ENSEMBLE["study"])
    N = R.ENSEMBLE["N"]
    grid = j_make_uniform_grid(N, N)
    model = JModel02(mc)
    case = cfg["case_cls"](grid=grid, model=model)
    s0 = j_state_from_mms_when(mms_case=case, t=0.0, grid=grid)
    num_steps = math.ceil(R.ENSEMBLE["Tf"] / R.ENSEMBLE["dt"])
    dt = R.ENSEMBLE["Tf"] / num_steps
    unroll = _study_unroll(cfg, N, dt, mc)

    def simulate_one(eta):
        forcing = JForcing(mms_case=case, model=model, regularization_factor=eta)
        field = JField(grid=grid, model=model, forcing=forcing, regularization_factor=eta)
        integ = JInteg(field, regularization_factor=eta, track_residuals=False,
                       krylov_unroll=unroll)

        def body(s, k):
            return integ.step_fn(grid, J_LOCAL_OPS, s, k * dt, dt)[0], None

        return jax.lax.scan(body, s0, jnp.arange(num_steps, dtype=jnp.float64))[0]

    return jax.jit(jax.vmap(simulate_one))(jnp.asarray(R.ENSEMBLE["etas"]))


def test_ensemble_matches_jax_vmap(ensemble_dp1, jax_ensemble):
    s_one, _it = ensemble_dp1
    for v in FIELDS:
        d = _max_abs(getattr(s_one, v), getattr(jax_ensemble, v))
        assert d <= 1e-12, f"{v}: {d}"


#: the JAX study's JSON keys, and each batch size's
JAX_ENSEMBLE_KEYS = {"study", "N", "Tf", "dt", "num_steps", "x64", "backend", "dp",
                     "krylov_unroll", "batches", "timestamp"}
JAX_BATCH_KEYS = {"batch_s", "first_s", "sims_per_s", "per_sim_s", "efficiency_vs_B1"}


def test_ensemble_throughput_cli_matches_jax_vmap(tmp_path, jax_ensemble):
    """``ensemble_throughput.main`` at the test's size, B = 1 and 8, in one
    process and over 2 gloo CPU ranks: each member's final-field H-norms² ≤1e-12
    relative to the JAX study's ``vmap(simulate_one)`` (B=1's member is eta=20,
    the first of B=8's), dp=2 bit for bit dp=0, the JAX study's keys plus
    ``final_norms`` and ``device``."""
    import json

    from na_dd_tpu.ops import make_uniform_grid as j_make_uniform_grid
    from na_dd_tpu.ops.inner_products import inner_H as j_inner_H
    from na_dd_tpu_torch.studies import ensemble_throughput

    args = ["--n", str(R.ENSEMBLE["N"]), "--tf", repr(R.ENSEMBLE["Tf"]), "--dt",
            repr(R.ENSEMBLE["dt"]), "--batches", "1,8", "--device", "cpu"]
    assert ensemble_throughput.main([*args, "--out", str(tmp_path / "dp0.json")]) == 0
    assert ensemble_throughput.main([*args, "--dp", "2", "--out", str(tmp_path / "dp2.json")]) == 0
    dp0, dp2 = (json.loads((tmp_path / f"{n}.json").read_text()) for n in ("dp0", "dp2"))
    jg = j_make_uniform_grid(R.ENSEMBLE["N"], R.ENSEMBLE["N"])
    ref = np.asarray([[float(j_inner_H(J_LOCAL_OPS, jg, getattr(jax_ensemble, v)[m],
                                       getattr(jax_ensemble, v)[m])) for v in FIELDS]
                      for m in range(len(R.ENSEMBLE["etas"]))])
    assert set(dp0) == set(dp2) == JAX_ENSEMBLE_KEYS | {"device"}
    assert (dp0["dp"], dp2["dp"], dp0["device"]) == (0, 2, "cpu")
    for B in (1, 8):
        row = dp0["batches"][str(B)]
        assert set(row) == JAX_BATCH_KEYS | {"final_norms"}
        np.testing.assert_allclose(np.asarray(row["final_norms"]), ref[:B], rtol=1e-12, atol=0)
        assert dp2["batches"][str(B)]["final_norms"] == row["final_norms"]


def test_ensemble_runs_in_parts_of_one_launch(ensemble_dp1):
    """More members than one batched K1 launch holds run as parts of
    ``kernels.MAX_BATCH``; each member equals its run in a batch of its
    own part's size elsewhere."""
    kw = dict(R.ENSEMBLE, N=7, Tf=1e-3)
    etas = np.linspace(20.0, 200.0, kernels.MAX_BATCH + 2).tolist()
    s_all, it_all = simulate_ensemble(**dict(kw, etas=etas), device="cpu")
    assert s_all.T.shape == (kernels.MAX_BATCH + 2, 8, 8)
    for sl in (slice(0, 2), slice(kernels.MAX_BATCH, None)):
        s_k, it_k = simulate_ensemble(**dict(kw, etas=etas[sl]), device="cpu")
        for v in FIELDS:
            assert _max_abs(getattr(s_all, v)[sl], getattr(s_k, v)) <= 1e-13, v
        assert torch.equal(it_all[sl], it_k)


def test_dryrun_multichip_passes_on_cpu_ranks():
    assert dryrun_multichip(4, device="cpu", backend="gloo", timeout_s=WORLD_TIMEOUT_S) is None


def test_data_parallel_ensemble_matches_dp1(xmesh, ensemble_dp1):
    s_dp, it_dp = xmesh["ensemble"]
    s_one, it_one = ensemble_dp1
    assert s_dp.T.shape == (8, 16, 16)
    for v in FIELDS:
        assert _max_abs(getattr(s_dp, v), getattr(s_one, v)) <= 1e-13, v
    assert torch.equal(it_dp, it_one)


def test_checkpoint_reshards_to_two_ranks(mesh22, mesh22_ranks):
    full = mesh22["step"]["state"]
    for rank in (0, 1):
        ck = mesh22_ranks[rank]["ckpt2"]
        assert (ck["t"], ck["step"]) == (1e-3, 1)
        for v in FIELDS:
            rows = getattr(full, v)[8 * rank:8 * (rank + 1)]
            assert torch.equal(getattr(ck["block"], v), rows), (rank, v)


def test_checkpoint_restores_whole_on_one_rank(mesh22, ckpt_dir):
    state, t, step = load_state_sharded(ckpt_dir, device="cpu")
    assert (t, step) == (1e-3, 1)
    for v in FIELDS:
        assert torch.equal(getattr(state, v), getattr(mesh22["step"]["state"], v)), v


def test_checkpoint_equals_orbax_readout(mesh22, ckpt_dir, tmp_path):
    """The global state the port wrote as 4 blocks, written by the JAX
    package's orbax pair and read back by orbax, equals the port's restored
    state bit for bit."""
    from na_dd_tpu.harness.checkpoint import load_state_orbax, save_state_orbax

    state, t, step = load_state_sharded(ckpt_dir, device="cpu")
    j_state = JState(*(jnp.asarray(getattr(mesh22["step"]["state"], v).numpy()) for v in FIELDS))
    path = save_state_orbax(str(tmp_path / "orbax"), j_state, t=1e-3, step=1)
    restored, jt, jstep = load_state_orbax(path, like=j_state)
    assert (float(jt), int(jstep)) == (t, step)
    for v in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(restored, v)), getattr(state, v).numpy())


# ---------------------------------------------------------------------------
# run_ranks and the ops dispatch
# ---------------------------------------------------------------------------
def test_a_raising_rank_makes_run_ranks_raise():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(R.raising_world, 2, backend="gloo", device="cpu", timeout_s=120.0)


def test_a_hung_world_times_out():
    with pytest.raises(TimeoutError):
        run_ranks(R.hanging_world, 2, backend="gloo", device="cpu", timeout_s=10.0)


def test_nccl_world_larger_than_the_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks need 2 cards"):
        run_ranks(R.raising_world, 2, backend="nccl", device="cuda")


@pytest.mark.parametrize("kw", [dict(backend="mpi", device="cpu"), dict(backend="nccl",
                                                                         device="cpu")])
def test_run_ranks_refuses_what_it_cannot_run(kw):
    with pytest.raises(ValueError):
        run_ranks(R.raising_world, 2, **kw)


def test_run_ranks_refuses_the_card_when_there_is_none(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks(R.raising_world, 2, backend="gloo")


def test_local_ops_are_not_sharded():
    from na_dd_tpu_torch.ops.shifts import BATCHED_OPS
    from na_dd_tpu_torch.three_d.shifts import BATCHED_OPS3

    assert not any(o.sharded for o in (LOCAL_OPS, BATCHED_OPS, LOCAL_OPS3, BATCHED_OPS3))
