"""Rank bodies of ``tests/test_torch_parallel.py``: each runs on every rank of
a gloo process group (``run_ranks`` spawns them by import path, so they live
in a module that imports no JAX) and returns what the tests compare, the
global arrays gathered on rank 0.  Everything is on the CPU at small sizes."""

from __future__ import annotations

import numpy as np
import torch

from na_dd_tpu_torch.core.state import State

STEP = dict(t0=0.0, dt=1e-3)
ENSEMBLE = dict(etas=np.linspace(20.0, 200.0, 8).tolist(), study="pol", N=15, Tf=2e-3, dt=1e-3)
GRID3 = (7, 7, 6)


def build_pol(N, device, **integrator_kw):
    """The JAX parallel tests' setup: pol case, default model constants,
    RegHCs at η = 50."""
    from na_dd_tpu_torch.core.fields import FieldRegHCsTriple
    from na_dd_tpu_torch.core.forcing import MMSForcingRegHCsTriple
    from na_dd_tpu_torch.integrators.pc_trapezoidal import PCTrapezoidalRegHCsTriple
    from na_dd_tpu_torch.mms.cases import MMSCasePol
    from na_dd_tpu_torch.mms.engine import state_from_mms_when
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.ops.grid import make_uniform_grid

    g = make_uniform_grid(N, N, device=device)
    model = Model02(default_model_consts)
    mms = MMSCasePol(g, model=model)
    forcing = MMSForcingRegHCsTriple(mms_case=mms, model=model, regularization_factor=50.0)
    field = FieldRegHCsTriple(grid=g, model=model, forcing=forcing, regularization_factor=50.0)
    integ = PCTrapezoidalRegHCsTriple(field, regularization_factor=50.0, **integrator_kw)
    return g, mms, integ, state_from_mms_when(mms_case=mms, t=0.0, grid=g)


def build_expsin3(device, **integrator_kw):
    """The JAX 3-D sharded tests' setup: ExpSin3 on a 7 x 7 x 6 grid."""
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.three_d import MMSCaseExpSin3, make_setup3, make_uniform_grid3
    from na_dd_tpu_torch.three_d.mms import state_from_mms_when3

    g, case, _field, integ = make_setup3(
        MMSCaseExpSin3, model=Model02(default_model_consts),
        grid=make_uniform_grid3(*GRID3, device=device), integrator_params=integrator_kw,
    )
    return g, case, integ, state_from_mms_when3(mms_case=case, t=0.0, grid=g)


def halo_inputs():
    rng = np.random.RandomState(3)
    return torch.as_tensor(rng.rand(16, 16))


def _halo_case(ops, u_full):
    u = ops.local_slice(u_full)
    outs = [ops.shift_xm(u), ops.shift_xp(u), ops.shift_ym(u), ops.shift_yp(u)]
    return {
        "shifts": [ops.gather_full(v) for v in outs],
        "asum": ops.asum(u * u),
        "amax": ops.amax(u),
        "gather": ops.gather_full(u),
    }


def _gathered(ops, state):
    return State(*(ops.gather_full(v.detach()) for v in state))


def _step_case(mesh, g, s0, integ, axis_x, axis_y):
    from na_dd_tpu_torch.parallel import build_sharded_step, shard_grid_and_state

    gs, ss = shard_grid_and_state(mesh, g, s0, axis_x=axis_x, axis_y=axis_y)
    step = build_sharded_step(integ, mesh, axis_x=axis_x, axis_y=axis_y)
    s1, small = step(gs, ss, STEP["t0"], STEP["dt"])
    return step.ops, s1, {"state": _gathered(step.ops, s1), "small": small}


def xmesh_world(rank, device):
    """4 ranks on a (4,) x mesh (and a (4,) y layout of the same ranks):
    the halo checks, the 2-D step and 2-step simulation, the distributed
    gradient and the data-parallel ensemble."""
    from na_dd_tpu_torch.harness.ensemble import simulate_ensemble
    from na_dd_tpu_torch.parallel import (
        HaloOps, build_sharded_simulation, build_sharded_step, make_mesh, shard_grid_and_state,
    )

    out = {}
    mesh = make_mesh((4,), ("x",))
    u = halo_inputs()
    out["halo_x"] = _halo_case(HaloOps(mesh, axis_x="x"), u)
    mesh_y = make_mesh((4,), ("y",))
    out["halo_y"] = _halo_case(HaloOps(mesh_y, axis_x=None, axis_y="y"), u)

    g, mms, integ, s0 = build_pol(15, device, num_newton_steps=2)
    ops, _s1, out["step"] = _step_case(mesh, g, s0, integ, "x", None)
    out["step"]["stats"] = dict(vars(ops.stats))

    gs, ss = shard_grid_and_state(mesh, g, s0)
    sim = build_sharded_simulation(integ, mesh, mms_case=mms, num_steps=2, **STEP)
    s_final, errors = sim(gs, ss)
    out["sim"] = {"state": _gathered(sim.ops, s_final), "errors": errors}

    # the gradient of Σ_ranks (Σ T1² + Σ cd1 over the rank's block)
    _g, _mms, integ_d, _s0 = build_pol(15, device, krylov_unroll=8, differentiable=True)
    leaves = State(*(v.clone().requires_grad_(True) for v in ss))
    s1, _small = build_sharded_step(integ_d, mesh)(gs, leaves, STEP["t0"], STEP["dt"])
    loss = torch.sum(s1.T * s1.T) + torch.sum(s1.cd)
    loss.backward()
    out["grad"] = State(*(ops.gather_full(v.grad) for v in leaves))
    out["loss"] = ops.asum(loss.detach())

    out["ensemble"] = simulate_ensemble(mesh=make_mesh((4,), ("b",)), device=device, **ENSEMBLE)
    return out if rank == 0 else None


def mesh22_world(rank, device, ckpt_dir):
    """4 ranks on a (2, 2) mesh: the halo checks, the 2-D step, mixed,
    direct, the 3-D step, simulation and direct solve; the checkpoint saved
    by the 4 ranks and read back by 2 of them as a (2,) row layout."""
    from na_dd_tpu_torch.harness.checkpoint import load_state_sharded, save_state_sharded
    from na_dd_tpu_torch.parallel import HaloOps, make_mesh, shard_grid_and_state
    from na_dd_tpu_torch.three_d import HaloOps3
    from na_dd_tpu_torch.three_d.harness import run_trial3

    out = {}
    mesh = make_mesh((2, 2), ("x", "y"))
    out["halo_xy"] = _halo_case(HaloOps(mesh, axis_x="x", axis_y="y"), halo_inputs())

    g, _mms, integ, s0 = build_pol(15, device, num_newton_steps=2)
    ops, s1, out["step"] = _step_case(mesh, g, s0, integ, "x", "y")
    save_state_sharded(ckpt_dir, s1, t=1e-3, step=1, ops=ops)

    g, _mms, integ, s0 = build_pol(15, device, precision="mixed", krylov_unroll=8)
    out["mixed"] = _step_case(mesh, g, s0, integ, "x", "y")[2]
    g, _mms, integ, s0 = build_pol(7, device, linear_solver="direct", num_newton_steps=2)
    out["direct"] = _step_case(mesh, g, s0, integ, "x", "y")[2]

    hops3 = HaloOps3(mesh, axis_x="x", axis_y="y")
    for key, kw in (("step3", dict(krylov_unroll=24)), ("direct3", dict(linear_solver="direct"))):
        g3, _case, integ3, s03 = build_expsin3(device, **kw)
        g3s, s03s = shard_grid_and_state(mesh, g3, s03, axis_x="x", axis_y="y")
        s13, diag = integ3.step_fn(g3s, hops3, s03s, torch.zeros((), dtype=g3.dtype), 1e-3)
        out[key] = {"state": _gathered(hops3, s13), "converged": diag.krylov_converged,
                    "iters": diag.krylov_iters}
    g3, case3, integ3, _s03 = build_expsin3(device, krylov_unroll=24)
    g3s, _ = shard_grid_and_state(mesh, g3, _s03, axis_x="x", axis_y="y")
    res = run_trial3(g3s, case3, integ3, Tf=2e-3, dt=1e-3, ops=hops3)
    out["sim3"] = {"state": _gathered(hops3, res["state"]), "error": res["error"],
                   "errors_final": res["errors_final"], "converged": res["krylov_converged"]}

    ckpt = {}
    if rank < 2:
        layout = HaloOps(make_mesh((2,), ("x",), rank=rank), axis_x="x")
        ckpt["block"], ckpt["t"], ckpt["step"] = load_state_sharded(ckpt_dir, ops=layout,
                                                                    device=device)
    return (out if rank == 0 else {}) | {"ckpt2": ckpt}


def raising_world(rank, device):
    """Rank 1 raises while rank 0 waits in a collective."""
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def hanging_world(rank, device):
    """Every rank waits on a receive that no rank sends."""
    import torch.distributed as dist

    buf = torch.zeros(1)
    dist.recv(buf, src=(rank + 1) % dist.get_world_size())
