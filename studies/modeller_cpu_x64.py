#!/usr/bin/env python
"""CPU-x64 reference values of the modeller's path (exact f64 arithmetic).

Runs the JAX package on the CPU with x64 at the drug-release scenario of
tests/test_gradients.py and studies/eta_gradient_study.py (a Gaussian drug
blob b = exp(-60((x-1/2)^2 + (y-1/2)^2)) on the interior, State(cp=0.5b,
T=0.1b, cl=0.2b, cd=0.05b, cs=b), default_model_consts with Kd = 1e-2,
RegHCs, eta = 50, no forcing, dt = 2e-3) and writes
studies/results/modeller_cpu_x64.json with the wall time of each part:

* simulate: N=256, 40 steps, a snapshot every 10 (H-norms of every field,
  the dissolved and released fractions);
* three_d: the sin bump of tests/test_three_d_model.py at N=64, 8 steps of
  1e-3 (make_integrator3, that file's constants);
* adaptive: simulate_adaptive at N=256 to Tf = 0.04 from dt0 = 2e-3;
* gradients: build_simulator (krylov_unroll=24, remat) at N=256, 40 steps,
  jax.grad of the dissolved fraction with respect to Dl_max, Dd_max, Kd,
  K3 and the regularization factor, and its derivative along a seeded
  direction of the initial state;
* configs: the same five-parameter gradient at N=64, 10 steps, with
  precision="mixed" and with linear_solver="direct";
* fit: fit_parameters at N=64, 10 steps, Kd 2e-2 -> 1e-2, 25 iterations,
  learning rate 0.2.

    JAX_PLATFORMS=cpu python studies/modeller_cpu_x64.py
"""

import json
import os
import platform
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from na_dd_tpu.core.state import State  # noqa: E402
from na_dd_tpu.harness.gradients import build_simulator, fit_parameters  # noqa: E402
from na_dd_tpu.harness.simulate import (  # noqa: E402
    dissolved_drug_fraction,
    make_integrator,
    released_drug_fraction,
    simulate,
    simulate_adaptive,
)
from na_dd_tpu.models import Model02, default_model_consts  # noqa: E402
from na_dd_tpu.ops import LOCAL_OPS, make_uniform_grid  # noqa: E402
from na_dd_tpu.ops.inner_products import norm_H  # noqa: E402
from na_dd_tpu.three_d import make_integrator3  # noqa: E402
from na_dd_tpu.three_d.grid import make_uniform_grid3  # noqa: E402
from na_dd_tpu.three_d.shifts import LOCAL_OPS3  # noqa: E402

MC = default_model_consts._replace(Kd=1e-2)
DT = 2e-3
BASE = {"Dl_max": 8.01e-4, "Dd_max": 2.46e-6, "Kd": 1e-2, "K3": 1e-2, "regularization_factor": 50.0}
DIRECTION_SEED = 8  # the initial-state direction: standard normals on the interior
MC3 = default_model_consts._replace(
    K1=1e-3, K2=1e-3, K3=1e-3, K4=1e-3, Dl_max=1e-5, Kd=1e-2, Sd=1.0, Dd_max=1e-6, gamma_T=1e-2
)


def release_state(g):
    b = jnp.exp(-60.0 * ((g.xx - 0.5) ** 2 + (g.yy - 0.5) ** 2)) * g.interior_mask
    return State(cp=0.5 * b, T=0.1 * b, cl=0.2 * b, cd=0.05 * b, cs=b)


def norms(ops, g, s):
    return {v: float(norm_H(ops, g, getattr(s, v))) for v in State._fields}


def five_gradients(g, s0, num_steps, **kw):
    sim = build_simulator(g, dt=DT, num_steps=num_steps, base_consts=MC, **kw)
    value, grads = jax.value_and_grad(
        lambda p: dissolved_drug_fraction(LOCAL_OPS, g, sim(p, s0))
    )({k: jnp.asarray(v) for k, v in BASE.items()})
    return {"value": float(value), "grads": {k: float(v) for k, v in grads.items()}}


out = dict(
    command="JAX_PLATFORMS=cpu python studies/modeller_cpu_x64.py",
    platform=f"jax {jax.__version__} cpu x64, python {platform.python_version()}, "
    f"{os.cpu_count()} host cores",
    scenario=dict(consts="default_model_consts._replace(Kd=1e-2)", eta=50.0, dt=DT, base=BASE,
                  direction_seed=DIRECTION_SEED),
)
t_all = time.perf_counter()

t0 = time.perf_counter()
g = make_uniform_grid(256, 256)
s0 = release_state(g)
integ = make_integrator(g, Model02(MC))
fin, times, snaps = simulate(integ, g, s0, dt=DT, num_steps=40, snapshot_every=10)
out["simulate"] = dict(
    N=256, num_steps=40, snapshot_every=10, times=[float(t) for t in times],
    final_norms=norms(LOCAL_OPS, g, fin),
    snapshot_norms=[norms(LOCAL_OPS, g, State(*(a[k] for a in snaps))) for k in range(4)],
    dissolved=float(dissolved_drug_fraction(LOCAL_OPS, g, fin)),
    released=float(released_drug_fraction(LOCAL_OPS, g, fin, s0)),
    wallclock_s=time.perf_counter() - t0,
)
print("simulate", out["simulate"], flush=True)

t0 = time.perf_counter()
s_ad, info = simulate_adaptive(integ, g, s0, Tf=0.04, dt0=DT, tol=1e-6)
out["adaptive"] = dict(N=256, Tf=0.04, dt0=DT, tol=1e-6, info=info,
                       final_norms=norms(LOCAL_OPS, g, s_ad),
                       dissolved=float(dissolved_drug_fraction(LOCAL_OPS, g, s_ad)),
                       wallclock_s=time.perf_counter() - t0)
print("adaptive", out["adaptive"], flush=True)

t0 = time.perf_counter()
grad = five_gradients(g, s0, 40, krylov_unroll=24, remat=True)
sim = build_simulator(g, dt=DT, num_steps=40, base_consts=MC, krylov_unroll=24)
rng = np.random.default_rng(DIRECTION_SEED)
direction = State(*(jnp.asarray(rng.standard_normal(g.full_shape)) * g.interior_mask
                    for _ in range(5)))
g_state = jax.grad(lambda s: dissolved_drug_fraction(LOCAL_OPS, g, sim({}, s)))(s0)
grad["state_directional"] = float(sum(jnp.sum(a * b) for a, b in zip(g_state, direction)))
out["gradients"] = dict(N=256, num_steps=40, krylov_unroll=24, remat=True, **grad,
                        wallclock_s=time.perf_counter() - t0)
print("gradients", out["gradients"], flush=True)

t0 = time.perf_counter()
g64 = make_uniform_grid(64, 64)
s64 = release_state(g64)
out["configs"] = {
    name: dict(N=64, num_steps=10, **five_gradients(g64, s64, 10, **kw))
    for name, kw in (("mixed", dict(precision="mixed", krylov_unroll=24)),
                     ("direct", dict(linear_solver="direct")))
}
out["configs"]["wallclock_s"] = time.perf_counter() - t0
print("configs", out["configs"], flush=True)

t0 = time.perf_counter()
sim64 = build_simulator(g64, dt=DT, num_steps=10, base_consts=MC, krylov_unroll=24)
obs = lambda s: dissolved_drug_fraction(LOCAL_OPS, g64, s)  # noqa: E731
target = obs(sim64({"Kd": jnp.asarray(1e-2)}, s64))
fitted, history = fit_parameters(sim64, obs, target, {"Kd": 2e-2}, s64, num_iterations=25,
                                 learning_rate=0.2)
out["fit"] = dict(N=64, num_steps=10, Kd0=2e-2, Kd_true=1e-2, num_iterations=25,
                  learning_rate=0.2, target=float(target), history=history, fitted=fitted,
                  wallclock_s=time.perf_counter() - t0)
print("fit", out["fit"], flush=True)

t0 = time.perf_counter()
g3 = make_uniform_grid3(64, 64, 64)
bump = (jnp.sin(jnp.pi * g3.xx) * jnp.sin(jnp.pi * g3.yy) * jnp.sin(jnp.pi * g3.zz)) * g3.interior_mask
s3 = State(cp=0.2 * bump, T=0.1 * bump, cl=0.0 * bump, cd=0.05 * bump, cs=bump)
fin3, _, _ = simulate(make_integrator3(g3, Model02(MC3)), g3, s3, dt=1e-3, num_steps=8,
                      ops=LOCAL_OPS3)
out["three_d"] = dict(N=64, num_steps=8, dt=1e-3, consts="tests/test_three_d_model.py MC, gamma_T=1e-2",
                      final_norms=norms(LOCAL_OPS3, g3, fin3),
                      released=float(released_drug_fraction(LOCAL_OPS3, g3, fin3, s3)),
                      wallclock_s=time.perf_counter() - t0)
print("three_d", out["three_d"], flush=True)

out["total_wallclock_s"] = time.perf_counter() - t_all
path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results", "modeller_cpu_x64.json")
with open(path, "w") as f:
    json.dump(out, f, indent=2)
print(f"wrote {path} in {out['total_wallclock_s']:.1f} s")
