#!/usr/bin/env python
"""CPU-x64 reference values of the solver options (exact f64 arithmetic).

Runs the JAX package on the CPU with x64 and writes
studies/results/options_cpu_x64.json with the wall time of each part:

* matrix_free: the pol study's level N=64 (``_make_trial``, RegHCs,
  eta = 50, the pol constants) for 10 steps of the protocol's dt = h^1.5,
  with ``assemble_stencil=False`` and the while-form BiCGStab
  (``krylov_unroll=None``), and the same with the analytic planes;
* heat3: ``heat_mms_error`` at N = 16, 32, 64, 128 (D = 0.1, Tf = 0.1,
  dt = Tf/20);
* gradients3: the 3-D sin bump of tests/test_three_d_model.py (N=64, 8
  steps of 1e-3, that file's constants with gamma_T = 1e-2) with
  ``differentiable=True``: the final H-weighted sum of cd (Σ w_H·cd) and its
  ``jax.grad`` with respect to Kd and to the initial state's amplitude a
  (s0 = a·(0.2, 0.1, 0, 0.05, 1)·bump, a = 1).

The probed and direct levels need no record of their own: they are held to
the analytic levels' values (pol_cpu_x64.json; the 3-D values in
chip_smoke.py).

    JAX_PLATFORMS=cpu python studies/options_cpu_x64.py
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

from na_dd_tpu.core.state import State  # noqa: E402
from na_dd_tpu.harness.studies import _make_trial, study_consts  # noqa: E402
from na_dd_tpu.mms.cases import MMSCasePol  # noqa: E402
from na_dd_tpu.models import Model02, default_model_consts  # noqa: E402
from na_dd_tpu.three_d import make_integrator3  # noqa: E402
from na_dd_tpu.three_d.diffusion import heat_mms_error  # noqa: E402
from na_dd_tpu.three_d.grid import make_uniform_grid3  # noqa: E402
from na_dd_tpu.three_d.shifts import LOCAL_OPS3  # noqa: E402

# tests/test_three_d_model.py MC, with gamma_T = 1e-2 (as chip_smoke's bump)
MC3 = default_model_consts._replace(
    gamma_T=1e-2, K1=1e-3, K2=1e-3, K3=1e-3, K4=1e-3, Dl_max=1e-5, Kd=1e-2, Sd=1.0, Dd_max=1e-6
)
MF_N, MF_STEPS = 64, 10
HEAT_NS = (16, 32, 64, 128)
GRAD3 = dict(N=64, num_steps=8, dt=1e-3)

out = {"platform": platform.platform(), "cpus": os.cpu_count(), "jax": jax.__version__}
t_all = time.perf_counter()

dt = (1.0 / MF_N) ** 1.5
out["matrix_free"] = dict(N=MF_N, num_steps=MF_STEPS, dt=dt, Tf=MF_STEPS * dt)
for name, kw in (("graph", dict(assemble_stencil=False, krylov_unroll=None)),
                 ("analytic", dict(krylov_unroll=None))):
    t0 = time.perf_counter()
    trial = _make_trial(MMSCasePol, MF_N, 50.0, mc=study_consts("pol"), **kw)
    err = trial.run_for_errors(Tf=MF_STEPS * dt, dt=dt).overall_combined_error
    out["matrix_free"][name] = dict(error=float(err), wallclock_s=time.perf_counter() - t0)
print("matrix_free", out["matrix_free"], flush=True)

out["heat3"] = dict(D=0.1, Tf=0.1, dt=0.1 / 20, errors={}, wallclock_s={})
for N in HEAT_NS:
    t0 = time.perf_counter()
    out["heat3"]["errors"][N] = float(heat_mms_error(N, D=0.1, Tf=0.1))
    out["heat3"]["wallclock_s"][N] = time.perf_counter() - t0
print("heat3", out["heat3"], flush=True)

t0 = time.perf_counter()
g3 = make_uniform_grid3(GRAD3["N"], GRAD3["N"], GRAD3["N"])
bump = (jnp.sin(jnp.pi * g3.xx) * jnp.sin(jnp.pi * g3.yy) * jnp.sin(jnp.pi * g3.zz)) * g3.interior_mask


def loss(Kd, amp):
    integ = make_integrator3(g3, Model02(MC3._replace(Kd=Kd)), differentiable=True)
    s = State(cp=0.2 * amp * bump, T=0.1 * amp * bump, cl=0.0 * bump, cd=0.05 * amp * bump,
              cs=amp * bump)

    def body(s, k):
        s1, _ = integ.step_fn(g3, LOCAL_OPS3, s, k * GRAD3["dt"], GRAD3["dt"])
        return s1, None

    s, _ = jax.lax.scan(jax.checkpoint(body), s, jnp.arange(GRAD3["num_steps"], dtype=jnp.float64))
    return LOCAL_OPS3.asum(g3.w_H * s.cd)


value, (g_Kd, g_amp) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
    jnp.asarray(MC3.Kd), jnp.asarray(1.0))
out["gradients3"] = dict(GRAD3, consts="tests/test_three_d_model.py MC, gamma_T=1e-2",
                         value=float(value), grads={"Kd": float(g_Kd), "amplitude": float(g_amp)},
                         wallclock_s=time.perf_counter() - t0)
print("gradients3", out["gradients3"], flush=True)

out["total_wallclock_s"] = time.perf_counter() - t_all
path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results", "options_cpu_x64.json")
with open(path, "w") as f:
    json.dump(out, f, indent=2)
print(f"wrote {path} in {out['total_wallclock_s']:.1f} s")
