#!/usr/bin/env python
"""CPU-x64 reference values of the batched regularization sweeps (exact f64
arithmetic).

Runs the JAX package on the CPU with x64:

* ``run_eta_study_batched("pol")`` at its defaults (notebook cell 13: N=32,
  dt=5e-4, Tf=0.01, the seven values of ``ETA_LADDER``), one vmapped program;
* ``run_eta_sweep3`` on MMSCaseExpSin3 with the 3-D study's constants
  (``studies/three_d_study.py --eta-sweep``) at N=32, Tf=0.02, dt=1.25e-3
  (the 3-D ladder's N=32 step), eta = logspace(1, 3, 7);

and writes studies/results/batched_cpu_x64.json with the wall time of each.
The spatial ladders need no record of their own: their levels are the
serial ladders' (``pol_cpu_x64.json``; the 3-D values in ``chip_smoke.py``).

    JAX_PLATFORMS=cpu python studies/batched_cpu_x64.py
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

import numpy as np

from na_dd_tpu.harness.studies import run_eta_study_batched
from na_dd_tpu.models import Model02, default_model_consts
from na_dd_tpu.three_d import MMSCaseExpSin3
from na_dd_tpu.three_d.harness import run_eta_sweep3

THREE_D_CONSTS = dict(K1=1e-3, K2=1e-3, K3=1e-3, K4=1e-3, Dl_max=1e-5, Kd=1e-2, Sd=1.0, Dd_max=1e-6)
ETA3 = dict(N=32, Tf=0.02, dt=1.25e-3)

t_all = time.perf_counter()
t0 = time.perf_counter()
eta2 = run_eta_study_batched("pol", verbose=True)
wall2 = time.perf_counter() - t0

etas3 = [float(e) for e in np.logspace(1, 3, 7)]
t0 = time.perf_counter()
sweep3 = run_eta_sweep3(
    MMSCaseExpSin3, model=Model02(default_model_consts._replace(**THREE_D_CONSTS)),
    etas=etas3, **ETA3,
)
wall3 = time.perf_counter() - t0
for eta, err, conv in zip(sweep3["etas"], sweep3["errors"], sweep3["converged"]):
    print(f"  [eta3] eta={eta:8.2f} err={err:.16e} conv={conv}")

out = dict(
    command="JAX_PLATFORMS=cpu python studies/batched_cpu_x64.py",
    platform=f"jax {jax.__version__} cpu x64, python {platform.python_version()}, "
    f"{os.cpu_count()} host cores",
    eta_batched=dict(
        study="pol", N=eta2["N"], dt=eta2["dt"], Tf=eta2["Tf"], etas=eta2["etas"],
        errors=eta2["errors"], wallclock_s=wall2,
    ),
    eta_sweep3=dict(
        case="MMSCaseExpSin3", consts=THREE_D_CONSTS, **ETA3, etas=sweep3["etas"],
        errors=sweep3["errors"], converged=sweep3["converged"], wallclock_s=wall3,
    ),
    total_wallclock_s=time.perf_counter() - t_all,
)
path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results", "batched_cpu_x64.json")
with open(path, "w") as f:
    json.dump(out, f, indent=2)
print(f"wrote {path}")
