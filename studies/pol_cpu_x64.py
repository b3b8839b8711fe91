#!/usr/bin/env python
"""CPU-x64 reference values of the pol study (exact f64 arithmetic).

Runs the JAX package on the CPU with x64 at the pol notebook's spatial
ladder N=2..256 (dt = h^1.5, Tf = 0.01; N=256 is the 41-step level bench.py
times) and at its four temporal levels (N=256, dt = 1e-2/2^k), each level its
own program (no compile sharing), and writes
studies/results/pol_cpu_x64.json with the wall time of each level.

    JAX_PLATFORMS=cpu python studies/pol_cpu_x64.py
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

from na_dd_tpu.harness.studies import run_spatial_study, run_temporal_study

t_all = time.perf_counter()
spatial = run_spatial_study("pol", levels=8, verbose=True)
temporal = run_temporal_study("pol", verbose=True)
out = dict(
    command="JAX_PLATFORMS=cpu python studies/pol_cpu_x64.py",
    platform=f"jax {jax.__version__} cpu x64, python {platform.python_version()}, "
    f"{os.cpu_count()} host cores",
    spatial=dict(
        Ns=spatial["Ns"], Tf=spatial["Tf"], eta=spatial["eta"],
        dts=[(1.0 / N) ** 1.5 for N in spatial["Ns"]],
        errors=spatial["errors"], wallclock_s=spatial["wallclock_s"],
    ),
    temporal=dict(
        N=temporal["N"], Tf=temporal["Tf"], eta=temporal["eta"], dts=temporal["dts"],
        errors=temporal["errors"], wallclock_s=temporal["wallclock_s"],
    ),
    total_wallclock_s=time.perf_counter() - t_all,
)
path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results", "pol_cpu_x64.json")
with open(path, "w") as f:
    json.dump(out, f, indent=2)
print(f"wrote {path}")
