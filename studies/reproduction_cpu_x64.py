#!/usr/bin/env python
"""CPU-x64 reference values of the six-notebook reproduction (exact f64
arithmetic).

For each of the 18 runs of ``studies/run_all_tpu.py``'s ``PLAN`` this runs,
on the CPU with x64, the JAX harness function that script calls
(``run_spatial_study``, ``run_temporal_study`` or ``run_eta_study_batched``)
up to the last level whose ``studies/adjudicate_level.level_cost`` is within
that script's adjudication budget of 5e7 node-steps; deeper levels (the N=256
level of the four Tf = 1 spatial ladders) have no record.  Each level is its
own program (no compile sharing).  Writes
``studies/results/reproduction_cpu_x64.json``, rewritten after every run, with
the command, the platform and the wall time of each level.

    JAX_PLATFORMS=cpu python studies/reproduction_cpu_x64.py
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

from na_dd_tpu.harness.studies import (
    run_eta_study_batched,
    run_spatial_study,
    run_temporal_study,
)
from studies.adjudicate_level import level_cost

BUDGET = 5e7  # node-steps; run_all_tpu._adjudicate's default budget
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results",
                    "reproduction_cpu_x64.json")


def read_plan():
    """``run_all_tpu.PLAN``, read from its source: importing that script
    would turn on the persistent compilation cache."""
    import ast

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "run_all_tpu.py")
    for node in ast.parse(open(src).read()).body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "PLAN":
            return eval(compile(ast.Expression(node.value), src, "eval"), {"dict": dict})
    raise RuntimeError(f"no PLAN in {src}")


def affordable_levels(study: str, kind: str, levels: int) -> int:
    """How many leading levels of the ladder fit the budget."""
    n = 0
    while n < levels and level_cost(study, kind, n) <= BUDGET:
        n += 1
    return n


def main():
    from na_dd_tpu.harness.studies import STUDIES

    t_all = time.perf_counter()
    out = dict(
        command="JAX_PLATFORMS=cpu python studies/reproduction_cpu_x64.py",
        platform=f"jax {jax.__version__} cpu x64, python {platform.python_version()}, "
        f"{os.cpu_count()} host cores",
        budget_node_steps=BUDGET,
        runs={},
    )
    for study, kind, kwargs in read_plan():
        print(f"\n===== {study} / {kind} =====", flush=True)
        if kind == "spatial":
            levels = kwargs.get("levels", 8)
            n = affordable_levels(study, kind, levels)
            res = run_spatial_study(study, levels=n, verbose=True)
            run = dict(Ns=res["Ns"], dts=[(1.0 / N) ** 1.5 for N in res["Ns"]], Tf=res["Tf"])
        elif kind == "temporal":
            levels = STUDIES[study]["temporal"]["levels"]
            n = affordable_levels(study, kind, levels)
            res = run_temporal_study(study, levels=n, verbose=True)
            run = dict(Ns=res["Ns"], dts=res["dts"], Tf=res["Tf"])
        else:
            levels = 7
            n = affordable_levels(study, kind, levels)
            res = run_eta_study_batched(study, verbose=True)
            run = dict(N=res["N"], dt=res["dt"], Tf=res["Tf"], etas=res["etas"])
        run.update(
            levels=levels, levels_in_budget=n,
            errors=[float(e) for e in res["errors"][:n]],
            wallclock_s=res["wallclock_s"],
        )
        out["runs"][f"{study}/{kind}"] = run
        out["total_wallclock_s"] = time.perf_counter() - t_all
        with open(PATH, "w") as f:
            json.dump(out, f, indent=2)
    print(f"wrote {PATH}")


if __name__ == "__main__":
    main()
