#!/usr/bin/env python
"""CPU-x64 reference values of the 3-D study and the ensemble screen (exact
f64 arithmetic).

Runs the JAX package on the CPU with x64, at the protocols of
``studies/three_d_study.py`` and ``studies/ensemble_throughput.py``:

* ``spatial``: the serial 3-D ladder (``build_runner3`` on MMSCaseExpSin3 with
  the study's constants, Tf = 0.02, eta = 50, dt = 1e-2/2^k, two Newton
  steps), RegHCs at N = 4..64 and the ``cs`` and ``hcs`` variants at N = 4..16;
  each level's combined error;
* ``temporal``: N = 16, dt = 1e-2/2^k for 5 levels, each level's error and
  its error against the dt = 1e-2/2^6 run on the same grid (the study's
  ``--self-reference``); and the same at N = 4 for 2 levels (against
  dt = 1e-2/2^3), the port's CPU test of that mode;
* ``batched``: ``run_spatial_ladder3_batched``, 5 levels from N = 4;
* ``eta3``: ``run_eta_sweep3`` (eta = logspace(1, 3, 7)) at the CLI's default
  N = 4, dt = 1e-2 and at N = 32, dt = 1.25e-3;
* ``ensemble``: the pol screen at N = 64, Tf = 0.01, dt = 5e-4, eta =
  linspace(20, 200, B) for B in 1, 8, 32, 128, the program
  ``ensemble_throughput.py`` builds under ``jax.vmap``; each member's H-norm²
  of each of its five final fields.

Writes ``studies/results/drivers_cpu_x64.json``, rewritten after every part,
with the command, the platform and each part's wall time.  ``--only PART
[PART ...]`` re-runs some parts and keeps the others of the existing file.

    JAX_PLATFORMS=cpu python studies/drivers_cpu_x64.py
"""

import argparse
import json
import math
import os
import platform
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from na_dd_tpu.models import Model02, default_model_consts
from na_dd_tpu.three_d import MMSCaseExpSin3, make_setup3
from na_dd_tpu.three_d.harness import build_runner3

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results", "drivers_cpu_x64.json")
THREE_D_CONSTS = dict(K1=1e-3, K2=1e-3, K3=1e-3, K4=1e-3, Dl_max=1e-5, Kd=1e-2, Sd=1.0, Dd_max=1e-6)
TF3, ETA, DT0 = 0.02, 50.0, 1e-2
SPATIAL = {"reghcs": (4, 8, 16, 32, 64), "cs": (4, 8, 16), "hcs": (4, 8, 16)}
TEMPORAL = (dict(N=16, levels=5), dict(N=4, levels=2))
BATCHED_LEVELS = 5
ETA3 = (dict(N=4, dt=1e-2), dict(N=32, dt=1.25e-3))
ENSEMBLE = dict(study="pol", N=64, Tf=0.01, dt=5e-4)
ENSEMBLE_BATCHES = (1, 8, 32, 128)


def model3():
    return Model02(default_model_consts._replace(**THREE_D_CONSTS))


def runner(N, dt, variant="reghcs"):
    g, case, _field, integ = make_setup3(
        MMSCaseExpSin3, N=N, model=model3(), variant=variant, eta=ETA,
        integrator_params=dict(num_newton_steps=2),
    )
    run, s0 = build_runner3(g, case, integ, Tf=TF3, dt=dt)
    return g, run, s0


def level(N, dt, variant="reghcs"):
    """(error, converged, final state, grid) of one study level."""
    g, run, s0 = runner(N, dt, variant)
    s_fin, worst, conv, hcs_ok, _per = jax.block_until_ready(run(s0))
    if not bool(hcs_ok):
        raise RuntimeError(f"{variant} N={N} dt={dt}: HCs corrector lost positivity")
    return float(np.sqrt(worst)), bool(conv), s_fin, g


def part_spatial():
    out = {}
    for variant, Ns in SPATIAL.items():
        rows = []
        for k, N in enumerate(Ns):
            dt = DT0 / 2**k
            t0 = time.perf_counter()
            err, conv, _s, _g = level(N, dt, variant)
            rows.append(dict(N=N, dt=dt, error=err, converged=conv,
                             wallclock_s=time.perf_counter() - t0))
            print(f"  [spatial {variant}] N={N} dt={dt:.3e} err={err!r} conv={conv}", flush=True)
        out[variant] = rows
    return dict(Tf=TF3, eta=ETA, dt0=DT0, variants=out)


def part_temporal():
    return dict(ladders=[temporal_ladder(**cfg) for cfg in TEMPORAL])


def temporal_ladder(N, levels):
    from na_dd_tpu.three_d.inner_products import inner_H3
    from na_dd_tpu.three_d.shifts import LOCAL_OPS3

    rows, states = [], []
    for k in range(levels):
        dt = DT0 / 2**k
        t0 = time.perf_counter()
        err, conv, s_fin, g = level(N, dt)
        states.append(s_fin)
        rows.append(dict(N=N, dt=dt, error=err, converged=conv,
                         wallclock_s=time.perf_counter() - t0))
        print(f"  [temporal] N={N} dt={dt:.3e} err={err!r} conv={conv}", flush=True)
    dt_ref = DT0 / 2 ** (levels + 1)
    _err, conv_ref, s_ref, g = level(N, dt_ref)

    @jax.jit
    def diff_norm_sq(sa, sb):
        tot = 0.0
        for v in type(sa)._fields:
            e = getattr(sa, v) - getattr(sb, v)
            tot = tot + inner_H3(LOCAL_OPS3, g, e, e)
        return tot

    for row, s_k in zip(rows, states):
        row["self_ref_error"] = float(np.sqrt(diff_norm_sq(s_k, s_ref)))
        print(f"  [temporal] dt={row['dt']:.3e} self-ref err={row['self_ref_error']!r}", flush=True)
    return dict(Tf=TF3, eta=ETA, dt0=DT0, dt_ref=dt_ref, ref_converged=conv_ref, levels=rows)


def part_batched():
    from na_dd_tpu.three_d.batched_ladder import run_spatial_ladder3_batched

    res = run_spatial_ladder3_batched(MMSCaseExpSin3, model=model3(), levels=BATCHED_LEVELS,
                                      base_N=4, dt0=DT0, Tf=TF3, eta=ETA)
    return dict(Tf=TF3, eta=ETA, dt0=DT0, base_N=4, Ns=res["Ns"], errors=res["errors"],
                converged=res["converged"])


def part_eta3():
    from na_dd_tpu.three_d.harness import run_eta_sweep3

    etas = [float(x) for x in np.logspace(1, 3, 7)]
    sweeps = []
    for cfg in ETA3:
        t0 = time.perf_counter()
        res = run_eta_sweep3(MMSCaseExpSin3, model=model3(), Tf=TF3, etas=etas, **cfg)
        sweeps.append(dict(cfg, Tf=TF3, etas=res["etas"], errors=res["errors"],
                           converged=res["converged"], wallclock_s=time.perf_counter() - t0))
        print(f"  [eta3] N={cfg['N']} errors={res['errors']}", flush=True)
    return dict(sweeps=sweeps)


def part_ensemble():
    from na_dd_tpu.core import FieldRegHCsTriple, MMSForcingRegHCsTriple, State
    from na_dd_tpu.harness.studies import STUDIES, _study_unroll, study_consts
    from na_dd_tpu.integrators import PCTrapezoidalRegHCsTriple
    from na_dd_tpu.mms import state_from_mms_when
    from na_dd_tpu.ops import make_uniform_grid
    from na_dd_tpu.ops.inner_products import inner_H
    from na_dd_tpu.ops.shifts import LOCAL_OPS

    study, N = ENSEMBLE["study"], ENSEMBLE["N"]
    cfg, mc = STUDIES[study], study_consts(study)
    grid = make_uniform_grid(N, N)
    model = Model02(mc)
    case = cfg["case_cls"](grid=grid, model=model)
    s0 = state_from_mms_when(mms_case=case, t=0.0, grid=grid)
    num_steps = math.ceil(ENSEMBLE["Tf"] / ENSEMBLE["dt"])
    dt = ENSEMBLE["Tf"] / num_steps
    unroll = _study_unroll(cfg, N, dt, mc)

    def simulate_one(eta):
        forcing = MMSForcingRegHCsTriple(mms_case=case, model=model, regularization_factor=eta)
        field = FieldRegHCsTriple(grid=grid, model=model, forcing=forcing,
                                  regularization_factor=eta)
        integ = PCTrapezoidalRegHCsTriple(field, regularization_factor=eta,
                                          track_residuals=False, krylov_unroll=unroll)

        def body(s, k):
            s1, _diag = integ.step_fn(grid, LOCAL_OPS, s, k * dt, dt)
            return s1, None

        ks = jnp.arange(num_steps, dtype=jnp.result_type(float))
        s_final, _ = jax.lax.scan(body, s0, ks)
        return jnp.stack([inner_H(LOCAL_OPS, grid, v, v) for v in s_final])

    run = jax.jit(jax.vmap(simulate_one))
    batches = {}
    for B in ENSEMBLE_BATCHES:
        etas = np.linspace(20.0, 200.0, B)
        t0 = time.perf_counter()
        norms = np.asarray(jax.block_until_ready(run(jnp.asarray(etas))))
        batches[str(B)] = dict(etas=etas.tolist(), final_norms=norms.tolist(),
                               wallclock_s=time.perf_counter() - t0)
        print(f"  [ensemble] B={B} member 0 norms {norms[0].tolist()}", flush=True)
    return dict(ENSEMBLE, num_steps=num_steps, dt_adj=dt, krylov_unroll=unroll,
                fields=list(State._fields), batches=batches)


PARTS = {"eta3": part_eta3, "ensemble": part_ensemble, "spatial": part_spatial,
         "temporal": part_temporal, "batched": part_batched}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=sorted(PARTS), default=list(PARTS))
    args = ap.parse_args()
    out = {}
    if set(args.only) != set(PARTS) and os.path.exists(PATH):
        with open(PATH) as f:
            out = json.load(f)
    out.update(
        command="JAX_PLATFORMS=cpu python studies/drivers_cpu_x64.py",
        platform=f"jax {jax.__version__} cpu x64, python {platform.python_version()}, "
        f"{os.cpu_count()} host cores",
        consts=THREE_D_CONSTS,
    )
    for name in args.only:
        print(f"\n===== {name} =====", flush=True)
        t0 = time.perf_counter()
        out[name] = PARTS[name]()
        out[name]["part_wallclock_s"] = time.perf_counter() - t0
        with open(PATH, "w") as f:
            json.dump(out, f, indent=2)
    print(f"wrote {PATH}")


if __name__ == "__main__":
    main()
