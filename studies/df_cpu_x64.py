#!/usr/bin/env python
"""CPU-x64 reference values of the double-float step (``precision="df"``).

Runs the JAX package on the CPU with x64, stepping EAGERLY: the jitted CPU
compile of the lifted step takes tens of minutes (tests/test_df_mode.py),
op-by-op dispatch 9-50 s a step on an 8-core CPU.

* ``f64``: the pol spatial ladder N = 8, 16, 32, 64 (Tf = 0.01, dt = h^1.5
  adjusted to divide Tf, eta = 50, the study's Krylov budget) in float64,
  by the eager loop of this script and by ``MMSTrial.run_for_errors`` under
  ``jax.disable_jit()``; the two must agree to 1e-12 relative, which shows
  the eager loop computes ``run_for_errors``'s error functional (the jitted
  ``run_for_errors`` is kept beside them: XLA's fused arithmetic moves the
  N = 32 level by 3.5e-12);
* ``df``: the same ladder with ``precision="df"``, ``mixed_refine=1``,
  ``mixed_final_check=False`` (the df_fast solver knobs of bench.py; the
  error norms in float64), by the eager loop; each level's combined error;
* ``df3``: one eager step (t = 0, dt = 1e-3) of the 3-D RegHCs integrator on
  MMSCaseExpSin3 at N = 4 with the 3-D study's constants,
  ``krylov_unroll=8``, ``precision="df"``, ``mixed_refine=1``,
  ``mixed_final_check=False``, and the same step in float64: each field's
  2-norm and max-norm, and their max relative deviation;
* ``eta33``: ``run_eta_study_batched("pol", N=8, dt=5e-3, Tf=0.01)`` with 33
  eta from ``np.geomspace(10, 1000, 33)`` and analytic couplings
  (``NA_DD_TPU_COUPLING=analytic``), one vmap of all 33 in float64: the
  errors the port's sweep, split into batches of at most 32, is held to.

Writes ``studies/results/df_cpu_x64.json`` with the command, the platform
and each part's wall time.  ``--only PART [PART ...]`` re-runs some parts
(``ladder``, ``df3``, ``eta33``) and keeps the others of the existing file.

    JAX_PLATFORMS=cpu python studies/df_cpu_x64.py
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

from na_dd_tpu.harness.studies import STUDIES, _make_trial, _study_unroll, study_consts
from na_dd_tpu.harness.trial import ErrorTimeSeries, NumericalErrorSummary, _collect_errors
from na_dd_tpu.models import Model02, default_model_consts
from na_dd_tpu.ops import LOCAL_OPS
from na_dd_tpu.three_d import MMSCaseExpSin3, make_setup3
from na_dd_tpu.three_d.mms import state_from_mms_when3
from na_dd_tpu.three_d.shifts import LOCAL_OPS3

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "results", "df_cpu_x64.json")
LADDER = (8, 16, 32, 64)
TF, ETA = 0.01, 50.0
DF_KW = dict(precision="df", mixed_refine=1, mixed_final_check=False)
THREE_D_CONSTS = dict(K1=1e-3, K2=1e-3, K3=1e-3, K4=1e-3, Dl_max=1e-5, Kd=1e-2, Sd=1.0, Dd_max=1e-6)
DF3 = dict(N=4, dt=1e-3, krylov_unroll=8)


def trial(N, **kw):
    cfg, mc = STUDIES["pol"], study_consts("pol")
    dt = (1.0 / N) ** 1.5
    return _make_trial(cfg["case_cls"], N, ETA, mc=mc,
                       krylov_unroll=_study_unroll(cfg, N, dt, mc), **kw), dt


def eager_error(tr, dt):
    """run_for_errors's combined error, stepping eagerly: t_k = k·dt_adj,
    the norms after each step against the exact state at t_k + dt_adj."""
    num_steps = math.ceil(TF / dt)
    dt_adj = TF / num_steps
    names, ivars = tr.variable_names, tr.integral_vars
    s = tr.initial_state
    rows = [_collect_errors(tr.grid, LOCAL_OPS, tr.mms_case, s, 0.0, names, ivars)]
    converged = True
    for k in range(num_steps):
        t_k = jnp.asarray(0.0 + float(k) * dt_adj)
        s, diag = tr.integrator.step_fn(tr.grid, LOCAL_OPS, s, t_k, dt_adj)
        converged = converged and bool(diag.krylov_converged)
        rows.append(_collect_errors(tr.grid, LOCAL_OPS, tr.mms_case, s, t_k + dt_adj,
                                    names, ivars))
    series = ErrorTimeSeries(
        t=dt_adj * np.arange(num_steps + 1),
        h_norm_sq_errors={v: np.array([float(h[v]) for h, _ in rows]) for v in names},
        grad_h_norm_p_sq_errors={v: np.array([float(g[v]) for _, g in rows]) for v in names},
    )
    summary = NumericalErrorSummary(dt_adj, series, names, ivars)
    return summary.overall_combined_error, num_steps, converged


def part_ladder(out):
    f64, dfl = {}, {}
    for N in LADDER:
        tr, dt = trial(N)
        t0 = time.perf_counter()
        jitted = tr.run_for_errors(Tf=TF, dt=dt).overall_combined_error
        with jax.disable_jit():
            scan = tr.run_for_errors(Tf=TF, dt=dt).overall_combined_error
        eager, steps, _ = eager_error(tr, dt)
        rel = abs(eager - scan) / abs(scan)
        assert rel <= 1e-12, (N, eager, scan, rel)
        f64[str(N)] = dict(run_for_errors=scan, eager=eager, rel=rel, steps=steps,
                           run_for_errors_jit=jitted, rel_jit=abs(eager - jitted) / abs(jitted),
                           seconds=time.perf_counter() - t0)
        print(f"[f64] N={N} run_for_errors {scan!r} eager {eager!r} rel {rel:.3e} "
              f"(jitted {jitted!r}, rel {f64[str(N)]['rel_jit']:.3e})", flush=True)
        trd, _ = trial(N, **DF_KW)
        t0 = time.perf_counter()
        err, steps, conv = eager_error(trd, dt)
        dfl[str(N)] = dict(error=err, steps=steps, converged=conv,
                           rel_to_f64=abs(err - scan) / abs(scan),
                           seconds=time.perf_counter() - t0)
        print(f"[df] N={N} {err!r} ({steps} steps, {dfl[str(N)]['seconds']:.1f} s, "
              f"rel to f64 {dfl[str(N)]['rel_to_f64']:.3e})", flush=True)
        out["f64"], out["df"] = f64, dfl
        write(out)


def part_df3(out):
    model = Model02(default_model_consts._replace(**THREE_D_CONSTS))
    res = {}
    for label, extra in (("f64", {}), ("df", DF_KW)):
        g, case, _field, integ = make_setup3(
            MMSCaseExpSin3, N=DF3["N"], model=model,
            integrator_params=dict(krylov_unroll=DF3["krylov_unroll"], **extra),
        )
        s0 = state_from_mms_when3(mms_case=case, t=0.0, grid=g)
        t0 = time.perf_counter()
        s1, diag = integ.step_fn(g, LOCAL_OPS3, s0, jnp.asarray(0.0), DF3["dt"])
        res[label] = dict(
            norm2={n: float(jnp.sqrt(jnp.sum(getattr(s1, n) ** 2))) for n in s1._fields},
            max={n: float(jnp.max(jnp.abs(getattr(s1, n)))) for n in s1._fields},
            converged=bool(diag.krylov_converged), iters=int(diag.krylov_iters),
            seconds=time.perf_counter() - t0,
        )
        res[label + "_state"] = s1
        print(f"[df3] {label} {res[label]['seconds']:.1f} s iters {res[label]['iters']}", flush=True)
    a, b = res.pop("f64_state"), res.pop("df_state")
    res["max_rel_dev"] = max(
        float(jnp.max(jnp.abs(getattr(a, n) - getattr(b, n))) / jnp.max(jnp.abs(getattr(a, n))))
        for n in a._fields
    )
    print(f"[df3] max relative deviation df vs f64 {res['max_rel_dev']:.3e}", flush=True)
    out["df3"] = dict(config=dict(DF3, consts=THREE_D_CONSTS, **DF_KW), **res)
    write(out)


def write(out):
    with open(PATH, "w") as f:
        json.dump(out, f, indent=1)


def part_eta33(out):
    os.environ["NA_DD_TPU_COUPLING"] = "analytic"
    from na_dd_tpu.harness.studies import run_eta_study_batched

    etas = [float(e) for e in np.geomspace(10.0, 1000.0, 33)]
    res = run_eta_study_batched("pol", N=8, dt=5e-3, Tf=0.01, etas=etas, verbose=False)
    out["eta33"] = dict(config=dict(study="pol", N=8, dt=5e-3, Tf=0.01, coupling="analytic"),
                        etas=res["etas"], errors=res["errors"], wallclock_s=res["wallclock_s"])
    print(f"[eta33] {len(etas)} eta in {res['wallclock_s'][0]:.1f} s", flush=True)
    write(out)


PARTS = {"ladder": part_ladder, "df3": part_df3, "eta33": part_eta33}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", nargs="+", choices=list(PARTS), default=list(PARTS))
    only = parser.parse_args().only
    out = {}
    if set(only) != set(PARTS) and os.path.exists(PATH):
        with open(PATH) as f:
            out = json.load(f)
    out.update(
        command="JAX_PLATFORMS=cpu python studies/df_cpu_x64.py",
        platform=platform.platform(), processor=platform.processor(),
        jax=jax.__version__, config=dict(Tf=TF, eta=ETA, ladder=LADDER, **DF_KW),
    )
    for name in only:
        t0 = time.perf_counter()
        PARTS[name](out)
        out[f"{name}_seconds"] = time.perf_counter() - t0
        write(out)


if __name__ == "__main__":
    main()
