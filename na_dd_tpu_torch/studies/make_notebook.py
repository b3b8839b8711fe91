"""Generate the convergence-study notebooks of the port, with the card's saved
outputs (counterpart of ``studies/make_notebook.py``).

    python -m na_dd_tpu_torch.studies.make_notebook --all --three-d
    python -m na_dd_tpu_torch.studies.make_notebook --study expsin --no-embed-results

One notebook a study of the six reference notebooks, and the 3-D notebook;
.ipynb is plain JSON, so no nbformat is needed.  With saved outputs (the
default) each study cell carries the lines and the rate plot built from the
port's archived runs in ``studies/results_torch/`` (``run_all``,
``three_d_study``): the per-level errors and times, the rate report, and the
error/rate plot where matplotlib imports.  The code cells call the port on
the card; re-running them reproduces the saved numbers.

Writes ``studies/notebooks_torch/`` (or ``--outdir``); ``studies/notebooks/``,
the JAX notebooks, is refused.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
from pathlib import Path

import numpy as np

from na_dd_tpu_torch.studies import RESULTS_DIR, checked_output

NOTEBOOKS_DIR = RESULTS_DIR.parent / "notebooks_torch"

STUDY_KEYS = [
    "pol",
    "expsin",
    "nfsp_cpcsH2_TclcdH3",
    "nfsp_cpcsH2_TclcdH2",
    "nfsp_cpcsH1_TclcdH2",
    "peaks_fast1e1",
]

#: the archived 3-D ladders a notebook shows, in order, with their labels
THREE_D_RESULTS = [
    ("three_d_study.json", "f64"),
    ("three_d_study_f32.json", "f32"),
    ("three_d_study_batched.json", "f64, batched"),
]


def _code(src, outputs=None):
    return {
        "cell_type": "code",
        "execution_count": None,
        "metadata": {},
        "outputs": outputs or [],
        "source": src.splitlines(keepends=True),
    }


def _md(src):
    return {"cell_type": "markdown", "metadata": {}, "source": src.splitlines(keepends=True)}


def _stream(text):
    return {"output_type": "stream", "name": "stdout", "text": text.splitlines(keepends=True)}


def _png_output(fig_bytes):
    return {
        "output_type": "display_data",
        "data": {"image/png": base64.b64encode(fig_bytes).decode("ascii")},
        "metadata": {},
    }


def _load_json(results_dir: Path, name: str):
    path = results_dir / name
    return json.loads(path.read_text()) if path.exists() else None


def _load_result(results_dir: Path, study: str, kind: str):
    for name in (f"{study}_{kind}.json", f"{study}_{kind}_batched.json"):
        res = _load_json(results_dir, name)
        if res is not None:
            return res
    return None


def _rate_plot_png(res, x_key, x_label, title):
    import matplotlib.pyplot as plt

    from na_dd_tpu_torch.harness.plotting import plot_errors_and_rates

    fig = plot_errors_and_rates(res["errors"], res.get("rates") or [], res[x_key], x_label,
                                title, expected_rate=2.0)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", bbox_inches="tight")
    plt.close(fig)
    return buf.getvalue()


def _with_plot(outputs, res, x_key, x_label, title):
    """``outputs`` and the rate plot, where matplotlib imports and the errors
    can be drawn on log axes (the peaks temporal ladder's first levels are
    exactly 0.0, which a log scale refuses with ValueError)."""
    try:
        return outputs + [_png_output(_rate_plot_png(res, x_key, x_label, title))]
    except (ImportError, ValueError):
        return outputs


def _study_outputs(results_dir, study, kind, x_key, x_label):
    """Saved outputs of a spatial or temporal study cell from its archived run."""
    res = _load_result(results_dir, study, kind)
    if res is None:
        return None
    lines = []
    xs = res[x_key]
    steady = res.get("steady_s") or [None] * len(xs)
    for i, (x, err, t) in enumerate(zip(xs, res["errors"], res["wallclock_s"])):
        extra = f" steady={steady[i]:.2f}s" if steady[i] is not None else ""
        lines.append(f"  [{kind} {study}] {x_label}={x} err={err:.6e} ({t:.2f}s{extra})")
    if res.get("reference_errors"):
        lines.append("  reference per-level errors: "
                     + ", ".join(f"{e:.4e}" for e in res["reference_errors"]))
        lines.append("  max relative deviation vs reference: "
                     f"{res.get('max_rel_dev_vs_reference', float('nan')):.2e}")
    if res.get("rates"):
        lines.append("  observed rates: " + ", ".join(f"{r:.3f}" for r in res["rates"]))
    return _with_plot([_stream("\n".join(lines) + "\n")], res, x_key, x_label,
                      f"{study} {kind}")


def _eta_outputs(results_dir, study):
    res = _load_result(results_dir, study, "eta") or _load_result(results_dir, study, "eta_batched")
    if res is None:
        return None
    lines = [f"  [eta {study}] eta={eta:7.1f} err={err:.6e}"
             for eta, err in zip(res["etas"], res["errors"])]
    if res.get("reference_errors"):
        lines.append("  reference: " + ", ".join(f"{e:.6e}" for e in res["reference_errors"]))
    lines.append(f"  whole sweep in one batch: {res['wallclock_s'][-1]:.2f}s")
    return [_stream("\n".join(lines) + "\n")]


def results_device(results_dir, study=None) -> str:
    """The card the archived runs name (``nvidia-smi``'s name and power
    limit), or "the CUDA card" if none does."""
    names = ([f"{study}_{k}.json" for k in ("spatial", "temporal", "eta_batched")] if study
             else [name for name, _label in THREE_D_RESULTS])
    for name in names:
        res = _load_json(results_dir, name)
        if res is not None and res.get("device", "cpu") != "cpu":
            return res["device"]
    return "the CUDA card"


def _notebook(cells):
    return {
        "cells": cells,
        "metadata": {
            "kernelspec": {"display_name": "Python 3", "language": "python", "name": "python3"},
            "language_info": {"name": "python", "version": "3.12"},
        },
        "nbformat": 4,
        "nbformat_minor": 5,
    }


def build_notebook(study: str, embed_results: bool = True, results_dir=RESULTS_DIR) -> dict:
    results_dir = Path(results_dir)
    sp_out = tm_out = eta_out = None
    if embed_results:
        sp_out = _study_outputs(results_dir, study, "spatial", "Ns", "N")
        tm_out = _study_outputs(results_dir, study, "temporal", "dts", "dt")
        eta_out = _eta_outputs(results_dir, study)
    cells = [
        _md(
            f"# Convergence study: `{study}` (PC-RegHCsTriple, eta=50)\n\n"
            "The reference notebook protocol on the port (`na_dd_tpu_torch`, PyTorch\n"
            "and hand-written CUDA kernels): spatial ladder N=2·2^k with dt=h^1.5,\n"
            "temporal dt-halving ladder, and the regularization-factor sweep as one\n"
            "batch. Saved outputs below were produced on\n"
            f"{results_device(results_dir, study)} (float64); see\n"
            "`studies/results_torch/REPRODUCTION.md` for the comparison against the\n"
            "reference's saved notebook outputs."
        ),
        _code(
            "from na_dd_tpu_torch.harness.studies import (\n"
            "    run_spatial_study, run_temporal_study, run_eta_study_batched,\n"
            "    STUDIES, study_consts)\n"
            "from na_dd_tpu_torch.harness.rates import report_on_rates\n"
            "from na_dd_tpu_torch.harness.plotting import plot_errors_and_rates, visualize_mms_solution\n"
            f"STUDY = {study!r}\n"
        ),
        _md("## Visualize the manufactured solution"),
        _code(
            "from na_dd_tpu_torch.models import Model02\n"
            "from na_dd_tpu_torch.ops import make_uniform_grid\n"
            "case = STUDIES[STUDY]['case_cls'](grid=make_uniform_grid(32, 32),\n"
            "                                  model=Model02(study_consts(STUDY)))\n"
            "visualize_mms_solution(case, time_point=0.1)\n"
        ),
        _md("## Spatial convergence (cell 9 protocol)"),
        _code(
            "spatial = run_spatial_study(STUDY, levels=8, measure_steady=True)\n"
            "report_on_rates(spatial['errors'], expected_rate=2.0, tolerance=0.3,\n"
            "                title=f'{STUDY} spatial rates')\n"
            "plot_errors_and_rates(spatial['errors'], spatial['rates'], spatial['Ns'],\n"
            "                      'N', f'{STUDY} spatial', expected_rate=2.0)\n",
            outputs=sp_out,
        ),
        _md("## Temporal convergence (cell 11 protocol)"),
        _code(
            "temporal = run_temporal_study(STUDY, measure_steady=True)\n"
            "report_on_rates(temporal['errors'], expected_rate=2.0, tolerance=0.3,\n"
            "                title=f'{STUDY} temporal rates')\n"
            "plot_errors_and_rates(temporal['errors'], temporal['rates'], temporal['dts'],\n"
            "                      'dt', f'{STUDY} temporal', expected_rate=2.0)\n",
            outputs=tm_out,
        ),
        _md("## Regularization-factor study (cell 13 protocol, one batch)"),
        _code(
            "eta = run_eta_study_batched(STUDY)\nprint(dict(zip(eta['etas'], eta['errors'])))\n",
            outputs=eta_out,
        ),
    ]
    return _notebook(cells)


def _three_d_outputs(results_dir):
    """Saved outputs of the 3-D study cell from the archived ladders."""
    from na_dd_tpu_torch.harness.rates import calculate_observed_rates

    outputs = []
    for name, label in THREE_D_RESULTS:
        res = _load_json(results_dir, name)
        if res is None:
            continue
        lines = [f"  [{label}] device={res.get('device', '?')} x64={res.get('x64', '?')}"]
        if "levels" in res:  # the serial ladder: a timing dict a level
            Ns = [lv["N"] for lv in res["levels"]]
            errors = [lv["error"] for lv in res["levels"]]
            for lv in res["levels"]:
                lines.append(
                    f"  N={lv['N']:4d} ({lv['nodes']:>9,} nodes) dt={lv['dt']:.2e} "
                    f"err={lv['error']:.6e} warm={lv['warm_s']:.3f}s "
                    f"({lv['warm_per_step_s'] * 1e3:.1f} ms/step)"
                )
        else:  # the batched ladder: one batch for the whole ladder
            Ns, errors = res["Ns"], res["errors"]
            for N, err in zip(Ns, errors):
                lines.append(f"  N={N:4d} err={err:.6e}")
            lines.append(
                f"  whole ladder in one batch: first run {res['compile_plus_run_s']:.1f}s"
                + (f", steady {res['steady_s']:.2f}s" if res.get("steady_s") is not None else "")
            )
        pairwise = [float(np.log2(errors[i] / errors[i + 1])) for i in range(len(errors) - 1)]
        lines.append("  observed rates: " + ", ".join(f"{r:.3f}" for r in pairwise))
        # the plot takes the harness's 3-point rates, not the pairwise ones
        compat = {"Ns": Ns, "errors": errors,
                  "rates": [r for r, _s in calculate_observed_rates(errors)]}
        outputs += _with_plot([_stream("\n".join(lines) + "\n")], compat, "Ns", "N",
                              f"3-D spatial ({label})")
    return outputs or None


def build_three_d_notebook(embed_results: bool = True, results_dir=RESULTS_DIR) -> dict:
    """The notebook of the 3-D model (beyond the reference)."""
    results_dir = Path(results_dir)
    out = _three_d_outputs(results_dir) if embed_results else None
    cells = [
        _md(
            "# 3-D model convergence study (beyond reference)\n\n"
            "The reference framework is strictly 2-D.  `na_dd_tpu_torch.three_d`\n"
            "carries the full five-field NA-DD system to (N+1, M+1, P+1)\n"
            "grids: fields with analytic Stencil7 Jacobian and coupling planes,\n"
            "a (t,x,y,z) MMS engine, and the PC-trapezoidal integrator family\n"
            "with the 2-D Newton/Krylov/mixed-precision machinery, each Newton\n"
            "solve one launch of the hand-written 7-point BiCGStab kernel.  This\n"
            "notebook runs the spatial ladder of\n"
            "`python -m na_dd_tpu_torch.studies.three_d_study` (dt ∝ h, so both\n"
            "error components contract at order 2) and reports the reference-style\n"
            "combined max-integral error norm. Saved outputs below were produced on\n"
            f"{results_device(results_dir)}."
        ),
        _code(
            "import numpy as np\n"
            "from na_dd_tpu_torch.models import Model02, default_model_consts\n"
            "from na_dd_tpu_torch.three_d import MMSCaseExpSin3, make_setup3, run_trial3\n"
            "MC = default_model_consts._replace(K1=1e-3, K2=1e-3, K3=1e-3, K4=1e-3,\n"
            "                                   Dl_max=1e-5, Kd=1e-2, Sd=1.0, Dd_max=1e-6)\n"
            "model = Model02(MC)\n"
        ),
        _md("## Visualize the manufactured solution (z slices)"),
        _code(
            "from na_dd_tpu_torch.three_d import make_uniform_grid3\n"
            "from na_dd_tpu_torch.harness.plotting import visualize_mms_solution3\n"
            "case_viz = MMSCaseExpSin3(make_uniform_grid3(24, 24, 24), model)\n"
            "visualize_mms_solution3(case_viz, time_point=0.1)\n"
        ),
        _md("## Spatial ladder (dt ∝ h)"),
        _code(
            "errs = []\n"
            "for k in range(4):\n"
            "    N, dt = 4 * 2**k, 1e-2 / 2**k\n"
            "    g, case, field, integ = make_setup3(\n"
            "        MMSCaseExpSin3, N=N, model=model,\n"
            "        integrator_params=dict(num_newton_steps=2))\n"
            "    out = run_trial3(g, case, integ, Tf=0.02, dt=dt)\n"
            "    errs.append(out['error'])\n"
            "    print(f'N={N:4d} err={out[\"error\"]:.6e} converged={out[\"krylov_converged\"]}')\n"
            "print('rates:', [float(np.log2(errs[i]/errs[i+1])) for i in range(len(errs)-1)])\n",
            outputs=out,
        ),
        _md(
            "## Notes\n\n"
            "- The same ladder is scriptable via\n"
            "  `python -m na_dd_tpu_torch.studies.three_d_study` (archives JSON under\n"
            "  `studies/results_torch/`, every level held to the JAX package's CPU-x64\n"
            "  record).\n"
            "- Sharded execution: `HaloOps3(make_mesh((2, 2), ('x', 'y')), axis_x='x',\n"
            "  axis_y='y')` inside each rank of `na_dd_tpu_torch.parallel.run_ranks`\n"
            "  (`torch.distributed`; the x/y halo planes are exchanged between ranks,\n"
            "  the z axis stays whole on each), passed as `run_trial3(..., ops=hops3)`.\n"
            "- Production runs: `na_dd_tpu_torch.three_d.make_integrator3` + the\n"
            "  dimension-agnostic `harness.simulate` functions."
        ),
    ]
    return _notebook(cells)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--study", choices=STUDY_KEYS)
    p.add_argument("--all", action="store_true")
    p.add_argument("--three-d", action="store_true", help="also write the 3-D notebook")
    p.add_argument("--no-embed-results", action="store_true")
    p.add_argument("--results-dir", default=str(RESULTS_DIR),
                   help="the archived runs the outputs come from (default: studies/results_torch/)")
    p.add_argument("--outdir", default=str(NOTEBOOKS_DIR),
                   help="where the notebooks go (default: studies/notebooks_torch/)")
    args = p.parse_args(argv)
    studies = STUDY_KEYS if args.all else ([args.study] if args.study else ["expsin"])
    if args.three_d and not args.study:
        studies = studies if args.all else []
    outdir = checked_output(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    embed = not args.no_embed_results
    for study in studies:
        path = outdir / f"{study}_reghcstriple_convergence_study.ipynb"
        path.write_text(json.dumps(build_notebook(study, embed, args.results_dir), indent=1))
        print(f"wrote {path}")
    if args.three_d or args.all:
        path = outdir / "three_d_model_convergence_study.ipynb"
        path.write_text(json.dumps(build_three_d_notebook(embed, args.results_dir), indent=1))
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
