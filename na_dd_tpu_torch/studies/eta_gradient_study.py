"""Gradient-based regularization study on the card: dObs/dη through the IFT
adjoints (counterpart of ``studies/eta_gradient_study.py``).

    python -m na_dd_tpu_torch.studies.eta_gradient_study              # the card, N=16
    python -m na_dd_tpu_torch.studies.eta_gradient_study --device cpu --n 8

The RegHCs variant replaces the sharp Heaviside dissolution switch by
H_η(cs) = 1/(1 + exp(-η·cs)).  The production drug-release scenario (no
forcing, a Gaussian drug blob whose cs tails sit near zero, so H_η varies
across the domain) runs 40 steps, and the dissolved-drug fraction at the end
is differentiated with respect to η by ``torch.autograd`` through the
differentiable integrator of ``build_simulator``: each Newton solve is a
``plane_solve``, whose backward pass solves the transposed planes (K1 on the
card).  η enters the field reaction, the cs corrector denominator and every
Newton solve.  Obs(η) and dObs/dη across η = 10..1000 (7 values), with
central-difference checks at two of them (gate 1e-4).

Unlike the JAX study, which defaults to the CPU, this runs on the CUDA card
unless ``--device cpu``, as every entry point of the port does; with no card
and no device it raises.  ``--n`` is the JAX study's ``ETA_GRAD_N``.  The
result is archived as ``eta_gradient_study.json`` under
``studies/results_torch/`` (or ``--results-dir``), never under
``studies/results/``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from na_dd_tpu_torch import config
from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.harness.gradients import build_simulator
from na_dd_tpu_torch.harness.simulate import dissolved_drug_fraction
from na_dd_tpu_torch.models.consts import default_model_consts
from na_dd_tpu_torch.ops.grid import make_uniform_grid
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS
from na_dd_tpu_torch.studies import RESULTS_DIR, checked_output, device_label

N_DEFAULT = 16
DT = 2e-3
NUM_STEPS = 40
#: Kd boosted (against the physical 1e-8) so the dissolution pathway moves an
#: O(1) amount of mass within the run
MC = default_model_consts._replace(Kd=1e-2)
FD_GATE = 1e-4


def make_loss(N: int = N_DEFAULT, device=None, dtype=None):
    """``loss(eta)``: the dissolved-drug fraction after the scenario's 40
    steps at regularization factor ``eta`` (a float or a 0-d tensor that may
    require grad), on the N×N grid in ``dtype`` on ``device``."""
    grid = make_uniform_grid(N, N, dtype=dtype, device=device)
    blob = torch.exp(-60.0 * ((grid.xx - 0.5) ** 2 + (grid.yy - 0.5) ** 2)) * grid.interior_mask
    s0 = State(cp=0.5 * blob, T=0.1 * blob, cl=0.2 * blob, cd=0.05 * blob, cs=blob)
    sim = build_simulator(grid, dt=DT, num_steps=NUM_STEPS, base_consts=MC, krylov_unroll=8)

    def loss(eta):
        s_fin = sim({"regularization_factor": eta}, s0)
        return dissolved_drug_fraction(LOCAL_OPS, grid, s_fin)

    return loss


def run(etas, N: int = N_DEFAULT, device=None, dtype=None, fd_etas=None,
        verbose: bool = True) -> dict:
    """Obs and dObs/dη at each of ``etas`` and the central-difference checks
    (h = 1e-3·η) at ``fd_etas`` (default: ``etas[2]`` and ``etas[-1]``, the
    JAX study's points), each one of ``etas``: ``{"rows": [{"eta", "obs",
    "dobs_deta"}], "fd_checks": [{"eta", "adjoint", "fd", "rel_dev"}]}``."""
    device, dtype = config.resolve_device(device), config.resolve_dtype(dtype)
    loss = make_loss(N, device=device, dtype=dtype)
    rows = []
    for eta in etas:
        leaf = torch.tensor(float(eta), dtype=dtype, device=device, requires_grad=True)
        obs = loss(leaf)
        (grad,) = torch.autograd.grad(obs, leaf)
        rows.append({"eta": float(eta), "obs": float(obs.detach()), "dobs_deta": float(grad)})
        if verbose:
            print(f"eta={eta:9.2f}  obs={rows[-1]['obs']:.8e}  "
                  f"dObs/deta={rows[-1]['dobs_deta']:+.6e}", flush=True)
    checks = []
    for eta in (etas[2], etas[-1]) if fd_etas is None else fd_etas:
        h = 1e-3 * eta
        with torch.no_grad():
            fd = (float(loss(eta + h)) - float(loss(eta - h))) / (2 * h)
        ad = next(r["dobs_deta"] for r in rows if r["eta"] == float(eta))
        rel = abs(ad - fd) / max(abs(fd), 1e-300)
        checks.append({"eta": float(eta), "adjoint": ad, "fd": fd, "rel_dev": rel})
        if verbose:
            print(f"[check] eta={eta:.2f} adjoint={ad:+.6e} fd={fd:+.6e} rel={rel:.2e}",
                  flush=True)
    return {"rows": rows, "fd_checks": checks}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=N_DEFAULT,
                    help="grid N (N×N); the JAX study's ETA_GRAD_N")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card by default (the JAX study's default "
                         "is the CPU), 'cpu' only when asked")
    ap.add_argument("--results-dir", default=str(RESULTS_DIR),
                    help="where the JSON goes (default: studies/results_torch/)")
    return ap


def main(argv=None) -> int:
    """Run the η ladder logspace(1, 3, 7), archive it and return the exit
    code: 0, or 1 if a central-difference check is over 1e-4."""
    args = parser().parse_args(argv)
    device = config.resolve_device(args.device)
    out_path = checked_output(args.results_dir) / "eta_gradient_study.json"
    label = device_label(device)
    print("device:", label, flush=True)
    t0 = time.perf_counter()
    res = run([float(x) for x in np.logspace(1, 3, 7)], N=args.n, device=device)
    ok = all(c["rel_dev"] < FD_GATE for c in res["fd_checks"])
    print("[OK]" if ok else "[ADJOINT/FD MISMATCH]")
    out = {
        "N": args.n, "dt": DT, "num_steps": NUM_STEPS, "Kd": MC.Kd,
        "scenario": "gaussian-blob drug release (NoForcing)",
        "observable": "dissolved_drug_fraction(Tf)",
        **res,
        "backend": device.type,
        "wallclock_s": round(time.perf_counter() - t0, 1),
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
        "device": label,
    }
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(out, indent=1))
    print("archived:", out_path)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
