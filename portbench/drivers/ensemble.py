"""The η screen (``harness.ensemble.build_ensemble``, the function of the
ensemble-throughput CLI): every member one RegHCs integration of the
study's case from its exact state at 0 to Tf, all members one stack (parts
of at most 32), each Newton solve one launch of the batched K1.  A unit is
one ``run()``, ended by a host read of the members' Krylov iterations.

``build_ensemble`` sets its integrator itself (one Newton sweep, jvp
couplings, float64, the study's Krylov budget, no residual tracking); the
configuration's ``integrator.num_newton_steps`` drives the reference and
is held to the program's integrators, so the two sides cannot part."""

from __future__ import annotations

import torch

from portbench.reference.scheme import Scheme, steps_of


def build(cfg: dict, etas, device, span):
    from na_dd_tpu_torch.harness.ensemble import build_ensemble

    ens = build_ensemble(list(etas), study=cfg["study"], N=cfg["N"], Tf=cfg["Tf"],
                         dt=cfg["dt"], dtype=torch.float64, device=device)
    sweeps = cfg["integrator"]["num_newton_steps"]
    for p in ens["parts"]:
        if p["integrator"].num_newton_steps != sweeps:
            raise ValueError(f"build_ensemble runs {p['integrator'].num_newton_steps} Newton "
                             f"sweep(s); the configuration states {sweeps}")

    def unit():
        s, iters = ens["run"]()
        with span("transfer"):
            iters.cpu()
        return {"state": dict(s._asdict())}

    return {"integrators": [p["integrator"] for p in ens["parts"]], "members": len(etas),
            "steps_per_unit": ens["num_steps"], "unit": unit}


def reference(cfg: dict, etas, device, dtype):
    """The plain reference of the screen: every member's final fields."""
    sch = Scheme(case=cfg["case"], consts=cfg["consts"], N=cfg["N"], dim=2, etas=etas,
                 sweeps=cfg["integrator"]["num_newton_steps"], dtype=dtype, device=device)
    state, _ = sch.simulate(*steps_of(cfg["Tf"], cfg["dt"]))
    return {"state": state}
