"""The 3-D study's level (``studies/three_d_study.py``'s serial ladder, one
level): ``three_d.harness.make_setup3`` and ``build_runner3``'s ``run(s0)``
on the local 3-D ops, the level ending in its one host transfer as
``run_trial3`` ends it.  One member (one η) a unit."""

from __future__ import annotations

import torch

from portbench.reference.scheme import Scheme, steps_of


def build(cfg: dict, etas, device, span):
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import ModelConsts
    from na_dd_tpu_torch.three_d import mms
    from na_dd_tpu_torch.three_d.harness import build_runner3, make_setup3

    if len(etas) != 1:
        raise ValueError("a 3-D level runs one member")
    model = Model02(ModelConsts(**cfg["consts"]))
    g, case, _field, integ = make_setup3(
        getattr(mms, cfg["case_class"]), N=cfg["N"], model=model, eta=float(etas[0]),
        integrator_params=dict(cfg["integrator"]), dtype=torch.float64, device=device)
    run, s0 = build_runner3(g, case, integ, Tf=cfg["Tf"], dt=cfg["dt"])

    def unit():
        s_fin, worst, ok, hcs_ok, per_var = run(s0)
        with span("transfer"):
            packed = torch.stack(
                [t.to(torch.float64) for t in (worst, ok, hcs_ok, *per_var.values())]).cpu()
        return {"state": {k: v.unsqueeze(0) for k, v in s_fin._asdict().items()},
                "error": packed[:1].sqrt()}

    return {"integrators": [integ], "members": 1, "steps_per_unit": steps_of(cfg["Tf"], cfg["dt"])[0], "unit": unit}


def reference(cfg: dict, etas, device, dtype):
    """The plain reference of one level: its final fields and combined
    error."""
    sch = Scheme(case=cfg["case"], consts=cfg["consts"], N=cfg["N"], dim=3, etas=etas,
                 sweeps=cfg["integrator"]["num_newton_steps"], dtype=dtype, device=device)
    state, err = sch.simulate(*steps_of(cfg["Tf"], cfg["dt"]), errors=True)
    return {"state": state, "error": err["error"]}
