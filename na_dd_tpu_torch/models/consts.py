"""Physical model constants (counterpart of :mod:`na_dd_tpu.models.consts`)
and the study constants of the convergence notebooks (the values of
``na_dd_tpu.harness.studies.STUDY_MODEL_CONSTS`` / ``POL_PEAKS_CONSTS``,
copied here so that the port depends on nothing of the JAX package)."""

from __future__ import annotations

from typing import NamedTuple


class ModelConsts(NamedTuple):
    R0: float
    Ea: float
    K1: float
    K2: float
    K3: float
    K4: float
    DT: float
    Dl_max: float
    phi_l: float
    gamma_T: float
    Kd: float
    Sd: float
    Dd_max: float
    phi_d: float
    phi_T: float
    r_sp: float
    T_ref: float = 300.0


R0 = 8.3144621
Ea = 1.60217662e-19

default_model_consts = ModelConsts(
    R0=R0,
    Ea=Ea,
    K1=1e-2,
    K2=1e-2,
    K3=1e-2,
    K4=1e-2,
    DT=1e-3,
    Dl_max=8.01e-4,
    phi_l=1e-5,
    gamma_T=1e-9,
    Kd=1e-8,
    Sd=10.0,
    Dd_max=2.46e-6,
    phi_d=1e-5,
    phi_T=Ea / R0,
    r_sp=5e-2,
    T_ref=300.0,
)

# Study constants of the reference convergence notebooks (cell 3).
STUDY_MODEL_CONSTS = ModelConsts(
    R0=8.3144621,
    Ea=1.60217662e-19,
    K1=1e-3,
    K2=1e-3,
    K3=1e-3,
    K4=1e-3,
    DT=1e-3,
    Dl_max=1e-5,
    phi_l=1e-5,
    gamma_T=1e-9,
    Kd=1e-2,
    Sd=1.0,
    Dd_max=1e-6,
    phi_d=1e-5,
    phi_T=1.60217662e-19 / 8.3144621,
    r_sp=5e-2,
    T_ref=300.0,
)

# The MMSCasePol and SlowlyChangingPeaks notebooks differ only in these two.
POL_PEAKS_CONSTS = STUDY_MODEL_CONSTS._replace(Dl_max=8.01e-4, Dd_max=2.46e-6)
