"""The golden-parity family of the port against the JAX package on CPU
float64, and the goldens of ``tests/test_parity_golden.py`` through the port.

Per module (same inputs, seeded with numpy, in both packages):

* every closure of each MMS case (values and all derivatives) on an 8×8 grid
  at t = 0.1, the case families, the low-regularity |·|^γ cases (whose second
  derivatives carry ``DiracDelta``, also at a node on its support), the 3-D
  zero-crossing case and :class:`MMSCaseFromAnalytic` — 1e-12 relative to the
  JAX value's max-norm (the JAX package evaluates the closures in separated
  Σ f(t)·g(x,y) form on the CPU, the port in full form);
* ``all_fields`` of the Cs, HCs and RegHCs fields and the five terms of the
  sharp-Heaviside forcing through a cs zero crossing — 1e-12;
* one ``step_fn`` of the Cs, HCs and forward-Euler integrators (2-D) and of
  forward Euler in 3-D from the same random state — 1e-12, with the same
  Krylov iteration counts;
* ``derived_quantities`` — 1e-13; the rates functions — equal.

The whole slice: every golden of ``tests/test_parity_golden.py`` through the
port, at that file's own tolerances; the HCs corrector's sign cases and its
positivity error, by the eager step and through the harness (twins of
``tests/test_hcs_corrector.py``); the 3-D Cs/HCs runs and the runs through
the 3-D zero crossing against JAX's ``run_trial3`` at 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from na_dd_tpu.core import fields as j_fields
from na_dd_tpu.core import forcing as j_forcing
from na_dd_tpu.core.derived import derived_quantities as j_derived_quantities
from na_dd_tpu.core.state import State as JState
from na_dd_tpu.harness import rates as j_rates
from na_dd_tpu.harness.studies import STUDY_MODEL_CONSTS as J_STUDY_CONSTS
from na_dd_tpu.integrators import ForwardEulerIntegrator as JFE
from na_dd_tpu.integrators import PCTrapezoidalCsTriple as JCs
from na_dd_tpu.integrators import PCTrapezoidalHCsTriple as JHCs
from na_dd_tpu.mms import cases as j_cases
from na_dd_tpu.mms.engine import MMSCaseFromAnalytic as JFromAnalytic
from na_dd_tpu.models import Model02 as JModel02
from na_dd_tpu.models import default_model_consts as J_DEFAULT_CONSTS
from na_dd_tpu.ops import make_grid as j_make_grid
from na_dd_tpu.ops import make_uniform_grid as j_make_uniform_grid
from na_dd_tpu.ops.shifts import LOCAL_OPS as J_OPS
from na_dd_tpu.three_d import MMSCaseCsZeroCrossing3 as JZC3
from na_dd_tpu.three_d import MMSCaseExpSin3 as JExpSin3
from na_dd_tpu.three_d import MMSCasePol3 as JPol3
from na_dd_tpu.three_d import ForwardEulerIntegrator3 as JFE3
from na_dd_tpu.three_d import LOCAL_OPS3 as J_OPS3
from na_dd_tpu.three_d import norm_H3 as j_norm_H3
from na_dd_tpu.three_d import norm_p3 as j_norm_p3
from na_dd_tpu.three_d.harness import make_setup3 as j_make_setup3
from na_dd_tpu.three_d.harness import run_trial3 as j_run_trial3
from na_dd_tpu_torch.convert import consts_from_dict, state_from_numpy
from na_dd_tpu_torch.core import (
    FieldCsTriple,
    FieldHCsTriple,
    FieldRegHCsTriple,
    MMSForcingCsTriple,
    MMSForcingHCsTriple,
    MMSForcingRegHCsTriple,
    NoForcing,
    State,
)
from na_dd_tpu_torch.core import forcing as t_forcing
from na_dd_tpu_torch.core.derived import derived_quantities as t_derived_quantities
from na_dd_tpu_torch.harness import MMSTrial, calculate_observed_rates
from na_dd_tpu_torch.harness import rates as t_rates
from na_dd_tpu_torch.harness.trial import run_simulation_collect_data
from na_dd_tpu_torch.integrators import (
    ForwardEulerIntegrator,
    HCsCorrectorPositivityError,
    PCTrapezoidalCsTriple,
    PCTrapezoidalHCsTriple,
    PCTrapezoidalRegHCsTriple,
)
from na_dd_tpu_torch.mms import cases as t_cases
from na_dd_tpu_torch.mms.engine import MMSCaseFromAnalytic as TFromAnalytic
from na_dd_tpu_torch.models.coefficients import Model02 as TModel02
from na_dd_tpu_torch.models.consts import default_model_consts
from na_dd_tpu_torch.ops.grid import make_grid as t_make_grid
from na_dd_tpu_torch.ops.grid import make_uniform_grid as t_make_uniform_grid
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS as T_OPS
from na_dd_tpu_torch.three_d import (
    LOCAL_OPS3,
    ForwardEulerIntegrator3,
    MMSCaseCsZeroCrossing3,
    MMSCaseExpSin3,
    MMSCasePol3,
    make_integrator3,
    make_setup3,
    norm_H3,
    norm_p3,
    run_trial3,
)
from na_dd_tpu_torch.three_d.forcing import NoForcing3
from na_dd_tpu_torch.three_d.integrator import PCTrapezoidalHCsTriple3

VARS = ("cp", "T", "cl", "cd", "cs")
DERIVS = ("", "dt_", "dtt_", "dx_", "dy_", "dxx_", "dyy_", "lap_")
DERIVS3 = DERIVS + ("dz_", "dzz_")
ETA = 50.0
REG = dict(
    forcing_terms_params=dict(regularization_factor=ETA),
    field_params=dict(regularization_factor=ETA),
    integrator_params=dict(regularization_factor=ETA),
)
J_MODEL = JModel02(J_STUDY_CONSTS)
T_MODEL = TModel02(consts_from_dict(J_STUDY_CONSTS._asdict()))


def rel_to_max(port, ref) -> float:
    """max|port − ref| / max|ref| (0 when both are 0 everywhere)."""
    port = np.asarray(port.detach().cpu()) if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    diff = float(np.max(np.abs(port - ref)))
    return diff / max(float(np.max(np.abs(ref))), 1e-300) if diff else 0.0


# ---------------------------------------------------------------------------
# MMS cases: every closure against JAX's
# ---------------------------------------------------------------------------
CASES = {
    "expsin": ("MMSCaseExpSin", {}),
    "cs_zero_crossing": ("MMSCaseCsZeroCrossing", dict(cs_A=0.05, cs_B=1.0)),
    "nfsp_cpcsH2_TclcdH3": ("MMSCaseNonFullySmoothPol_cpcsH2_TclcdH3", {}),
    "nfsp_cpcsH1_TclcdH2": ("MMSCaseNonFullySmoothPol_cpcsH1_TclcdH2", {}),
    "nfsp_cpcsH2_TclcdH2": ("MMSCaseNonFullySmoothPol_cpcsH2_TclcdH2", {}),
    "nfsp_cpcsH3_TclcdH4": ("MMSCaseNonFullySmoothPol_cpcsH3_TclcdH4", {}),
    "stiff_exp_decay": ("MMSCaseStiffExpDecay", dict(a_base=20.0)),
    "oscillating_time": ("MMSCasePolWithOscilatingTime", dict(ampl=0.8, speed=7.0)),
    "peaks_slow1e2": ("MMSCaseSlowlyChangingPeaks_Slow1e2", {}),
    "peaks_fast1e1": ("MMSCaseSlowlyChangingPeaks_Fast1e1", {}),
}


def _closure_errors(jcase, tcase, jg, tg, t, derivs=DERIVS):
    worst = {}
    for var in VARS:
        for prefix in derivs:
            name = f"{prefix}{var}"
            ref = getattr(jcase, name)(t, jg.xx, jg.yy)
            port = getattr(tcase, name)(t, tg.xx, tg.yy)
            worst[name] = rel_to_max(port, ref)
    return worst


@pytest.mark.parametrize("case", list(CASES))
def test_case_closures_match_jax(case):
    cls_name, params = CASES[case]
    jg, tg = j_make_uniform_grid(8, 8), t_make_uniform_grid(8, 8, device="cpu")
    jcase = getattr(j_cases, cls_name)(grid=jg, model=J_MODEL, **params)
    tcase = getattr(t_cases, cls_name)(grid=tg, model=T_MODEL, **params)
    worst = _closure_errors(jcase, tcase, jg, tg, 0.1)
    assert max(worst.values()) <= 1e-12, {k: v for k, v in worst.items() if v > 1e-12}


def test_nfsp_closures_on_the_dirac_delta_support_match_jax():
    """The |·|^γ cases' second derivatives on a grid with a node at x = θ =
    1/π, where (x − θ)(y − θ) is 0 and the DiracDelta stub gives 1."""
    theta = 1 / np.pi
    x = np.array([0.0, 0.2, theta, 0.6, 1.0])
    y = np.array([0.0, 0.5, 1.0])
    jg, tg = j_make_grid(x, y), t_make_grid(x, y, device="cpu")
    for name in ("MMSCaseNonFullySmoothPol_cpcsH1_TclcdH2", "MMSCaseNonFullySmoothPol_cpcsH2_TclcdH3"):
        jcase = getattr(j_cases, name)(grid=jg, model=J_MODEL)
        tcase = getattr(t_cases, name)(grid=tg, model=T_MODEL)
        worst = _closure_errors(jcase, tcase, jg, tg, 0.1, derivs=("dxx_", "dyy_", "lap_"))
        assert max(worst.values()) <= 1e-12, (name, worst)


def test_cs_zero_crossing3_closures_match_jax():
    from na_dd_tpu.three_d import make_uniform_grid3 as j_grid3
    from na_dd_tpu_torch.three_d import make_uniform_grid3 as t_grid3

    jg, tg = j_grid3(4, 5, 3), t_grid3(4, 5, 3, device="cpu")
    jcase = JZC3(jg, J_MODEL, cs_A=0.05, cs_B=1.0)
    tcase = MMSCaseCsZeroCrossing3(tg, T_MODEL, cs_A=0.05, cs_B=1.0)
    for var in VARS:
        for prefix in DERIVS3:
            name = f"{prefix}{var}"
            ref = getattr(jcase, name)(0.1, jg.xx, jg.yy, jg.zz)
            port = getattr(tcase, name)(0.1, tg.xx, tg.yy, tg.zz)
            assert rel_to_max(port, ref) <= 1e-12, name


def test_from_analytic_case_matches_jax():
    """Finite-difference derivatives of plain callables.  They are rational
    in (t, x, y), so both packages evaluate them bit for bit alike; a
    transcendental's last-ulp difference between torch and XLA would reach
    the differences amplified by 1/eps (first) and 1/eps² (second
    derivatives)."""
    bases = dict(
        cp_base=lambda t, x, y: x * (1 - x) * y * (1 - y) / (1 + t),
        T_base=lambda t, x, y: (1 - t) * x * x * y * (1 - y),
        cl_base=lambda t, x, y: (0.5 - t) * x * y,
        cd_base=lambda t, x, y: x * x * (1 - y) / (2.0 + t * t),
        cs_base=lambda t, x, y: x * y * (1 - x * y) / (2 + t),
    )
    jg, tg = j_make_uniform_grid(8, 8), t_make_uniform_grid(8, 8, device="cpu")
    jcase = JFromAnalytic(J_MODEL, grid=jg, **bases)
    tcase = TFromAnalytic(T_MODEL, grid=tg, **bases)
    for var in VARS:
        for prefix in ("", "dt_", "dx_", "dy_", "dxx_", "dyy_", "lap_"):
            name = f"{prefix}{var}"
            ref = getattr(jcase, name)(0.1, jg.xx, jg.yy)
            port = getattr(tcase, name)(0.1, tg.xx, tg.yy)
            assert rel_to_max(port, ref) <= 1e-12, name


# ---------------------------------------------------------------------------
# fields, forcing, one step of each integrator
# ---------------------------------------------------------------------------
VARIANTS = {
    "cs": ((j_fields.FieldCsTriple, j_forcing.MMSForcingCsTriple, JCs),
           (FieldCsTriple, MMSForcingCsTriple, PCTrapezoidalCsTriple), {}),
    "hcs": ((j_fields.FieldHCsTriple, j_forcing.MMSForcingHCsTriple, JHCs),
            (FieldHCsTriple, MMSForcingHCsTriple, PCTrapezoidalHCsTriple), {}),
    "reghcs": ((j_fields.FieldRegHCsTriple, j_forcing.MMSForcingRegHCsTriple, None),
               (FieldRegHCsTriple, MMSForcingRegHCsTriple, None), dict(regularization_factor=ETA)),
}


def _pair(variant, case="MMSCaseExpSin", case_params=None, N=8):
    """(jax grid, field), (port grid, field) of ``variant`` on ``case``."""
    (jfield_cls, jforce_cls, _), (tfield_cls, tforce_cls, _), reg = VARIANTS[variant]
    jg, tg = j_make_uniform_grid(N, N), t_make_uniform_grid(N, N, device="cpu")
    jcase = getattr(j_cases, case)(grid=jg, model=J_MODEL, **(case_params or {}))
    tcase = getattr(t_cases, case)(grid=tg, model=T_MODEL, **(case_params or {}))
    jforce = jforce_cls(mms_case=jcase, model=J_MODEL, **reg)
    tforce = tforce_cls(mms_case=tcase, model=T_MODEL, **reg)
    jfield = jfield_cls(grid=jg, model=J_MODEL, forcing=jforce, **reg)
    tfield = tfield_cls(grid=tg, model=T_MODEL, forcing=tforce, **reg)
    return (jg, jfield), (tg, tfield)


def _random_state(shape, seed):
    """Seeded fields around the ExpSin magnitudes, cs of both signs."""
    rng = np.random.default_rng(seed)
    fields = {k: 0.5 * rng.random(shape) for k in ("cp", "T", "cl", "cd")}
    fields["cs"] = rng.random(shape) - 0.5
    fields["cs"][2, 3] = 0.0
    return JState(**{k: jnp.asarray(v) for k, v in fields.items()}), state_from_numpy(fields, device="cpu")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_all_fields_match_jax(variant):
    (jg, jfield), (tg, tfield) = _pair(variant)
    js, ts = _random_state(tg.xx.shape, seed=11)
    ref = jfield.all_fields(jg, J_OPS, js, 0.1)
    port = tfield.all_fields(tg, T_OPS, ts, 0.1)
    for var in VARS:
        assert rel_to_max(getattr(port, var), getattr(ref, var)) <= 1e-12, var
        alone = getattr(tfield, "F" + var)(tg, T_OPS, ts, 0.1)
        assert torch.equal(getattr(port, var), alone), var


@pytest.mark.parametrize("t", [0.02, 0.06])
@pytest.mark.parametrize("term", ["fcp", "fT", "fcl", "fcd", "fcs"])
def test_hcs_forcing_terms_match_jax(term, t):
    """The sharp-Heaviside forcing before and after cs crosses zero at
    t = cs_A = 0.05."""
    (jg, jfield), (tg, tfield) = _pair("hcs", "MMSCaseCsZeroCrossing", dict(cs_A=0.05))
    ref = getattr(jfield.forcing, term)(jg, J_OPS, t)
    port = getattr(tfield.forcing, term)(tg, T_OPS, t)
    assert rel_to_max(port, ref) <= 1e-12


@pytest.fixture(scope="module", params=["cs", "hcs", "fe"])
def one_step(request):
    """One step of ``request.param`` from the same random state (residual
    tracking on), in both packages."""
    variant = "reghcs" if request.param == "fe" else request.param
    (jg, jfield), (tg, tfield) = _pair(variant)
    js, ts = _random_state(tg.xx.shape, seed=5)
    js = js._replace(cs=jnp.abs(js.cs))
    ts = ts._replace(cs=torch.abs(ts.cs))
    dt = 2e-3
    if request.param == "fe":
        return request.param, JFE(jfield).step_fn(jg, J_OPS, js, 0.1, dt), ForwardEulerIntegrator(tfield).step_fn(tg, T_OPS, ts, 0.1, dt)
    j_integ = VARIANTS[variant][0][2](jfield)
    t_integ = VARIANTS[variant][1][2](tfield)
    return request.param, j_integ.step_fn(jg, J_OPS, js, 0.1, dt), t_integ.step_fn(tg, T_OPS, ts, 0.1, dt)


@pytest.mark.parametrize("var", VARS)
def test_one_step_matches_jax(one_step, var):
    name, ref, port = one_step
    if name != "fe":
        ref, port = ref[0], port[0]
    assert rel_to_max(getattr(port, var), getattr(ref, var)) <= 1e-12


def test_one_step_diagnostics_match_jax(one_step):
    name, ref, port = one_step
    if name == "fe":
        assert isinstance(port, State) and isinstance(ref, JState)
        return
    (_, jd), (_, td) = ref, port
    assert int(td.krylov_iters) == int(jd.krylov_iters) > 0
    assert bool(td.krylov_converged) and bool(jd.krylov_converged)
    assert bool(td.hcs_denominator_ok) == bool(jd.hcs_denominator_ok)
    # a converged sweep's residual is the cancellation of O(1) terms: held
    # to 1e-12 of max(its max-norm, 1)
    for res in ("residual_T", "residual_cl", "residual_cd"):
        ref = np.asarray(getattr(jd, res))
        diff = np.max(np.abs(getattr(td, res).numpy() - ref))
        assert diff <= 1e-12 * max(np.max(np.abs(ref)), 1.0), res


def test_forward_euler3_step_and_make_integrator3_match_jax():
    """Forward Euler in 3-D (``all_fields`` of the 3-D field) and the 3-D
    norms against JAX's, and :func:`make_integrator3` building the
    forcing-free variants."""
    jg, _, jfield, _ = j_make_setup3(JExpSin3, N=4, model=J_MODEL, variant="cs")
    tg, _, tfield, _ = make_setup3(MMSCaseExpSin3, N=4, model=T_MODEL, variant="cs", device="cpu")
    rng = np.random.default_rng(7)
    fields = {k: rng.random(tuple(tg.xx.shape)) for k in VARS}
    js = JState(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = state_from_numpy(fields, device="cpu")
    ref = JFE3(jfield).step_fn(jg, J_OPS3, js, 0.1, 1e-3)
    port = ForwardEulerIntegrator3(tfield).step_fn(tg, LOCAL_OPS3, ts, 0.1, 1e-3)
    eager = ForwardEulerIntegrator3(tfield).step(ts, t0=0.1, dt=1e-3)
    assert all(torch.equal(a, b) for a, b in zip(port, eager))
    for var in VARS:
        assert rel_to_max(getattr(port, var), getattr(ref, var)) <= 1e-12, var
    gx, gy, gz = (torch.ones_like(ts.T) * c for c in (1.0, 2.0, 3.0))
    for j_norm, t_norm in ((j_norm_H3(J_OPS3, jg, js.T), norm_H3(LOCAL_OPS3, tg, ts.T)),
                           (j_norm_p3(J_OPS3, jg, *(jnp.asarray(v.numpy()) for v in (gx, gy, gz))),
                            norm_p3(LOCAL_OPS3, tg, gx, gy, gz))):
        assert abs(float(t_norm) - float(j_norm)) <= 1e-13 * float(j_norm)
    integ = make_integrator3(tg, T_MODEL, variant="hcs")
    assert isinstance(integ, PCTrapezoidalHCsTriple3)
    assert isinstance(integ.semi_discrete_field.forcing, NoForcing3)
    assert integ.solver.iters == 24 and integ.track_residuals is False


# ---------------------------------------------------------------------------
# derived quantities, rates
# ---------------------------------------------------------------------------
def test_derived_quantities_match_jax():
    jg, tg = j_make_uniform_grid(7, 9), t_make_uniform_grid(7, 9, device="cpu")
    consts = default_model_consts._replace(Dl_max=2.0, phi_l=0.3, gamma_T=0.7)
    jm = JModel02(J_DEFAULT_CONSTS._replace(**consts._asdict()))
    tm = TModel02(consts)
    rng = np.random.default_rng(20250503)
    fields = {k: rng.random((8, 10)) + 0.2 for k in VARS}
    js = JState(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = state_from_numpy(fields, device="cpu")
    ref = j_derived_quantities(jg, J_OPS, jm, js)
    port = t_derived_quantities(tg, T_OPS, tm, ts)
    assert list(port) == list(ref) and len(port) == 29
    for key in ref:
        assert rel_to_max(port[key], ref[key]) <= 1e-13, key
    assert set(t_derived_quantities(tg, T_OPS, tm, ts, which=["MxT", "cp"])) == {"MxT", "cp"}


RATE_LADDERS = {
    "expsin": [1.9426528299885707e-05, 5.1970566249110085e-06, 1.3226959686374811e-06,
               3.3722488132093435e-07],
    "increasing": [1e-3, 2.5e-4, 3e-4, 1e-4],
    "stalled": [1e-6, 1e-6, 1e-6],
    "zeros": [0.0, 0.0, 0.0],
}


@pytest.mark.parametrize("ladder", list(RATE_LADDERS))
def test_rates_match_jax(ladder, capsys):
    errors = RATE_LADDERS[ladder]
    ref = j_rates.calculate_observed_rates(errors)
    port = t_rates.calculate_observed_rates(errors)
    np.testing.assert_array_equal([r for r, _ in port], [r for r, _ in ref])
    assert [s for _, s in port] == [s for _, s in ref]
    assert t_rates.RateStatus == j_rates.RateStatus

    def outcome(fn, **kw):
        try:
            return "ok", fn(errors, **kw)
        except AssertionError as exc:
            return "raised", str(exc)

    for kw in (dict(halt_print=True), dict(halt_print=True, cmp_type="equal", tolerance=0.35)):
        a, b = outcome(t_rates.observed_rates_report, **kw), outcome(j_rates.observed_rates_report, **kw)
        assert a[0] == b[0]
        if a[0] == "ok":
            np.testing.assert_array_equal(a[1], b[1])
    assert t_rates.report_on_rates(errors)[1] == j_rates.report_on_rates(errors)[1]
    a = outcome(lambda e: t_rates.deliverable_from_test_calculate_observed_rates(name=ladder, errors=e))
    b = outcome(lambda e: j_rates.deliverable_from_test_calculate_observed_rates(name=ladder, errors=e))
    assert a == b
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the goldens of tests/test_parity_golden.py through the port
# ---------------------------------------------------------------------------
PARITY_RTOL = 1e-8
GOLDEN = {
    2: 1.9426528299885707e-05,
    4: 5.1970566249110085e-06,
    8: 1.3226959686374811e-06,
    16: 3.3722488132093435e-07,
}


def _grid(N):
    return t_make_uniform_grid(N, N, device="cpu")


def test_expsin_reghcs_golden_ladder_and_order():
    errors = []
    for N, golden in GOLDEN.items():
        trial = MMSTrial(_grid(N), T_MODEL, t_cases.MMSCaseExpSin, FieldRegHCsTriple,
                         MMSForcingRegHCsTriple, PCTrapezoidalRegHCsTriple, **REG)
        err = trial.run_for_errors(Tf=0.01, dt=(1.0 / N) ** 1.5).overall_combined_error
        assert abs(err - golden) / golden <= PARITY_RTOL, (N, err, golden)
        errors.append(err)
    assert calculate_observed_rates(errors)[-1][0] == pytest.approx(2.0, abs=0.35)


@pytest.mark.parametrize("N,golden", [(8, 1.3027694406570663e-06), (16, 3.2704272907552362e-07)])
def test_cstriple_expsin_golden(N, golden):
    trial = MMSTrial(_grid(N), T_MODEL, t_cases.MMSCaseExpSin, FieldCsTriple,
                     MMSForcingCsTriple, PCTrapezoidalCsTriple)
    err = trial.run_for_errors(Tf=0.01, dt=2e-3).overall_combined_error
    assert abs(err - golden) / golden <= PARITY_RTOL, (err, golden)


@pytest.fixture(scope="module")
def hcs_zero_crossing_run():
    """The HCs golden run: 800 steps through the cs zero crossing at N=8."""
    trial = MMSTrial(_grid(8), T_MODEL, t_cases.MMSCaseCsZeroCrossing, FieldHCsTriple,
                     MMSForcingHCsTriple, PCTrapezoidalHCsTriple)
    return trial.run_for_errors(Tf=0.8, dt=1e-3)


def test_hcstriple_zero_crossing_golden(hcs_zero_crossing_run):
    golden = 3.5029545962258690e-03
    err = hcs_zero_crossing_run.overall_combined_error
    assert abs(err - golden) / golden <= PARITY_RTOL, (err, golden)


def test_hcstriple_zero_crossing_run_solves(hcs_zero_crossing_run):
    """Every step of the golden run converged; cp, T and cl, which no
    source reaches, stay exactly 0 (cd takes the reaction wherever the
    discrete cs and the exact one differ in sign)."""
    series = hcs_zero_crossing_run.series
    assert len(series.krylov_iters) == 800 and series.krylov_converged.all()
    for var in ("cp", "T", "cl"):
        assert hcs_zero_crossing_run.per_variable_sup_errors[var] == 0.0


def test_nfsp_abs_gamma_golden():
    golden = 7.7437919308797556e-07
    trial = MMSTrial(_grid(8), T_MODEL, t_cases.MMSCaseNonFullySmoothPol_cpcsH2_TclcdH3,
                     FieldRegHCsTriple, MMSForcingRegHCsTriple, PCTrapezoidalRegHCsTriple, **REG)
    err = trial.run_for_errors(Tf=0.05, dt=1e-3).overall_combined_error
    assert abs(err - golden) / golden <= PARITY_RTOL, (err, golden)


def test_forward_euler_golden():
    golden = 5.4271963227677798e-06
    per_var = {
        "cp": 9.0169225197585734e-11,
        "T": 6.4097681890801875e-07,
        "cl": 1.2030623521024432e-07,
        "cd": 5.3878692490357578e-06,
        "cs": 2.0507711164165844e-11,
    }
    trial = MMSTrial(_grid(8), T_MODEL, t_cases.MMSCaseExpSin, FieldRegHCsTriple,
                     MMSForcingRegHCsTriple, ForwardEulerIntegrator,
                     forcing_terms_params=dict(regularization_factor=ETA),
                     field_params=dict(regularization_factor=ETA))
    summary = trial.run_for_errors(Tf=0.005, dt=1e-4)
    err = summary.overall_combined_error
    assert abs(err - golden) / golden <= PARITY_RTOL, (err, golden)
    for var, ref in per_var.items():
        got = summary.per_variable_sup_errors[var]
        assert abs(got - ref) / ref <= 1e-7, (var, got, ref)
    assert (summary.series.krylov_iters == 0).all() and summary.series.krylov_converged.all()


FAMILIES = {
    "oscillating_time": (t_cases.make_MMSCasePolWithOscilatingTime_cls(ampl=0.8, speed=7.0), {},
                         dict(Tf=0.05, dt=2e-3), 7.7323703261406674e-05),
    "peaks_slow1e2": (t_cases.MMSCaseSlowlyChangingPeaks_Slow1e2, {}, dict(Tf=0.02, dt=2e-3),
                      1.0868065366384929e-05),
    "stiff_exp_decay": (t_cases.MMSCaseStiffExpDecay, dict(a_base=20.0), dict(Tf=0.05, dt=1e-3),
                        8.7727711888787948e-07),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remaining_case_families_golden(family):
    case_cls, case_params, run_kw, golden = FAMILIES[family]
    trial = MMSTrial(_grid(10), T_MODEL, case_cls, FieldRegHCsTriple, MMSForcingRegHCsTriple,
                     PCTrapezoidalRegHCsTriple, mms_case_params=case_params, **REG)
    err = trial.run_for_errors(**run_kw).overall_combined_error
    assert abs(err - golden) / golden <= PARITY_RTOL, (family, err, golden)


def test_nonuniform_grid_golden():
    golden = 1.1814023749544314e-05
    rng = np.random.RandomState(77)
    x = np.sort(np.concatenate([[0.0, 1.0], rng.rand(9)]))
    y = np.sort(np.concatenate([[0.0, 1.0], rng.rand(7)]))
    trial = MMSTrial(t_make_grid(x, y, device="cpu"), T_MODEL, t_cases.MMSCaseExpSin,
                     FieldRegHCsTriple, MMSForcingRegHCsTriple, PCTrapezoidalRegHCsTriple, **REG)
    err = trial.run_for_errors(Tf=0.01, dt=2e-3).overall_combined_error
    # the golden file's own gate for this grid (summation-order noise)
    assert abs(err - golden) / golden <= 1e-7, (err, golden)


# ---------------------------------------------------------------------------
# the HCs corrector (twins of tests/test_hcs_corrector.py)
# ---------------------------------------------------------------------------
def _hcs_setup(Kd=0.5, Sd=2.0):
    consts = default_model_consts._replace(Kd=Kd, Sd=Sd)
    grid = t_make_uniform_grid(5, 5, device="cpu")
    model = TModel02(consts)
    field = FieldHCsTriple(grid=grid, model=model, forcing=NoForcing())
    return grid, model, PCTrapezoidalHCsTriple(field)


def _const_state(grid, cp=0.0, T=0.0, cl=0.0, cd=0.0, cs=0.0):
    full = lambda v: torch.full_like(grid.xx, float(v))  # noqa: E731
    return State(cp=full(cp), T=full(T), cl=full(cl), cd=full(cd), cs=full(cs))


@pytest.mark.parametrize("cs0", [0.4, -0.4, 0.0])
def test_hcs_corrector_sign_cases(cs0):
    """Y0 = 2 cs0 − dt Kd (Sd − cd0)(1 + cl0) H(cs0) with zero forcing:
    Y0 > 0 → Y0/(2 − dt R1), Y0 < 0 → Y0/2, Y0 = 0 → 0."""
    grid, model, integ = _hcs_setup()
    dt, cl1, cd1 = 0.1, 0.3, 0.5
    at_t0 = _const_state(grid, cl=0.2, cd=0.1, cs=cs0)
    cs1, ok = integ.corrector_cs_step(
        grid, T_OPS, torch.zeros_like(grid.xx), torch.full_like(grid.xx, cl1),
        torch.full_like(grid.xx, cd1), at_t0=at_t0, t0=0.0, dt=dt,
    )
    assert bool(ok)
    R1 = model.Kd * (model.Sd - cd1) * (1 + cl1)
    Y0 = 2 * cs0 - dt * model.Kd * (model.Sd - 0.1) * (1 + 0.2) * float(cs0 > 0)
    expected = Y0 / (2 - dt * R1) if Y0 > 1e-12 else (Y0 / 2.0 if Y0 < -1e-12 else 0.0)
    interior = cs1.numpy()[1:-1, 1:-1]
    assert np.allclose(interior, expected, rtol=1e-13), (interior[0, 0], expected)
    x = interior[0, 0]
    assert 2 * x - dt * R1 * x * float(x > 0) == pytest.approx(Y0, abs=1e-14)
    assert np.all(cs1.numpy()[0] == 0.0)


def test_hcs_corrector_positivity_error():
    """2 − dt Kd (Sd − cd1)(1 + cl1) ≤ 0 gives a False verdict, and the eager
    step raises."""
    grid, _, integ = _hcs_setup(Kd=1.0, Sd=10.0)
    at_t0 = _const_state(grid, cs=0.4)
    _, ok = integ.corrector_cs_step(
        grid, T_OPS, None, torch.full_like(grid.xx, 1.0), torch.zeros_like(grid.xx),
        at_t0=at_t0, t0=0.0, dt=0.5,
    )
    assert not bool(ok)
    with pytest.raises(HCsCorrectorPositivityError):
        integ.step(at_t0, t0=0.0, dt=0.5)
    s1 = _hcs_setup()[2].step(_const_state(grid, cp=0.1, T=0.2, cl=0.1, cd=0.1, cs=0.3), t0=0.0, dt=1e-3)
    assert all(torch.isfinite(getattr(s1, v)).all() for v in VARS)


def test_hcs_positivity_error_through_the_harness():
    """The harness raises once a run, from the device verdict."""
    grid, model, integ = _hcs_setup(Kd=1.0, Sd=10.0)
    case = t_cases.MMSCasePol(grid, model=model)
    with pytest.raises(HCsCorrectorPositivityError):
        run_simulation_collect_data(
            grid=grid, integrator=integ, exact_sol_pack=case,
            initial_state=_const_state(grid, cs=0.4), Tf=1.0, dt=0.5,
            variable_names=list(VARS), integral_vars=["T", "cl", "cd"],
        )


# ---------------------------------------------------------------------------
# the 3-D variants against JAX's run_trial3
# ---------------------------------------------------------------------------
MC3 = dict(K1=1e-3, K2=1e-3, K3=1e-3, K4=1e-3, Dl_max=1e-5, Kd=1e-2, Sd=1.0, Dd_max=1e-6, gamma_T=1e-2)
RUNS3 = {
    "cs-pol3": ("cs", JPol3, MMSCasePol3, {}, dict(Tf=0.01, dt=2.5e-3)),
    "hcs-pol3": ("hcs", JPol3, MMSCasePol3, {}, dict(Tf=0.01, dt=2.5e-3)),
    "hcs-zero-crossing3": ("hcs", JZC3, MMSCaseCsZeroCrossing3, dict(cs_A=0.005), dict(Tf=0.01, dt=1e-3)),
    "reghcs-zero-crossing3": ("reghcs", JZC3, MMSCaseCsZeroCrossing3, dict(cs_A=0.005),
                              dict(Tf=0.01, dt=1e-3)),
}


@pytest.mark.parametrize("run", list(RUNS3))
def test_variant3_run_matches_jax(run):
    """The JAX run takes its while-loop BiCGStab (its CPU default), the port
    its budget of 24: both stop at the same iteration.  The RegHCs run
    through the zero crossing integrates its solution to rounding (error
    ~1e-20), so there the final state carries the comparison."""
    variant, jcase, tcase, case_params, run_kw = RUNS3[run]
    jm = JModel02(J_DEFAULT_CONSTS._replace(**MC3))
    tm = TModel02(default_model_consts._replace(**MC3))
    jg, jc, _, ji = j_make_setup3(jcase, N=4, model=jm, variant=variant, case_params=case_params)
    ref = j_run_trial3(jg, jc, ji, **run_kw)
    tg, tc, _, ti = make_setup3(tcase, N=4, model=tm, variant=variant, case_params=case_params,
                                device="cpu")
    port = run_trial3(tg, tc, ti, **run_kw)
    assert port["krylov_converged"] and ref["krylov_converged"]
    for var in VARS:
        assert rel_to_max(getattr(port["state"], var), getattr(ref["state"], var)) <= 1e-10, var
    if ref["error"] > 1e-12:
        assert abs(port["error"] - ref["error"]) <= 1e-10 * ref["error"]
    else:
        assert port["error"] <= 1e-12
