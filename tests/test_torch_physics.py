"""The port's physics layer against the JAX package on CPU float64: Model02
coefficients and derivatives, ``heaviside_regularized``, the MMSCasePol pack
(values and every derivative at t = 0.003), the five forcing terms, the five
fields Fcp…Fcs on a random state and the three analytic self-Jacobian
planes.  Tolerance: 1e-13 relative to the reference's max-norm (the JAX
package evaluates the MMS closures in separated Σ f(t)·g(x,y) form on the
CPU, the port in full form: the two differ by reassociation only)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from na_dd_tpu.core import fields as j_fields
from na_dd_tpu.core import forcing as j_forcing
from na_dd_tpu.core.state import State as JState
from na_dd_tpu.core.state import heaviside_regularized as j_heaviside
from na_dd_tpu.harness.studies import POL_PEAKS_CONSTS as J_POL_CONSTS
from na_dd_tpu.mms.cases import MMSCasePol as JMMSCasePol
from na_dd_tpu.models.coefficients import Model02 as JModel02
from na_dd_tpu.ops.grid import make_uniform_grid as j_make_uniform_grid
from na_dd_tpu.ops.shifts import LOCAL_OPS as J_OPS
from na_dd_tpu_torch.convert import consts_from_dict, state_from_numpy, tensor_from_numpy
from na_dd_tpu_torch.core import fields as t_fields
from na_dd_tpu_torch.core import forcing as t_forcing
from na_dd_tpu_torch.core.state import heaviside_regularized as t_heaviside
from na_dd_tpu_torch.mms.cases import MMSCasePol as TMMSCasePol
from na_dd_tpu_torch.models.coefficients import Model02 as TModel02
from na_dd_tpu_torch.models.consts import POL_PEAKS_CONSTS
from na_dd_tpu_torch.ops.grid import make_uniform_grid as t_make_uniform_grid
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS as T_OPS

RTOL = 1e-13
T_EVAL = 0.003
ETA = 50.0
VARS = ("cp", "T", "cl", "cd", "cs")
DERIVS = ("", "dt_", "dtt_", "dx_", "dy_", "dxx_", "dyy_", "lap_")


def assert_close(port, ref, rtol=RTOL):
    port = np.asarray(port.detach().cpu())
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    assert float(np.max(np.abs(port - ref))) <= rtol * scale


@pytest.fixture(scope="module")
def setup():
    jg = j_make_uniform_grid(8, 8)
    tg = t_make_uniform_grid(8, 8, device="cpu")
    jm = JModel02(J_POL_CONSTS)
    tm = TModel02(consts_from_dict(J_POL_CONSTS._asdict()))
    jcase = JMMSCasePol(jg, model=jm)
    tcase = TMMSCasePol(tg, model=tm)
    jforce = j_forcing.MMSForcingRegHCsTriple(mms_case=jcase, model=jm, regularization_factor=ETA)
    tforce = t_forcing.MMSForcingRegHCsTriple(mms_case=tcase, model=tm, regularization_factor=ETA)
    jfield = j_fields.FieldRegHCsTriple(grid=jg, model=jm, forcing=jforce, regularization_factor=ETA)
    tfield = t_fields.FieldRegHCsTriple(grid=tg, model=tm, forcing=tforce, regularization_factor=ETA)
    rng = np.random.default_rng(3)
    state = {v: 0.05 * rng.standard_normal((9, 9)) for v in VARS}
    return dict(jg=jg, tg=tg, jm=jm, tm=tm, jcase=jcase, tcase=tcase, jforce=jforce,
                tforce=tforce, jfield=jfield, tfield=tfield, state=state)


def test_pol_consts_match_the_study_registry():
    assert POL_PEAKS_CONSTS._asdict() == J_POL_CONSTS._asdict()


@pytest.mark.parametrize("spec", [("Dl", 0), ("Dl", 1), ("V1", 0), ("V1", 1), ("V2", 0)])
def test_model_coefficient(setup, spec):
    name, d = spec
    x = np.random.default_rng(4).uniform(-2.0, 2.0, (9, 9))
    port = getattr(setup["tm"], name)(tensor_from_numpy(x, device="cpu"), d=d)
    ref = getattr(setup["jm"], name)(jnp.asarray(x), d=d)
    assert_close(port, ref)


@pytest.mark.parametrize("d", [(0, 0), (1, 0), (0, 1)])
def test_model02_Dd(setup, d):
    rng = np.random.default_rng(6)
    cp = rng.uniform(-1.0, 1.0, (9, 9))
    T = rng.uniform(-1.0, 1.0, (9, 9))
    T[0, :3] = -300.0  # T + T_ref == 0: the singular limit is 0
    port = setup["tm"].Dd(tensor_from_numpy(cp, device="cpu"), tensor_from_numpy(T, device="cpu"), d=d)
    ref = setup["jm"].Dd(jnp.asarray(cp), jnp.asarray(T), d=d)
    assert float(port[0, 0]) == 0.0
    assert_close(port, ref)


def test_Dd_tangent_is_nan_free_at_the_singular_limit(setup):
    T = torch.full((3, 3), -300.0, dtype=torch.float64)
    cp = torch.zeros_like(T)
    _, tangent = torch.func.jvp(lambda t: setup["tm"].Dd(cp, t), (T,), (torch.ones_like(T),))
    assert bool(torch.isfinite(tangent).all()) and float(tangent.abs().max()) == 0.0


def test_heaviside_regularized():
    x = np.concatenate([np.random.default_rng(8).standard_normal(50), [-40.0, 40.0, 0.0]])
    assert_close(t_heaviside(tensor_from_numpy(x, device="cpu"), ETA), j_heaviside(jnp.asarray(x), ETA))


@pytest.mark.parametrize("var", VARS)
@pytest.mark.parametrize("prefix", DERIVS)
def test_pol_pack(setup, var, prefix):
    name = f"{prefix}{var}"
    port = getattr(setup["tcase"], name)(T_EVAL, setup["tg"].xx, setup["tg"].yy)
    ref = getattr(setup["jcase"], name)(T_EVAL, setup["jg"].xx, setup["jg"].yy)
    assert port.shape == (9, 9)
    assert_close(port, ref)


@pytest.mark.parametrize("term", ["fcp", "fT", "fcl", "fcd", "fcs"])
def test_forcing_term(setup, term):
    port = getattr(setup["tforce"], term)(setup["tg"], T_OPS, torch.tensor(T_EVAL, dtype=torch.float64))
    ref = getattr(setup["jforce"], term)(setup["jg"], J_OPS, T_EVAL)
    assert_close(port, ref)


@pytest.mark.parametrize("fname", ["Fcp", "FT", "Fcl", "Fcd", "Fcs"])
def test_field(setup, fname):
    ts = state_from_numpy(setup["state"], device="cpu")
    js = JState(**{k: jnp.asarray(v) for k, v in setup["state"].items()})
    port = getattr(setup["tfield"], fname)(setup["tg"], T_OPS, ts, torch.tensor(T_EVAL, dtype=torch.float64))
    ref = getattr(setup["jfield"], fname)(setup["jg"], J_OPS, js, T_EVAL)
    assert_close(port, ref)


@pytest.mark.parametrize("planes", ["stencil_dFT_dT", "stencil_dFcl_dcl", "stencil_dFcd_dcd"])
def test_self_jacobian_planes(setup, planes):
    ts = state_from_numpy(setup["state"], device="cpu")
    js = JState(**{k: jnp.asarray(v) for k, v in setup["state"].items()})
    port = getattr(setup["tfield"], planes)(setup["tg"], T_OPS, ts)
    ref = getattr(setup["jfield"], planes)(setup["jg"], J_OPS, js)
    for p, r in zip(port, ref):
        assert_close(p, r)
