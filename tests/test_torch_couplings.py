"""The port's analytic cross-coupling Jacobians against the JAX package on CPU
float64, fed the same seeded numpy states, on a uniform and a non-uniform
grid, in 2-D (9 x 7 nodes) and 3-D (7 x 6 x 5 nodes):

* ``stencil_dFcl_dT``, ``stencil_dFcd_dT`` (with the model family's
  ``a_T = 0`` early return and with a subclass whose reaction depends on T),
  ``diag_dFcd_dcl`` and ``midpoint_coupling_planes3``: every plane ≤1e-13
  relative to the JAX plane's max-norm (the same closed forms evaluated in
  the same order);
* the same planes applied to a random increment against ``torch.func.jvp``
  of the port's own ``Fcl`` / ``Fcd`` on the interior: ≤1e-12 relative to the
  tangent's max-norm (the tangent and the planes differ by reassociation)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from na_dd_tpu.core import fields as j_fields
from na_dd_tpu.core.state import State as JState
from na_dd_tpu.harness.studies import POL_PEAKS_CONSTS as J_CONSTS
from na_dd_tpu.models.coefficients import Model02 as JModel02
from na_dd_tpu.ops import grid as j_grid
from na_dd_tpu.ops.shifts import LOCAL_OPS as J_OPS
from na_dd_tpu.three_d import diffusion as j_diff3
from na_dd_tpu.three_d import fields as j_fields3
from na_dd_tpu.three_d import grid as j_grid3
from na_dd_tpu.three_d.shifts import LOCAL_OPS3 as J_OPS3
from na_dd_tpu_torch.convert import (
    consts_from_dict,
    grid3_from_nodes,
    grid_from_nodes,
    state_from_numpy,
    tensor_from_numpy,
)
from na_dd_tpu_torch.core import fields as t_fields
from na_dd_tpu_torch.models.coefficients import Model02 as TModel02
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS as T_OPS
from na_dd_tpu_torch.three_d import diffusion as t_diff3
from na_dd_tpu_torch.three_d import fields as t_fields3
from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3 as T_OPS3

RTOL_PLANES = 1e-13
RTOL_JVP = 1e-12
ETA = 50.0
VARS = ("cp", "T", "cl", "cd", "cs")
A_T = (0.3, 1.0)  # a reaction that depends on T, to reach past the a_T = 0 return


def assert_close(port, ref, rtol):
    port = np.asarray(port.detach().cpu() if isinstance(port, torch.Tensor) else port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    assert float(np.max(np.abs(port - ref))) <= rtol * scale


class ZeroForcing:
    """State-independent forcing: its tangent is zero, so zeros serve."""

    def __init__(self, zeros):
        self._zeros = zeros

    def __getattr__(self, name):
        if name in ("fcp", "fT", "fcl", "fcd", "fcs"):
            return lambda g, ops, t: self._zeros
        raise AttributeError(name)


def _nodes(kind, counts):
    if kind == "uniform":
        return tuple(np.linspace(0.0, 1.0, n) for n in counts)
    rng = np.random.default_rng(11)
    return tuple(
        np.concatenate([[0.0], np.sort(rng.uniform(0.05, 0.95, n - 2)), [1.0]]) for n in counts
    )


def _with_T_reaction(cls):
    return type(cls.__name__ + "ReactT", (cls,), {"cscd_reaction_T": lambda self: A_T})


def _setup(kind, dim, reaction_T=False):
    """(jax grid, port grid, jax field, port field, ops pair, jax state, port
    state, increments) on the 2-D or 3-D grid of ``kind``."""
    jm = JModel02(J_CONSTS)
    tm = TModel02(consts_from_dict(J_CONSTS._asdict()))
    if dim == 2:
        x, y = _nodes(kind, (9, 7))
        jg, tg = j_grid.make_grid(x, y), grid_from_nodes(x, y, device="cpu")
        jcls, tcls = j_fields.FieldRegHCsTriple, t_fields.FieldRegHCsTriple
        ops = (J_OPS, T_OPS)
    else:
        x, y, z = _nodes(kind, (7, 6, 5))
        jg, tg = j_grid3.make_grid3(x, y, z), grid3_from_nodes(x, y, z, device="cpu")
        jcls, tcls = j_fields3.FieldRegHCsTriple3, t_fields3.FieldRegHCsTriple3
        ops = (J_OPS3, T_OPS3)
    if reaction_T:
        jcls, tcls = _with_T_reaction(jcls), _with_T_reaction(tcls)
    shape = tuple(tg.xx.shape)
    jfield = jcls(grid=jg, model=jm, forcing=ZeroForcing(jnp.zeros(shape)), regularization_factor=ETA)
    tfield = tcls(grid=tg, model=tm, forcing=ZeroForcing(torch.zeros(shape, dtype=torch.float64)),
                  regularization_factor=ETA)
    rng = np.random.default_rng(3)
    state = {v: 0.05 * rng.standard_normal(shape) for v in VARS}
    js = JState(**{k: jnp.asarray(v) for k, v in state.items()})
    ts = state_from_numpy(state, device="cpu")
    w = [tensor_from_numpy(rng.standard_normal(shape), device="cpu") * tg.interior_mask
         for _ in range(2)]
    return jg, tg, jfield, tfield, ops, js, ts, w


KINDS = ["uniform", "nonuniform"]
DIMS = [2, 3]


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("member", ["stencil_dFcl_dT", "stencil_dFcd_dT"])
@pytest.mark.parametrize("reaction_T", [False, True], ids=["aT0", "aT"])
def test_coupling_planes_match_jax(kind, dim, member, reaction_T):
    jg, tg, jfield, tfield, (j_ops, t_ops), js, ts, _ = _setup(kind, dim, reaction_T)
    port = getattr(tfield, member)(tg, t_ops, ts)
    ref = getattr(jfield, member)(jg, j_ops, js)
    assert len(port) == len(ref) == (5 if dim == 2 else 7)
    for p, r in zip(port, ref):
        assert_close(p, r, RTOL_PLANES)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("reaction_T", [False, True], ids=["aT0", "aT"])
def test_diag_dFcd_dcl_matches_jax(kind, dim, reaction_T):
    jg, tg, jfield, tfield, _, js, ts, _ = _setup(kind, dim, reaction_T)
    port = tfield.diag_dFcd_dcl(tg, ts)
    assert float(port.abs().max()) > 0.0
    assert_close(port, jfield.diag_dFcd_dcl(jg, js), RTOL_PLANES)


@pytest.mark.parametrize("kind", KINDS)
def test_midpoint_coupling_planes3_match_jax(kind):
    x, y, z = _nodes(kind, (7, 6, 5))
    jg, tg = j_grid3.make_grid3(x, y, z), grid3_from_nodes(x, y, z, device="cpu")
    rng = np.random.default_rng(7)
    coeffs = [rng.standard_normal((7, 6, 5)) for _ in range(3)]
    port = t_diff3.midpoint_coupling_planes3(tg, T_OPS3, *(tensor_from_numpy(a, device="cpu") for a in coeffs))
    ref = j_diff3.midpoint_coupling_planes3(jg, J_OPS3, *map(jnp.asarray, coeffs))
    assert isinstance(port, t_diff3.Stencil7)
    for p, r in zip(port, ref):
        assert_close(p, r, 1e-14)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("reaction_T", [False, True], ids=["aT0", "aT"])
def test_dFcl_dT_planes_match_jvp(kind, dim, reaction_T):
    _, tg, _, tfield, (_, ops), _, ts, (wT, _) = _setup(kind, dim, reaction_T)
    t = torch.tensor(0.003, dtype=torch.float64)
    _, tangent = torch.func.jvp(lambda T: tfield.Fcl(tg, ops, ts._replace(T=T), t), (ts.T,), (wT,))
    applied = tfield.stencil_dFcl_dT(tg, ops, ts).apply(ops, wT)
    m = tg.interior_mask
    assert float((tangent * m).abs().max()) > 0.0
    assert_close(applied * m, (tangent * m).numpy(), RTOL_JVP)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("reaction_T", [False, True], ids=["aT0", "aT"])
def test_dFcd_dT_and_dcl_match_jvp(kind, dim, reaction_T):
    _, tg, _, tfield, (_, ops), _, ts, (wT, wcl) = _setup(kind, dim, reaction_T)
    t = torch.tensor(0.003, dtype=torch.float64)
    _, tangent = torch.func.jvp(
        lambda T, cl: tfield.Fcd(tg, ops, ts._replace(T=T, cl=cl), t), (ts.T, ts.cl), (wT, wcl)
    )
    applied = tfield.stencil_dFcd_dT(tg, ops, ts).apply(ops, wT) + tfield.diag_dFcd_dcl(tg, ts) * wcl
    m = tg.interior_mask
    assert float((tangent * m).abs().max()) > 0.0
    assert_close(applied * m, (tangent * m).numpy(), RTOL_JVP)
