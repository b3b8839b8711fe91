"""The port's discretization layer against the JAX package on CPU float64:
grid metrics and colourings, shifts, stencils, inner products, ``avg_int``
and the Stencil5 plane builders, on a uniform and a non-uniform 8×6 grid,
with random fields from a fixed numpy seed.  Tolerance: 1e-14 relative to the
reference's max-norm (the two packages evaluate the same expressions in the
same order; only the summation order of reductions may differ).

The solver layer, same inputs through both packages: colour-probed planes
against the JAX package's probed and closed-form planes and two-colour
diagonals (≤1e-12), the while-form BiCGStab and the matrix-free Newton
solve (≤1e-12; the while form is bit for bit the port's unrolled solve
with a budget it exits inside)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from na_dd_tpu.ops import grid as j_grid
from na_dd_tpu.ops import inner_products as j_ip
from na_dd_tpu.ops import linsolve as j_ls
from na_dd_tpu.ops import stencils as j_st
from na_dd_tpu.ops.quadrature import avg_int as j_avg_int
from na_dd_tpu.ops.shifts import LOCAL_OPS as J_OPS
from na_dd_tpu_torch.convert import grid_from_nodes, tensor_from_numpy
from na_dd_tpu_torch.ops import grid as t_grid
from na_dd_tpu_torch.ops import inner_products as t_ip
from na_dd_tpu_torch.ops import linsolve as t_ls
from na_dd_tpu_torch.ops import stencils as t_st
from na_dd_tpu_torch.ops.quadrature import avg_int as t_avg_int
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS as T_OPS

RTOL = 1e-14


def assert_close(port, ref, rtol=RTOL):
    port = np.asarray(port.detach().cpu() if isinstance(port, torch.Tensor) else port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    assert float(np.max(np.abs(port - ref))) <= rtol * scale


def _nodes(kind):
    if kind == "uniform":
        return np.linspace(0.0, 1.0, 9), np.linspace(0.0, 1.0, 7)
    rng = np.random.default_rng(11)
    x = np.concatenate([[0.0], np.sort(rng.uniform(0.05, 0.95, 7)), [1.0]])
    y = np.concatenate([[0.0], np.sort(rng.uniform(0.05, 0.95, 5)), [1.0]])
    return x, y


@pytest.fixture(params=["uniform", "nonuniform"])
def grids(request):
    x, y = _nodes(request.param)
    return j_grid.make_grid(x, y), grid_from_nodes(x, y, device="cpu")


def _fields(n, seed=5, shape=(9, 7)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) for _ in range(n)]


def _t(a):
    return tensor_from_numpy(a, device="cpu")


GRID_FIELDS = [f.name for f in dataclasses.fields(t_grid.Grid) if f.name not in ("N", "M")]


@pytest.mark.parametrize("name", GRID_FIELDS)
def test_grid_metric(grids, name):
    jg, tg = grids
    assert (tg.N, tg.M) == (jg.N, jg.M)
    assert getattr(tg, name).dtype == (torch.int32 if name == "color5" else torch.float64)
    assert_close(getattr(tg, name), getattr(jg, name), rtol=0.0)


def test_uniform_grid_float32_on_request():
    g = t_grid.make_uniform_grid(8, 6, dtype=torch.float32, device="cpu")
    assert g.xx.dtype == torch.float32 and g.xx.shape == (9, 7)
    assert_close(g.inv_hh, np.asarray(j_grid.make_uniform_grid(8, 6).inv_hh), rtol=1e-7)


@pytest.mark.parametrize("name", ["shift_xm", "shift_xp", "shift_ym", "shift_yp", "asum", "amax"])
def test_shift_and_reduction(name):
    (u,) = _fields(1)
    # the shifts are exact; a sum may be taken in another order
    rtol = RTOL if name == "asum" else 0.0
    assert_close(getattr(T_OPS, name)(_t(u)), getattr(J_OPS, name)(jnp.asarray(u)), rtol=rtol)


@pytest.mark.parametrize("name", ["Mx", "My", "Dx_reg", "Dy_reg", "Dx_star", "Dy_star"])
def test_stencil_operator(grids, name):
    jg, tg = grids
    (u,) = _fields(1)
    assert_close(
        getattr(t_st, name)(T_OPS, tg, _t(u)), getattr(j_st, name)(J_OPS, jg, jnp.asarray(u))
    )


def test_grad_H(grids):
    jg, tg = grids
    (u,) = _fields(1)
    for port, ref in zip(t_st.grad_H(T_OPS, tg, _t(u)), j_st.grad_H(J_OPS, jg, jnp.asarray(u))):
        assert_close(port, ref)


@pytest.mark.parametrize("name", ["inner_H", "inner_pk", "inner_hp"])
def test_inner_product(grids, name):
    jg, tg = grids
    u, v = _fields(2)
    assert_close(
        getattr(t_ip, name)(T_OPS, tg, _t(u), _t(v)),
        getattr(j_ip, name)(J_OPS, jg, jnp.asarray(u), jnp.asarray(v)),
    )


@pytest.mark.parametrize("name", ["norm_H", "norm_pk", "norm_hp"])
def test_norm(grids, name):
    jg, tg = grids
    (u,) = _fields(1)
    assert_close(getattr(t_ip, name)(T_OPS, tg, _t(u)), getattr(j_ip, name)(J_OPS, jg, jnp.asarray(u)))


def test_inner_p_and_norm_p(grids):
    jg, tg = grids
    a, b, c, d = _fields(4)
    assert_close(
        t_ip.inner_p(T_OPS, tg, _t(a), _t(b), _t(c), _t(d)),
        j_ip.inner_p(J_OPS, jg, *(jnp.asarray(z) for z in (a, b, c, d))),
    )
    assert_close(
        t_ip.norm_p(T_OPS, tg, _t(a), _t(b)), j_ip.norm_p(J_OPS, jg, jnp.asarray(a), jnp.asarray(b))
    )


def test_avg_int(grids):
    jg, tg = grids
    port = t_avg_int(lambda x, y: torch.sin(3.0 * x) * torch.exp(y) + x * y**2, tg, T_OPS)
    ref = j_avg_int(lambda x, y: jnp.sin(3.0 * x) * jnp.exp(y) + x * y**2, jg, J_OPS)
    assert_close(port, ref)


def _plane_pair(builder, jg, tg, fields):
    port = getattr(t_ls, builder)(tg, T_OPS, *(_t(f) for f in fields))
    ref = getattr(j_ls, builder)(jg, J_OPS, *(jnp.asarray(f) for f in fields))
    return port, ref


@pytest.mark.parametrize("builder", ["diffusion_planes", "advection_planes", "midpoint_coupling_planes"])
def test_plane_builder(grids, builder):
    jg, tg = grids
    port, ref = _plane_pair(builder, jg, tg, _fields(2, seed=7))
    for p, r in zip(port, ref):
        assert_close(p, r)


def test_newton_planes_add_diag_and_apply(grids):
    jg, tg = grids
    ax, ay, d, w = _fields(4, seed=8)
    port, ref = _plane_pair("diffusion_planes", jg, tg, (ax, ay))
    port = t_ls.stencil_add_diag(t_ls.newton_planes(tg, T_OPS, port, 2.5e-3), _t(d))
    ref = j_ls.stencil_add_diag(j_ls.newton_planes(jg, J_OPS, ref, 2.5e-3), jnp.asarray(d))
    for p, r in zip(port, ref):
        assert_close(p, r)
    assert_close(port.apply(T_OPS, _t(w)), ref.apply(J_OPS, jnp.asarray(w)))


# ---------------------------------------------------------------------------
# colour probing, the while form and the matrix-free Newton solve
# ---------------------------------------------------------------------------
RTOL_SOLVE = 1e-12
SEED = 20260816


def _field_pair(variant, jg, tg):
    """The JAX and port fields of ``variant`` on the pair of grids, no
    forcing, default constants."""
    from na_dd_tpu.core import fields as j_fields
    from na_dd_tpu.core.forcing import NoForcing as JNoForcing
    from na_dd_tpu.models import Model02 as JModel02
    from na_dd_tpu.models import default_model_consts as j_consts
    from na_dd_tpu_torch.convert import consts_from_dict
    from na_dd_tpu_torch.core import fields as t_fields
    from na_dd_tpu_torch.core.forcing import NoForcing as TNoForcing
    from na_dd_tpu_torch.models.coefficients import Model02 as TModel02

    name = {"cs": "FieldCsTriple", "hcs": "FieldHCsTriple", "reg": "FieldRegHCsTriple"}[variant]
    kw = {"regularization_factor": 50.0} if variant == "reg" else {}
    jm = JModel02(j_consts)
    tm = TModel02(consts_from_dict(j_consts._asdict()))
    return (getattr(j_fields, name)(grid=jg, model=jm, forcing=JNoForcing(), **kw),
            getattr(t_fields, name)(grid=tg, model=tm, forcing=TNoForcing(), **kw))


def _random_state_pair(shape, interior, seed=SEED):
    from na_dd_tpu.core.state import State as JState
    from na_dd_tpu_torch.core.state import State as TState

    rng = np.random.default_rng(seed)
    vals = [rng.standard_normal(shape) * interior for _ in range(5)]
    vals[1] = np.abs(vals[1]) + 0.5 * interior  # T, as tests/test_analytic_stencils.py
    return JState(*(jnp.asarray(v) for v in vals)), TState(*(_t(v) for v in vals))


@pytest.mark.parametrize("variant", ["cs", "hcs", "reg"])
def test_probed_planes_match_jax_probed_and_analytic(grids, variant):
    """tests/test_analytic_stencils.py:63 on both packages: 5-colour probes
    of the masked Newton matvec of FT/Fcl/Fcd linearized at a random state
    equal the closed-form Newton planes and the JAX package's probes."""
    import jax

    jg, tg = grids
    jf, tf = _field_pair(variant, jg, tg)
    js, ts = _random_state_pair(tuple(jg.xx.shape), np.asarray(jg.interior_mask))
    t1, dt = 0.37, 1e-3
    for name, planes, fn in (("T", "stencil_dFT_dT", "FT"), ("cl", "stencil_dFcl_dcl", "Fcl"),
                             ("cd", "stencil_dFcd_dcd", "Fcd")):
        _f0, jlin = jax.linearize(
            lambda w: getattr(jf, fn)(jg, J_OPS, js._replace(**{name: w}), t1), getattr(js, name))
        jm = jg.interior_mask
        j_probed = j_ls.probe_stencil(lambda w: (2.0 * (w * jm) - dt * jlin(w * jm)) * jm, jg)
        _tf0, tlin = t_ls.linearized(
            lambda w: getattr(tf, fn)(tg, T_OPS, ts._replace(**{name: w}), t1), getattr(ts, name))
        tm = tg.interior_mask
        t_probed = t_ls.probe_stencil(lambda w: (2.0 * (w * tm) - dt * tlin(w * tm)) * tm, tg)
        analytic = t_ls.newton_planes(tg, T_OPS, getattr(tf, planes)(tg, T_OPS, ts), dt)
        for plane, p, jp, a in zip(t_probed._fields, t_probed, j_probed, analytic):
            assert_close(p, jp, RTOL_SOLVE)
            assert_close(p, a.detach().numpy(), RTOL_SOLVE)


def _random_stencil_pair(g_shape, interior, seed, diag_dominant=True):
    """Random Stencil5 planes with the Newton planes' structure (masked rows,
    ``mask·shift(mask)`` off-diagonals), as both packages' objects."""
    rng = np.random.default_rng(seed)
    m = interior
    shifted = [T_OPS.shift_xm, T_OPS.shift_xp, T_OPS.shift_ym, T_OPS.shift_yp]
    c0 = (rng.random(g_shape) + (4.0 if diag_dominant else 0.5)) * m
    offs = [0.5 * rng.random(g_shape) * m * sh(_t(m)).numpy() for sh in shifted]
    planes = [c0, *offs]
    return j_ls.Stencil5(*(jnp.asarray(a) for a in planes)), t_ls.Stencil5(*(_t(a) for a in planes))


def test_checkerboard_and_probe_diag_match_jax():
    jg, tg = j_grid.make_uniform_grid(6, 5), t_grid.make_uniform_grid(6, 5, device="cpu")
    m = np.asarray(jg.interior_mask)
    jst, tst = _random_stencil_pair(tuple(jg.xx.shape), m, SEED)
    tred, tblack = t_ls.checkerboard_masks(tg)
    jred, jblack = j_ls.checkerboard_masks(jg)
    assert_close(tred, jred, rtol=0.0)
    assert_close(tblack, jblack, rtol=0.0)
    diag = t_ls.probe_diag(lambda w: tst.apply(T_OPS, w), tred * tg.interior_mask,
                           tblack * tg.interior_mask)
    ref = j_ls.probe_diag(lambda w: jst.apply(J_OPS, w), jred * jg.interior_mask,
                          jblack * jg.interior_mask)
    assert_close(diag, ref, rtol=0.0)
    assert_close(diag, (tst.c0 * tg.interior_mask).numpy(), rtol=0.0)


@pytest.mark.parametrize("diag_dominant", [True, False])
def test_bicgstab_while_form_matches_jax(diag_dominant):
    """tests/test_linsolve.py:49 on both packages: the while form to 1e-14;
    the port's equals its unrolled solve with a budget it exits inside, bit
    for bit, and the JAX package's to 1e-12."""
    jg, tg = j_grid.make_uniform_grid(6, 7), t_grid.make_uniform_grid(6, 7, device="cpu")
    m = np.asarray(jg.interior_mask)
    jst, tst = _random_stencil_pair(tuple(jg.xx.shape), m, SEED + 1, diag_dominant)
    x_true = np.random.default_rng(SEED + 2).random(m.shape) * m
    tb = tst.apply(T_OPS, _t(x_true))
    jb = jst.apply(J_OPS, jnp.asarray(x_true))
    tdot = lambda u, v: T_OPS.asum(u * v)  # noqa: E731
    jdot = lambda u, v: J_OPS.asum(u * v)  # noqa: E731
    x, info = t_ls.bicgstab(lambda w: tst.apply(T_OPS, w), tb, torch.zeros_like(tb), dot=tdot,
                            tol=1e-14, maxiter=500)
    jx, jinfo = j_ls.bicgstab(lambda w: jst.apply(J_OPS, w), jb, jnp.zeros_like(jb), dot=jdot,
                              tol=1e-14, maxiter=500)
    # the sums' order differs, so the exit may fall one iteration apart at
    # a tolerance this close to rounding
    assert abs(int(info["iters"]) - int(jinfo["iters"])) <= 1 and int(info["iters"]) < 500
    assert bool(info["converged"])
    assert_close(x, jx, RTOL_SOLVE)
    assert float(np.max(np.abs(x.numpy() - x_true))) < 1e-10
    xu, infou = t_ls.bicgstab_unrolled(lambda w: tst.apply(T_OPS, w), tb, torch.zeros_like(tb),
                                       dot=tdot, tol=1e-14, iters=int(info["iters"]) + 5)
    assert torch.equal(xu, x) and int(infou["iters"]) == int(info["iters"])


def test_bicgstab_while_form_stops_at_maxiter():
    jg = j_grid.make_uniform_grid(6, 7)
    tg = t_grid.make_uniform_grid(6, 7, device="cpu")
    _jst, tst = _random_stencil_pair(tuple(jg.xx.shape), np.asarray(jg.interior_mask), SEED + 3,
                                     diag_dominant=False)
    b = tst.apply(T_OPS, tg.interior_mask)
    _x, info = t_ls.bicgstab(lambda w: tst.apply(T_OPS, w), b, torch.zeros_like(b),
                             dot=lambda u, v: T_OPS.asum(u * v), tol=1e-30, maxiter=3)
    assert int(info["iters"]) == 3 and not bool(info["converged"])


def test_newton_inner_solve_matches_jax():
    """tests/test_linsolve.py:155's nonlinear stencil residual through both
    packages' matrix-free Newton solve: F(u0), Δ and the iteration count."""
    jg, tg = j_grid.make_uniform_grid(5, 6), t_grid.make_uniform_grid(5, 6, device="cpu")
    rng = np.random.default_rng(SEED + 4)
    u0, coef, rhs = rng.random((6, 7)), rng.random((6, 7)) + 0.5, rng.random((6, 7))
    m = np.asarray(jg.interior_mask)
    rhs = rhs * m

    def residual(ops, mask, c):
        def fn(u):
            lap = ops.shift_xm(u) + ops.shift_xp(u) + ops.shift_ym(u) + ops.shift_yp(u) - 4.0 * u
            return (lap * c - u * u) * mask
        return fn

    jred, jblack = j_ls.checkerboard_masks(jg)
    jf0, jd, jinfo = j_ls.newton_inner_solve(
        residual(J_OPS, jg.interior_mask, jnp.asarray(coef)), jnp.asarray(u0), jnp.asarray(rhs),
        jg, J_OPS, 1e-2, red=jred, black=jblack, tol=1e-14, maxiter=500)
    tred, tblack = t_ls.checkerboard_masks(tg)
    tf0, td, tinfo = t_ls.newton_inner_solve(
        residual(T_OPS, tg.interior_mask, _t(coef)), _t(u0), _t(rhs), tg, T_OPS, 1e-2,
        red=tred, black=tblack, tol=1e-14, maxiter=500)
    assert_close(tf0, jf0)
    assert_close(td, jd, RTOL_SOLVE)
    assert int(tinfo["iters"]) == int(jinfo["iters"])
    assert float(td.abs().mul(1 - tg.interior_mask).max()) == 0.0
