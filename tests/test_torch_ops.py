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
import math

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


# ---------------------------------------------------------------------------
# double-float arithmetic (ops/doublefloat.py) and the lift (ops/df_lift.py):
# the twins of tests/test_doublefloat.py and tests/test_df_lift.py at their
# tolerances, on seeded numpy inputs, and each DF function against the JAX
# package's on the same inputs
# ---------------------------------------------------------------------------
from na_dd_tpu.ops import doublefloat as j_dfm  # noqa: E402
from na_dd_tpu_torch.ops import doublefloat as dfm  # noqa: E402
from na_dd_tpu_torch.ops.df_lift import df_call, df_lift_report  # noqa: E402

F64, F32 = torch.float64, torch.float32


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _to64(d):
    return dfm.df_to(d, F64)


def _split(x):
    return dfm.df_split(_t(x))


def test_two_sum_exact():
    rng = np.random.default_rng(0)
    a = _t(rng.standard_normal(4096), F32)
    b = _t(rng.standard_normal(4096) * 1e-6, F32)
    s, e = dfm.two_sum(a, b)
    assert torch.equal(s.double() + e.double(), a.double() + b.double())


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a = _t(rng.standard_normal(4096), F32)
    b = _t(rng.standard_normal(4096), F32)
    p, e = dfm.two_prod(a, b)
    assert torch.equal(p.double() + e.double(), a.double() * b.double())


def test_split_roundtrip_and_accuracy():
    x = _t(np.random.default_rng(2).standard_normal((64, 64)))
    d = dfm.df_split(x)
    assert float(torch.max(torch.abs(_to64(d) - x) / torch.abs(x).max())) < 2e-14
    assert bool(torch.all(torch.abs(d.lo) <= torch.abs(d.hi) * 2.0 ** -23))


def test_df_add_cancellation():
    x = _t(np.random.default_rng(3).standard_normal(128))
    y = x * (1.0 + 1e-6) + 1e-9
    d = dfm.df_sub(dfm.df_split(y), dfm.df_split(x))
    assert float(torch.max(torch.abs(_to64(d) - (y - x)))) < 1e-13 * float(torch.abs(x).max())


@pytest.mark.parametrize("dim", [2, 3])
def test_df_stencil_residual_matches_f64(dim):
    """r = b − A·x in DF agrees with the float64 residual to ~2^-47·‖b‖ when
    r is 1e-6·‖b‖ (the refinement regime), in 2-D and in 3-D."""
    from na_dd_tpu_torch.three_d.diffusion import Stencil7
    from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

    rng = np.random.default_rng(4)
    cls, ops, shape = (
        (t_ls.Stencil5, T_OPS, (96, 96)) if dim == 2 else (Stencil7, LOCAL_OPS3, (20, 21, 22))
    )
    planes = [_t(rng.standard_normal(shape)) for _ in cls._fields]
    planes[0] = planes[0] + 4.0
    st = cls(*planes)
    x = _t(rng.standard_normal(shape))
    ax = st.apply(ops, x)
    b = ax * (1.0 + 1e-6)
    r64 = b - ax
    st_hi, st_lo = dfm.df_split_stencil(st)
    r_df = dfm.df_sub(dfm.df_split(b), dfm.df_stencil_apply(st_hi, st_lo, ops, dfm.df_split(x)))
    scale = float(torch.abs(b).max())
    assert float(torch.max(torch.abs(_to64(r_df) - r64))) < 1e-13 * scale
    hi_err = float(torch.max(torch.abs(r_df.hi.double() - r64)))
    assert hi_err < 1e-6 * float(torch.abs(r64).max()) + 1e-14 * scale


def test_df_mul_and_scale():
    rng = np.random.default_rng(5)
    a, b = _t(rng.standard_normal(256)), _t(rng.standard_normal(256))
    prod = _to64(dfm.df_mul(dfm.df_split(a), dfm.df_split(b)))
    assert float(torch.max(torch.abs(prod - a * b))) < 1e-13 * float(torch.abs(a * b).max())


def test_df_add_f32_accumulation():
    z = dfm.df_zeros_like(torch.zeros(64))
    ref = torch.zeros(64, dtype=F64)
    rng = np.random.default_rng(7)
    for i in range(8):
        e = _t(rng.standard_normal(64) * 10.0 ** (-i), F32)
        z = dfm.df_add_f32(z, e)
        ref = ref + e.double()
    assert float(torch.max(torch.abs(_to64(z) - ref))) < 1e-13


def test_df_exp_accuracy_wide_range():
    x = _t(np.concatenate([
        np.linspace(-87.0, 88.0, 4001), np.linspace(-2.0, 2.0, 4001),
        [0.0, 1.0, -1.0, 1e-8, -1e-8, 700.0, -1e6],
    ]))
    got = dfm.df_exp(dfm.df_split(x))
    ref = torch.exp(x)
    rel = torch.abs(_to64(got) - ref) / ref
    # full DF accuracy down to results of ~1e-24 (the port keeps float32
    # subnormals, which XLA flushes), float32-level below; the input pair
    # carries x to 2^-49 relative, |x|·2^-49 relative in exp
    inside = (ref > 1e-24) & (x < 88.0)
    gate = 3e-14 + torch.abs(x) * 2.0 ** -48
    assert float(torch.max(torch.where(inside, rel - gate, 0.0))) <= 0.0
    tiny = (x > -87.0) & ~inside & (x < 88.0)
    assert float(torch.max(torch.where(tiny, rel, 0.0))) < 5e-7
    assert float(_to64(got)[-1]) == 0.0 and float(_to64(got)[-2]) == math.inf
    i0 = int(torch.argmin(torch.abs(x)))
    assert float(got.hi[i0]) == 1.0 and float(got.lo[i0]) == 0.0


def test_df_logistic_accuracy():
    x = _t(np.linspace(-80.0, 80.0, 8001))
    got = _to64(dfm.df_logistic(dfm.df_split(x)))
    ref = torch.sigmoid(x)
    gate = torch.where(ref > 1e-24, 3e-14 + torch.abs(x) * 2.0 ** -48, 5e-7)
    assert float(torch.max(torch.abs(got - ref) / ref - gate)) <= 0.0
    cs = _t(np.linspace(-0.05, 0.05, 2001) * 1000.0)
    got = _to64(dfm.df_logistic(dfm.df_split(cs)))
    assert float(torch.max(torch.abs(got - torch.sigmoid(cs)) / torch.sigmoid(cs))) < 3e-14


def test_df_log_accuracy_and_domain():
    x = _t(np.concatenate([np.logspace(-30, 30, 4001), np.linspace(0.5, 1.5, 2001)]))
    err = torch.abs(_to64(dfm.df_log(dfm.df_split(x))) - torch.log(x))
    gate = 3e-14 * torch.clamp_min(torch.abs(torch.log(x)), 1.0) + 2e-38 / x
    assert float(torch.max(err - gate)) <= 0.0
    assert float(dfm.df_log(_split([0.0])).hi[0]) == -math.inf
    assert bool(torch.isnan(dfm.df_log(_split([-1.0])).hi[0]))


def test_df_pow_matches_f64_fractional_gammas():
    base = _t(np.abs(np.linspace(-0.4, 0.6, 2001)))
    for gamma in (1.1, 2.1, 3.1, 4.1):
        got = _to64(dfm.df_pow(dfm.df_split(base), dfm.df_split(torch.full_like(base, gamma))))
        ref = base ** gamma
        gate = (1.0 + torch.abs(gamma * torch.log(torch.clamp_min(base, 1e-300)))) * 2e-14
        assert float(torch.max(torch.abs(got - ref) - ref * gate - 1e-37)) <= 0.0
    z = dfm.df_pow(_split(np.zeros(3)), _split(np.full(3, 2.1)))
    assert bool(torch.all(z.hi == 0.0)) and bool(torch.all(z.lo == 0.0))


def test_df_sin_cos_accuracy():
    x = _t(np.concatenate([np.linspace(-20.0, 20.0, 8001), np.pi * np.linspace(0.0, 1.0, 257)]))
    d = dfm.df_split(x)
    assert float(torch.max(torch.abs(_to64(dfm.df_sin(d)) - torch.sin(x)))) < 1e-13
    assert float(torch.max(torch.abs(_to64(dfm.df_cos(d)) - torch.cos(x)))) < 1e-13


def test_df_tanh_and_sqrt_and_rsqrt():
    x = _t(np.linspace(-20.0, 20.0, 4001))
    assert float(torch.max(torch.abs(_to64(dfm.df_tanh(dfm.df_split(x))) - torch.tanh(x)))) < 3e-14
    y = _t(np.concatenate([np.zeros(4), np.logspace(-20, 20, 2001)]))
    got = dfm.df_sqrt(dfm.df_split(y))
    assert bool(torch.all(got.hi[:4] == 0.0)) and not bool(torch.any(torch.isnan(got.hi)))
    rel = torch.abs(_to64(dfm.DF(got.hi[4:], got.lo[4:])) - torch.sqrt(y[4:])) / torch.sqrt(y[4:])
    assert float(torch.max(rel)) < 3e-14
    r = _to64(dfm.df_rsqrt(dfm.df_split(y[4:])))
    assert float(torch.max(torch.abs(r - 1.0 / torch.sqrt(y[4:])) * torch.sqrt(y[4:]))) < 5e-14


def test_df_exp_through_the_lift():
    """exp reached through df_call (the lifted graph's entry point) is the
    DF exp: 3e-14 relative, no float64 passthrough."""
    x = _t(np.linspace(-5.0, 5.0, 101))
    df_lift_report(reset=True)
    got = df_call(torch.exp, x)
    assert got.dtype == F64
    assert float(torch.max(torch.abs(got - torch.exp(x)) / torch.exp(x))) < 3e-14
    assert df_lift_report() == {}


def _j(d):
    return j_dfm.df_to(d, jnp.float64)


def _both(fn_name, *xs):
    """The port's and the JAX package's DF function on the same float64
    inputs (split in each package), each reconstructed to float64."""
    port = getattr(dfm, fn_name)(*(dfm.df_split(_t(x)) for x in xs))
    ref = getattr(j_dfm, fn_name)(*(j_dfm.df_split(jnp.asarray(x)) for x in xs))
    return _to64(port).numpy(), np.asarray(_j(ref))


_DF_INPUTS = {
    "df_add": (lambda r: (r.standard_normal(512), r.standard_normal(512) * 1e-3), 4),
    "df_sub": (lambda r: (r.standard_normal(512), r.standard_normal(512)), 4),
    "df_mul": (lambda r: (r.standard_normal(512), r.standard_normal(512)), 4),
    "df_div": (lambda r: (r.standard_normal(512), r.uniform(0.5, 2.0, 512)), 4),
    "df_exp": (lambda r: (r.uniform(-40.0, 40.0, 512),), 8),
    "df_logistic": (lambda r: (r.uniform(-30.0, 30.0, 512),), 8),
    "df_log": (lambda r: (r.uniform(1e-3, 1e3, 512),), 8),
    "df_pow": (lambda r: (r.uniform(0.05, 2.0, 512), r.uniform(0.5, 4.5, 512)), 16),
    "df_sqrt": (lambda r: (r.uniform(0.0, 10.0, 512),), 4),
    "df_rsqrt": (lambda r: (r.uniform(0.01, 10.0, 512),), 4),
    "df_sin": (lambda r: (r.uniform(-20.0, 20.0, 512),), 8),
    "df_cos": (lambda r: (r.uniform(-20.0, 20.0, 512),), 8),
    "df_tanh": (lambda r: (r.uniform(-10.0, 10.0, 512),), 8),
}


@pytest.mark.parametrize("fn_name", list(_DF_INPUTS))
def test_df_function_matches_jax(fn_name):
    """Each DF function against ``na_dd_tpu.ops.doublefloat``'s on the same
    seeded inputs, away from the float32 subnormal range: within ``k`` DF
    ulps (2^-48) of the value's magnitude (at least 1)."""
    make, k = _DF_INPUTS[fn_name]
    port, ref = _both(fn_name, *make(np.random.default_rng(len(fn_name))))
    assert np.all(np.isfinite(port))
    assert np.max(np.abs(port - ref) / np.maximum(np.abs(ref), 1.0)) <= k * 2.0 ** -48


@pytest.mark.parametrize("fn_name", ["two_sum", "fast_two_sum", "two_prod"])
def test_eft_matches_jax_bit_for_bit(fn_name):
    """The error-free transformations give the JAX package's pairs exactly
    (one IEEE float32 operation a step in both)."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal(4096).astype(np.float32)
    b = (rng.standard_normal(4096) * 1e-3).astype(np.float32)
    port = getattr(dfm, fn_name)(_t(a, F32), _t(b, F32))
    ref = getattr(j_dfm, fn_name)(jnp.asarray(a), jnp.asarray(b))
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


def test_df_stencil_apply_and_split_match_jax():
    """df_split_stencil and df_stencil_apply against the JAX package's on
    one random Stencil5 and DF operand: ≤4 DF ulps of the apply's scale."""
    rng = np.random.default_rng(8)
    planes = [rng.standard_normal((17, 15)) for _ in range(5)]
    z = rng.standard_normal((17, 15))
    p_hi, p_lo = dfm.df_split_stencil(t_ls.Stencil5(*(_t(p) for p in planes)))
    j_hi, j_lo = j_dfm.df_split_stencil(j_ls.Stencil5(*(jnp.asarray(p) for p in planes)))
    for a, b in zip((*p_hi, *p_lo), (*j_hi, *j_lo)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    port = _to64(dfm.df_stencil_apply(p_hi, p_lo, T_OPS, dfm.df_split(_t(z)))).numpy()
    ref = np.asarray(_j(j_dfm.df_stencil_apply(j_hi, j_lo, J_OPS, j_dfm.df_split(jnp.asarray(z)))))
    assert np.max(np.abs(port - ref)) <= 4 * 2.0 ** -48 * np.max(np.abs(ref))


@pytest.fixture(scope="module")
def pol24():
    """The pol N=24 setup of tests/test_df_lift.py in both packages, the
    state the exact solution at t = 0.011."""
    from na_dd_tpu.harness.studies import _make_trial as j_make_trial
    from na_dd_tpu.harness.studies import study_consts as j_study_consts
    from na_dd_tpu.mms import cases as j_cases
    from na_dd_tpu.mms.engine import state_from_mms_when as j_state_from_mms_when
    from na_dd_tpu_torch.harness.studies import _make_trial, study_consts
    from na_dd_tpu_torch.mms import cases
    from na_dd_tpu_torch.mms.engine import state_from_mms_when

    jt = j_make_trial(j_cases.MMSCasePol, 24, 50.0, mc=j_study_consts("pol"), krylov_unroll=8)
    tt = _make_trial(cases.MMSCasePol, 24, 50.0, mc=study_consts("pol"), krylov_unroll=8,
                     device="cpu")
    js0 = j_state_from_mms_when(mms_case=jt.mms_case, t=0.011, grid=jt.grid)
    ts0 = state_from_mms_when(mms_case=tt.mms_case, t=0.011, grid=tt.grid)
    return (jt.grid, jt.integrator.semi_discrete_field, js0), (
        tt.grid, tt.integrator.semi_discrete_field, ts0)


def _gate(got, ref, tol=3e-13):
    # the JAX test's floor of the scale at 1e-20 (a noise-level plane)
    ref = np.asarray(ref)
    got = got.numpy()
    assert np.max(np.abs(got - ref)) <= tol * max(float(np.max(np.abs(ref))), 1e-20)


def test_df_lift_all_fields_matches_jax_f64(pol24):
    (jg, jfield, js0), (tg, tfield, ts0) = pol24
    ref = jfield.all_fields(jg, J_OPS, js0, 0.011)
    df_lift_report(reset=True)
    got = df_call(lambda s, t: tfield.all_fields(tg, T_OPS, s, t), ts0, 0.011)
    for name in ("cp", "T", "cl", "cd", "cs"):
        _gate(getattr(got, name), getattr(ref, name))
    assert df_lift_report() == {}


def test_df_lift_newton_planes_match_jax_f64(pol24):
    (jg, jfield, js0), (tg, tfield, ts0) = pol24

    def planes(field, g, ops, s):
        return (
            field.stencil_dFT_dT(g, ops, s), field.stencil_dFcl_dcl(g, ops, s),
            field.stencil_dFcd_dcd(g, ops, s), field.stencil_dFcl_dT(g, ops, s),
            field.stencil_dFcd_dT(g, ops, s), (field.diag_dFcd_dcl(g, s),),
        )

    ref = planes(jfield, jg, J_OPS, js0)
    got = df_call(lambda s: planes(tfield, tg, T_OPS, s), ts0)
    for st_ref, st_got in zip(ref, got):
        for p_ref, p_got in zip(st_ref, st_got):
            _gate(p_got, p_ref)


def test_df_lift_runs_without_passthrough(pol24):
    """The lifted field evaluation runs every operation by a DF rule: an
    empty report (the JAX test also jits the lift; the port has no trace)."""
    (_, _, _), (tg, tfield, ts0) = pol24
    df_lift_report(reset=True)
    got = df_call(lambda s, t: tfield.all_fields(tg, T_OPS, s, t), ts0, 0.011)
    ref = tfield.all_fields(tg, T_OPS, ts0, 0.011)
    assert got.T.dtype == F64
    _gate(got.T, ref.T.numpy())
    assert df_lift_report() == {}


def test_df_lift_sqrt_with_zeros_and_minmax_nan():
    x = _t(np.concatenate([np.zeros(3), np.linspace(0.5, 4.0, 61)]))

    def f(v):
        return torch.sqrt(v) + torch.maximum(v, _t(0.25)) - torch.minimum(v, _t(3.0))

    got = df_call(f, x)
    assert not bool(torch.any(torch.isnan(got)))
    _gate(got, f(x).numpy())
    xn = _t([1.0, math.nan, 2.0])
    got_max = df_call(lambda v: torch.maximum(v, _t(1.5)), xn)
    ref_max = torch.maximum(xn, _t(1.5))
    assert bool(torch.isnan(got_max[1])) and bool(torch.isnan(ref_max[1]))
    assert torch.allclose(got_max[::2], ref_max[::2])
