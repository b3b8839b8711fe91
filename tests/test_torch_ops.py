"""The port's discretization layer against the JAX package on CPU float64:
grid metrics, shifts, stencils, inner products, ``avg_int`` and the Stencil5
plane builders, on a uniform and a non-uniform 8×6 grid, with random fields
from a fixed numpy seed.  Tolerance: 1e-14 relative to the reference's
max-norm (the two packages evaluate the same expressions in the same order;
only the summation order of reductions may differ)."""

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
    assert getattr(tg, name).dtype == torch.float64
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
