"""The port's kernel wrappers (ops/kernels.py) on the CPU, where they run
their plain PyTorch twins, against the JAX package's Pallas kernels in
interpret mode: ``stencil5_apply`` vs ``stencil5_apply_pallas``,
and ``stencil5_apply_tiled`` (row tiles of 8 on ragged shapes),
``bicgstab_solve`` vs ``bicgstab_solve_pallas``, ``triple_solve`` vs
``triple_solve_pallas``, ``stencil7_apply`` vs ``stencil7_apply_pallas`` and
``stencil7_apply_tiled``, and ``bicgstab_solve3`` vs
``bicgstab_solve3_pallas``, float64 and float32, with identical iteration
counts.  Tolerances, relative to the reference's max-norm: 1e-12 in float64
and 1e-5 in float32 (the reductions are summed in another order); the triple
solve's ``tol_sq`` thresholds 1e-12 / 1e-5 relative, its recurrence residuals
1e-10 / 1e-4 relative plus the rounding floor 16 eps² (b·b) (a converged
residual is what cancellation left of r, so near that floor its own relative
difference is noise).  The CUDA kernels themselves are held against the plain
versions in tests/test_torch_gpu.py, which needs a card."""

import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from na_dd_tpu.ops import linsolve as j_ls
from na_dd_tpu.ops.pallas_kernels import (
    bicgstab_solve3_pallas,
    bicgstab_solve_pallas,
    stencil5_apply_pallas,
    stencil5_apply_tiled,
    stencil7_apply_pallas,
    stencil7_apply_tiled,
    triple_solve_pallas,
)
from na_dd_tpu.ops.shifts import LOCAL_OPS as J_OPS
from na_dd_tpu.three_d.diffusion import Stencil7 as JStencil7
from na_dd_tpu_torch.convert import stencil5_from_numpy, stencil7_from_numpy, tensor_from_numpy
from na_dd_tpu_torch.ops import kernels
from na_dd_tpu_torch.ops import linsolve as t_ls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}
DTYPES = [torch.float64, torch.float32]


def assert_close(port, ref, rtol):
    port = np.asarray(port.detach().cpu(), dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert port.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    assert float(np.max(np.abs(port - ref))) <= rtol * scale


def _system(seed, shape, dtype):
    """A diagonally dominant Stencil5 (2-D shape) or Stencil7 (3-D shape)
    system with a zero boundary, the shape of a Newton system: planes, rhs,
    Jacobi inverse diagonal, mask."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(shape)
    mask[(slice(1, -1),) * len(shape)] = 1.0
    c0 = (4.5 + 2.0 * (len(shape) - 2) + rng.random(shape)) * mask
    planes = [c0] + [-rng.random(shape) * mask for _ in range(2 * len(shape))]
    b = rng.standard_normal(shape) * mask
    inv = np.where(mask > 0, 1.0 / np.where(c0 == 0, 1.0, c0), 0.0)
    npd = NP_DTYPE[dtype]
    return [p.astype(npd) for p in planes], b.astype(npd), inv.astype(npd), mask.astype(npd)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(9, 9), (11, 6)])
def test_stencil5_apply_plain_vs_pallas(dtype, shape):
    rng = np.random.default_rng(21)
    npd = NP_DTYPE[dtype]
    planes = [rng.standard_normal(shape).astype(npd) for _ in range(5)]
    u = rng.standard_normal(shape).astype(npd)
    port = kernels.stencil5_apply(stencil5_from_numpy(planes, dtype, "cpu"), tensor_from_numpy(u, dtype, "cpu"))
    ref = stencil5_apply_pallas(j_ls.Stencil5(*map(jnp.asarray, planes)), jnp.asarray(u), interpret=True)
    assert port.dtype == dtype
    assert_close(port, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(33, 33), (40, 17), (9, 129), (129, 65)])
def test_stencil5_apply_plain_vs_tiled_ragged(dtype, shape):
    """K3's row-tiled form (tiles of 8 rows with halo blocks) on its own
    ragged test shapes."""
    rng = np.random.default_rng(31)
    npd = NP_DTYPE[dtype]
    planes = [rng.standard_normal(shape).astype(npd) for _ in range(5)]
    u = rng.standard_normal(shape).astype(npd)
    port = kernels.stencil5_apply(stencil5_from_numpy(planes, dtype, "cpu"), tensor_from_numpy(u, dtype, "cpu"))
    ref = stencil5_apply_tiled(
        j_ls.Stencil5(*map(jnp.asarray, planes)), jnp.asarray(u), row_tile=8, interpret=True
    )
    assert_close(port, ref, TOL[dtype])


def _triple_operands(seed, shape, dtype):
    """Operands of the fused triple solve as numpy arrays, in its argument
    order: three Newton systems, two unstructured coupling stencils, the
    diagonal coupling, three rhs pieces, three Jacobi diagonals, the mask."""
    rng = np.random.default_rng(seed)
    npd = NP_DTYPE[dtype]
    systems = [_system(seed + 10 * k, shape, dtype) for k in range(3)]
    couplings = [[rng.standard_normal(shape).astype(npd) for _ in range(5)] for _ in range(2)]
    d_cdcl, rhs_T, base_cl, base_cd = (rng.standard_normal(shape).astype(npd) for _ in range(4))
    mask = systems[0][3]
    return ([s[0] for s in systems], couplings, d_cdcl, (rhs_T, base_cl, base_cd),
            [s[2] for s in systems], mask)


@functools.lru_cache(maxsize=None)
def _triple_both(seed, shape, dtype, *, tol, iters, dt=0.05):
    """(port result, JAX interpret-mode result) on the same operands."""
    Js, Cs, d_cdcl, rhs, invs, mask = _triple_operands(seed, shape, dtype)
    t = lambda a: tensor_from_numpy(a, dtype, "cpu")  # noqa: E731
    port = kernels.triple_solve(
        *(stencil5_from_numpy(p, dtype, "cpu") for p in Js + Cs), t(d_cdcl),
        *map(t, rhs), *map(t, invs), t(mask), dt, tol=tol, iters=iters,
    )
    ref = triple_solve_pallas(
        *(j_ls.Stencil5(*map(jnp.asarray, p)) for p in Js + Cs), jnp.asarray(d_cdcl),
        *map(jnp.asarray, rhs), *map(jnp.asarray, invs), jnp.asarray(mask), dt,
        tol=tol, iters=iters, interpret=True,
    )
    return port, ref


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(9, 8), (12, 17)])
def test_triple_solve_plain_vs_pallas(dtype, shape):
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    port, ref = _triple_both(41, shape, dtype, tol=tol, iters=14)
    p_info, r_info = port[3], ref[3]
    assert p_info["iters"].tolist() == np.asarray(r_info["iters"]).tolist()
    assert min(p_info["iters"].tolist()) > 0
    assert p_info["converged"].tolist() == np.asarray(r_info["converged"]).tolist() == [True] * 3
    for p, r in zip(port[:3], ref[:3]):
        assert p.dtype == dtype
        assert_close(p, r, TOL[dtype])
    res_p = p_info["resnorm_sq"].double().numpy()
    res_r = np.asarray(r_info["resnorm_sq"], dtype=np.float64)
    floor = 16.0 * torch.finfo(dtype).eps ** 2 * p_info["tol_sq"].double().numpy() / (tol * tol)
    rtol = 1e-10 if dtype == torch.float64 else 1e-4
    assert np.all(np.abs(res_p - res_r) <= rtol * res_r + floor)


@pytest.mark.parametrize("dtype", DTYPES)
def test_triple_solve_tol_sq_is_of_the_masked_coupled_rhs(dtype):
    """tol_sq[k] = tol² (b_k·b_k) with b_k the masked rhs after the coupling
    term is added, rebuilt here from the reference's own increments."""
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    dt = 0.05
    Js, Cs, d_cdcl, rhs, invs, mask = _triple_operands(41, (9, 8), dtype)
    port, ref = _triple_both(41, (9, 8), dtype, tol=tol, iters=14, dt=dt)
    dT, dcl = (np.asarray(x, dtype=np.float64) for x in ref[:2])

    def apply(planes, w):
        pad = np.pad(w, 1)
        c0, cxm, cxp, cym, cyp = (np.asarray(p, dtype=np.float64) for p in planes)
        return (c0 * w + cxm * pad[:-2, 1:-1] + cxp * pad[2:, 1:-1]
                + cym * pad[1:-1, :-2] + cyp * pad[1:-1, 2:])

    b = [
        rhs[0] * mask,
        (rhs[1] + dt * apply(Cs[0], dT)) * mask,
        (rhs[2] + dt * (apply(Cs[1], dT) + d_cdcl * dcl)) * mask,
    ]
    expect = np.array([tol * tol * np.sum(np.asarray(x, dtype=np.float64) ** 2) for x in b])
    got = port[3]["tol_sq"].double().numpy()
    assert np.all(np.abs(got - expect) <= TOL[dtype] * expect)


@pytest.mark.parametrize("iters", [1, 2])
def test_triple_solve_budget_cut_matches_pallas(iters):
    """A budget that ends before convergence: same iterates, same counts,
    the same not-converged flags, and here the recurrence residual (no
    cancellation yet) agrees relatively."""
    port, ref = _triple_both(43, (9, 8), torch.float64, tol=1e-13, iters=iters)
    p_info, r_info = port[3], ref[3]
    assert p_info["iters"].tolist() == np.asarray(r_info["iters"]).tolist() == [iters] * 3
    assert p_info["converged"].tolist() == np.asarray(r_info["converged"]).tolist() == [False] * 3
    for p, r in zip(port[:3], ref[:3]):
        assert_close(p, r, 1e-12)
    res_r = np.asarray(r_info["resnorm_sq"])
    assert np.all(np.abs(p_info["resnorm_sq"].numpy() - res_r) <= 1e-10 * res_r)


def test_triple_solve_outputs_are_masked():
    port, _ = _triple_both(41, (9, 8), torch.float64, tol=1e-13, iters=14)
    for x in port[:3]:
        assert float(x[0].abs().max()) == float(x[:, -1].abs().max()) == 0.0
        assert float(x.abs().max()) > 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_bicgstab_solve_plain_vs_pallas(dtype):
    planes, b, inv, mask = _system(22, (9, 8), dtype)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    port_x, port_info = kernels.bicgstab_solve(
        stencil5_from_numpy(planes, dtype, "cpu"),
        *(tensor_from_numpy(a, dtype, "cpu") for a in (b, inv, mask)),
        tol=tol, iters=14,
    )
    ref_x, ref_info = bicgstab_solve_pallas(
        j_ls.Stencil5(*map(jnp.asarray, planes)), *map(jnp.asarray, (b, inv, mask)),
        tol=tol, iters=14, interpret=True,
    )
    assert int(port_info["iters"]) == int(ref_info["iters"]) > 0
    assert bool(port_info["converged"]) == bool(ref_info["converged"]) is True
    assert_close(port_x, ref_x, TOL[dtype])
    assert float(port_info["resnorm_sq"]) <= tol * tol * float(np.sum(b.astype(np.float64) ** 2))


@pytest.mark.parametrize("iters", [1, 3])
def test_bicgstab_solve_budget_cut_matches_pallas(iters):
    """A budget that ends before convergence: same iterate, same count, both
    report not converged."""
    planes, b, inv, mask = _system(23, (9, 8), torch.float64)
    port_x, port_info = kernels.bicgstab_solve(
        stencil5_from_numpy(planes, device="cpu"),
        *(tensor_from_numpy(a, device="cpu") for a in (b, inv, mask)),
        tol=1e-13, iters=iters,
    )
    ref_x, ref_info = bicgstab_solve_pallas(
        j_ls.Stencil5(*map(jnp.asarray, planes)), *map(jnp.asarray, (b, inv, mask)),
        tol=1e-13, iters=iters, interpret=True,
    )
    assert int(port_info["iters"]) == int(ref_info["iters"]) == iters
    assert not bool(port_info["converged"]) and not bool(ref_info["converged"])
    assert_close(port_x, ref_x, 1e-12)


def test_bicgstab_unrolled_matches_jax():
    planes, b, inv, _mask = _system(24, (8, 7), torch.float64)
    t_st = stencil5_from_numpy(planes, device="cpu")
    j_st = j_ls.Stencil5(*map(jnp.asarray, planes))
    tb, tinv = tensor_from_numpy(b, device="cpu"), tensor_from_numpy(inv, device="cpu")
    port_x, port_info = t_ls.bicgstab_unrolled(
        lambda w: t_st.apply(kernels.LOCAL_OPS, w), tb, torch.zeros_like(tb),
        dot=lambda u, v: torch.sum(u * v), minv=lambda r: r * tinv, tol=1e-13, iters=10,
    )
    ref_x, ref_info = j_ls.bicgstab_unrolled(
        lambda w: j_st.apply(J_OPS, w), jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)),
        dot=lambda u, v: jnp.sum(u * v), minv=lambda r: r * jnp.asarray(inv), tol=1e-13, iters=10,
    )
    assert int(port_info["iters"]) == int(ref_info["iters"])
    assert_close(port_x, ref_x, 1e-12)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(7, 6, 5), (9, 4, 11)])
def test_stencil7_apply_plain_vs_pallas(dtype, shape):
    rng = np.random.default_rng(51)
    npd = NP_DTYPE[dtype]
    planes = [rng.standard_normal(shape).astype(npd) for _ in range(7)]
    u = rng.standard_normal(shape).astype(npd)
    port = kernels.stencil7_apply(stencil7_from_numpy(planes, dtype, "cpu"), tensor_from_numpy(u, dtype, "cpu"))
    ref = stencil7_apply_pallas(JStencil7(*map(jnp.asarray, planes)), jnp.asarray(u), interpret=True)
    assert port.dtype == dtype
    assert_close(port, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_stencil7_apply_plain_vs_tiled_ragged(dtype):
    """K7's slab-tiled form on a volume whose 9 x-slabs do not divide into
    tiles of 2."""
    shape = (9, 6, 5)
    rng = np.random.default_rng(52)
    npd = NP_DTYPE[dtype]
    planes = [rng.standard_normal(shape).astype(npd) for _ in range(7)]
    u = rng.standard_normal(shape).astype(npd)
    port = kernels.stencil7_apply(stencil7_from_numpy(planes, dtype, "cpu"), tensor_from_numpy(u, dtype, "cpu"))
    ref = stencil7_apply_tiled(JStencil7(*map(jnp.asarray, planes)), jnp.asarray(u), slab_tile=2, interpret=True)
    assert_close(port, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 7, 6), (12, 12, 12)])
def test_bicgstab_solve3_plain_vs_pallas(dtype, shape):
    planes, b, inv, mask = _system(53, shape, dtype)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    port_x, port_info = kernels.bicgstab_solve3(
        stencil7_from_numpy(planes, dtype, "cpu"),
        *(tensor_from_numpy(a, dtype, "cpu") for a in (b, inv, mask)),
        tol=tol, iters=24,
    )
    ref_x, ref_info = bicgstab_solve3_pallas(
        JStencil7(*map(jnp.asarray, planes)), *map(jnp.asarray, (b, inv, mask)),
        tol=tol, iters=24, interpret=True,
    )
    assert int(port_info["iters"]) == int(ref_info["iters"]) > 0
    assert bool(port_info["converged"]) == bool(ref_info["converged"]) is True
    assert_close(port_x, ref_x, TOL[dtype])


def test_zero_rhs_takes_no_iteration():
    planes, b, inv, mask = _system(25, (6, 6), torch.float64)
    x, info = kernels.bicgstab_solve(
        stencil5_from_numpy(planes, device="cpu"),
        *(tensor_from_numpy(a, device="cpu") for a in (np.zeros_like(b), inv, mask)),
        tol=1e-13, iters=5,
    )
    assert int(info["iters"]) == 0 and bool(info["converged"])
    assert float(x.abs().max()) == 0.0


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """No build, no launch and no count for CPU tensors."""

    def refuse(name):
        raise AssertionError(f"kernel library {name} requested for a CPU tensor")

    monkeypatch.setattr(kernels, "_lib", refuse)
    kernels.reset_launch_counts()
    planes, b, inv, mask = _system(26, (7, 7), torch.float64)
    st = stencil5_from_numpy(planes, device="cpu")
    tb, tinv, tmask = (tensor_from_numpy(a, device="cpu") for a in (b, inv, mask))
    assert torch.equal(kernels.stencil5_apply(st, tb), kernels.stencil5_apply_plain(st, tb))
    xk, ik = kernels.bicgstab_solve(st, tb, tinv, tmask, tol=1e-13, iters=8)
    xp, ip = kernels.bicgstab_solve_plain(st, tb, tinv, tmask, tol=1e-13, iters=8)
    assert torch.equal(xk, xp) and int(ik["iters"]) == int(ip["iters"])
    st7 = stencil7_from_numpy(_system(28, (5, 6, 4), torch.float64)[0], device="cpu")
    u7 = tensor_from_numpy(np.ones((5, 6, 4)), device="cpu")
    assert torch.equal(kernels.stencil7_apply(st7, u7), kernels.stencil7_apply_plain(st7, u7))
    xk, ik = kernels.bicgstab_solve3(st7, u7, u7, u7, tol=1e-13, iters=3)
    xp, ip = kernels.bicgstab_solve3_plain(st7, u7, u7, u7, tol=1e-13, iters=3)
    assert torch.equal(xk, xp) and int(ik["iters"]) == int(ip["iters"])
    Js, Cs, d_cdcl, rhs, invs, tmask3 = _triple_operands(29, (7, 7), torch.float64)
    t = lambda a: tensor_from_numpy(a, device="cpu")  # noqa: E731
    operands = (*(stencil5_from_numpy(p, device="cpu") for p in Js + Cs), t(d_cdcl),
                *map(t, rhs), *map(t, invs), t(tmask3), 0.05)
    *xk, ik = kernels.triple_solve(*operands, tol=1e-13, iters=8)
    *xp, ip = kernels.triple_solve_plain(*operands, tol=1e-13, iters=8)
    assert all(torch.equal(a, b) for a, b in zip(xk, xp)) and torch.equal(ik["iters"], ip["iters"])
    assert set(kernels.LAUNCHES) == {
        "stencil5_apply", "bicgstab_solve", "stencil7_apply", "bicgstab_solve3", "triple_solve"
    }
    assert all(count == 0 for count in kernels.LAUNCHES.values())


def test_non_cpu_non_cuda_tensor_is_refused():
    planes, b, _inv, _mask = _system(27, (5, 5), torch.float64)
    st = t_ls.Stencil5(*(torch.as_tensor(p, device="meta") for p in planes))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        kernels.stencil5_apply(st, torch.as_tensor(b, device="meta"))


def test_kernels_module_imports_without_nvcc_or_triton():
    code = (
        "import sys, shutil\n"
        "import na_dd_tpu_torch.ops.kernels as k\n"
        "assert shutil.which('nvcc') is None\n"
        "assert 'triton' not in sys.modules\n"
        "assert k._LIBS == {} and k.BUILD_INFO == {}\n"
    )
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


# ---------------------------------------------------------------------------
# The solve kernel's pass schedule (csrc/bicgstab.cuh), replayed in torch
# ---------------------------------------------------------------------------
def _safe_div(num, den):
    ok = bool(torch.abs(den) > torch.tensor(1e-300, dtype=den.dtype))
    return (num / den if ok else torch.zeros_like(num)), ok


def _three_pass_schedule(apply, b, inv, mask, *, tol, iters, form_b=None):
    """BiCGStab from x0 = 0 in the order the CUDA solve runs it: iteration 0
    specialised (p' = b + 0, b·b taken in its first pass), p' and v' in
    ping-pong buffers, s recomputed in passes B and C and never stored, r
    written only in pass C, x·mask written by every pass C.  ``form_b``
    (K4): the rhs is formed in iteration 0's pass A, once where the
    neighbours' D⁻¹p' read it and once more at the own point, where it is
    stored for the later passes (``b`` is then unused).  Returns (x·mask,
    iterations used, r·r at exit, whether the exit was on s_conv)."""
    dot = lambda u, v: torch.sum(u * v)  # noqa: E731
    if form_b is None:
        phat0 = (b + 0.0) * inv
    else:
        phat0 = (form_b() + 0.0) * inv  # recomputed at the neighbours
        b = form_b()  # formed at the own point and stored
    P, V = [None, b + 0.0], [None, None]
    V[1] = apply(phat0)  # pass A of iteration 0
    rv, bb = dot(b, V[1]), dot(b, b)
    tol_sq = tol * tol * bb
    rr = rhat_r = bb
    if rr <= tol_sq or iters <= 0:
        return 0.0 * mask, 0, rr, False
    rho = alpha = omega = torch.ones((), dtype=b.dtype)
    r, x_work, used = b, None, 0
    for it in range(iters):
        rho1, ok1, ok2 = rhat_r, True, True
        if it > 0:  # pass A
            ratio, ok1 = _safe_div(rho1, rho)
            aw, ok2 = _safe_div(alpha, omega)
            beta = ratio * aw
            P[(it + 1) % 2] = r + beta * (P[it % 2] - omega * V[it % 2])
            V[(it + 1) % 2] = apply(P[(it + 1) % 2] * inv)
            rv = dot(b, V[(it + 1) % 2])
        p_new, v_new = P[(it + 1) % 2], V[(it + 1) % 2]
        alpha_new, ok3 = _safe_div(rho1, rv)
        s = r - alpha_new * v_new  # pass B
        t = apply(s * inv)
        s_conv = bool(dot(s, s) <= tol_sq)
        omega_new, ok4 = _safe_div(dot(t, s), dot(t, t))
        last = s_conv or not (ok1 and ok2 and ok3 and ok4) or it + 1 >= iters
        s = r - alpha_new * v_new  # pass C
        x_half = (0.0 if it == 0 else x_work) + alpha_new * (p_new * inv)
        x = x_half if s_conv else x_half + omega_new * (s * inv)
        r = s if s_conv else s - omega_new * t
        out = x * mask
        x_work = None if last else x
        rr, rhat_r = dot(r, r), dot(b, r)
        rho, alpha, omega = rho1, alpha_new, omega_new
        used += 1
        if last or bool(rr <= tol_sq):
            break
    return out, used, rr, s_conv


def _schedule_case(case, shape):
    """A system of the schedule tests: 'dominant' (random, diagonally
    dominant), 'zero_rhs' (b = 0), 'diagonal' (A = c0·I, which exits on
    s_conv in iteration 1)."""
    planes, b, inv, mask = _system(61, shape, torch.float64)
    if case == "zero_rhs":
        b = np.zeros_like(b)
    elif case == "diagonal":
        planes = [planes[0]] + [np.zeros_like(p) for p in planes[1:]]
    to_stencil = stencil5_from_numpy if len(shape) == 2 else stencil7_from_numpy
    st = to_stencil(planes, device="cpu")
    return st, *(tensor_from_numpy(a, device="cpu") for a in (b, inv, mask))


@pytest.mark.parametrize(
    "case, shape, iters",
    [
        ("dominant", (12, 17), 40),  # budget past convergence
        ("dominant", (9, 9), 3),  # budget cut
        ("dominant", (9, 8, 7), 24),
        ("dominant", (5, 5, 5), 2),
        ("zero_rhs", (9, 9), 5),
        ("zero_rhs", (5, 5, 5), 5),
        ("diagonal", (9, 9), 8),
        ("diagonal", (5, 6, 7), 8),
    ],
)
def test_three_pass_schedule_matches_bicgstab_unrolled(case, shape, iters):
    """The kernel's schedule computes bicgstab_unrolled bit for bit: the same
    x·mask, r·r and iteration count, in float64."""
    st, b, inv, mask = _schedule_case(case, shape)
    ops = kernels.LOCAL_OPS if len(shape) == 2 else kernels.LOCAL_OPS3
    apply = lambda w: st.apply(ops, w)  # noqa: E731
    x, used, rr, s_conv = _three_pass_schedule(apply, b, inv, mask, tol=1e-13, iters=iters)
    ref_x, info = t_ls.bicgstab_unrolled(
        apply, b, torch.zeros_like(b), dot=lambda u, v: torch.sum(u * v),
        minv=lambda r: r * inv, tol=1e-13, iters=iters,
    )
    assert used == int(info["iters"])
    assert float(rr) == float(info["resnorm_sq"])
    assert torch.equal(x, ref_x * mask)  # the same operations in the same order
    if case == "zero_rhs":
        assert used == 0 and float(x.abs().max()) == 0.0
    if case == "diagonal":
        assert used == 1 and s_conv
    if case == "dominant" and iters < 5:
        assert used == iters  # the budget ends the solve
    elif case == "dominant":
        assert 2 < used < iters  # converged inside the budget


# ---------------------------------------------------------------------------
# K4's sweep as the CUDA kernel runs it (csrc/triple_solve.cu), replayed
# ---------------------------------------------------------------------------
def _triple_schedule(operands, *, tol, iters):
    """K4 in the order the kernel runs it: the T rhs read as rhs_T·m, each
    coupled rhs formed in its solve's iteration-0 pass A (recomputed at the
    neighbours, stored at the own point), no pass of K4's own between the
    solves.  Returns what :func:`kernels.triple_solve_plain` returns."""
    (J_T, J_cl, J_cd, C_clT, C_cdT, d_cdcl, rhs_T, base_cl, base_cd,
     invd_T, invd_cl, invd_cd, mask, dt) = operands
    infos = []

    def solve(J, form_b, inv):
        x, used, rr, _ = _three_pass_schedule(
            lambda w: J.apply(kernels.LOCAL_OPS, w), None, inv, mask,
            tol=tol, iters=iters, form_b=form_b)
        b = form_b()
        infos.append((torch.tensor(used, dtype=torch.int32), rr, tol * tol * torch.sum(b * b)))
        return x

    dT = solve(J_T, lambda: rhs_T * mask, invd_T)
    dcl = solve(J_cl, lambda: (base_cl + dt * C_clT.apply(kernels.LOCAL_OPS, dT)) * mask, invd_cl)
    dcd = solve(
        J_cd,
        lambda: (base_cd + dt * (C_cdT.apply(kernels.LOCAL_OPS, dT) + d_cdcl * dcl)) * mask,
        invd_cd,
    )
    its, res, tol_sq = (torch.stack(v) for v in zip(*infos))
    return dT, dcl, dcd, {"iters": its, "resnorm_sq": res, "tol_sq": tol_sq,
                          "converged": res <= tol_sq}


def _triple_case(case, shape, dtype):
    """K4's operands (numpy) for the schedule tests: 'random', or
    'zero_rhs_T' (rhs_T = 0 with base_cl, base_cd nonzero: the T solve takes
    no iteration, the case that needs the kernel's sync after it), or
    'diagonal_T' (J_T = c0·I: the T solve ends on s_conv)."""
    Js, Cs, d_cdcl, rhs, invs, mask = _triple_operands(71, shape, dtype)
    if case == "zero_rhs_T":
        rhs = (np.zeros_like(rhs[0]), rhs[1], rhs[2])
    elif case == "diagonal_T":
        Js = [[Js[0][0]] + [np.zeros_like(p) for p in Js[0][1:]]] + Js[1:]
    return Js, Cs, d_cdcl, rhs, invs, mask


def _torch_triple(arrays, dtype, dt=0.05):
    Js, Cs, d_cdcl, rhs, invs, mask = arrays
    t = lambda a: tensor_from_numpy(a, dtype, "cpu")  # noqa: E731
    return (*(stencil5_from_numpy(p, dtype, "cpu") for p in Js + Cs), t(d_cdcl),
            *map(t, rhs), *map(t, invs), t(mask), dt)


SCHEDULE_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(17, 17), (33, 20)])
@pytest.mark.parametrize(
    "case, iters", [("random", 40), ("random", 1), ("zero_rhs_T", 40), ("diagonal_T", 40)]
)
def test_triple_schedule_matches_triple_solve_plain(case, iters, shape, dtype):
    """The kernel's sweep computes triple_solve_plain bit for bit: the same
    increments, iteration counts, recurrence residuals and tol_sq."""
    operands = _torch_triple(_triple_case(case, shape, dtype), dtype)
    tol = SCHEDULE_TOL[dtype]
    *xs, info_s = _triple_schedule(operands, tol=tol, iters=iters)
    *xp, info_p = kernels.triple_solve_plain(*operands, tol=tol, iters=iters)
    for key in ("iters", "resnorm_sq", "tol_sq", "converged"):
        assert torch.equal(info_s[key], info_p[key]), key
    assert all(torch.equal(a, b) for a, b in zip(xs, xp))
    used = info_s["iters"].tolist()
    if case == "zero_rhs_T":
        assert used[0] == 0 and float(xs[0].abs().max()) == 0.0 and min(used[1:]) > 0
    elif case == "diagonal_T":
        assert used[0] == 1 and min(used[1:]) > 1
    elif iters == 1:
        assert used == [1, 1, 1]


@functools.lru_cache(maxsize=None)
def _jitted_triple_pallas(tol, iters):
    import jax

    return jax.jit(functools.partial(triple_solve_pallas, tol=tol, iters=iters, interpret=True))


@pytest.mark.parametrize("case", ["random", "zero_rhs_T"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(17, 17), (33, 20)])
def test_triple_schedule_matches_pallas(shape, dtype, case):
    """The kernel's sweep against triple_solve_pallas in interpret mode (a
    budget of 6: float64 runs it out, float32 converges), same iteration
    counts; increments within 1e-12 (float64) and 1e-5 (float32, whose sums
    run in another order) of the reference's max-norm."""
    arrays = _triple_case(case, shape, dtype)
    tol, iters = SCHEDULE_TOL[dtype], 6
    *xs, info_s = _triple_schedule(_torch_triple(arrays, dtype), tol=tol, iters=iters)
    Js, Cs, d_cdcl, rhs, invs, mask = arrays
    ref = _jitted_triple_pallas(tol, iters)(
        *(j_ls.Stencil5(*map(jnp.asarray, p)) for p in Js + Cs), jnp.asarray(d_cdcl),
        *map(jnp.asarray, rhs), *map(jnp.asarray, invs), jnp.asarray(mask), 0.05,
    )
    assert info_s["iters"].tolist() == np.asarray(ref[3]["iters"]).tolist()
    assert info_s["converged"].tolist() == np.asarray(ref[3]["converged"]).tolist()
    for x, r in zip(xs, ref[:3]):
        if case == "zero_rhs_T" and x is xs[0]:
            assert float(x.abs().max()) == float(np.abs(np.asarray(r)).max()) == 0.0
        else:
            assert_close(x, r, TOL[dtype])
