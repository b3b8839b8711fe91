"""The hand-written CUDA kernels (K1, K2/K3, K4 on planes; K5, K6/K7 on
volumes) against their plain PyTorch versions on a card.  Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is false; the file imports nothing of JAX, so
on a machine with a card and no JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances, relative to the plain version's max-norm: 1e-12 in float64 and
1e-5 in float32 (the kernels sum in another order and contract to FMA); the
fused triple solve's ``tol_sq`` 1e-10 / 1e-4 relative."""

import numpy as np
import pytest
import torch

from na_dd_tpu_torch.convert import stencil5_from_numpy, stencil7_from_numpy, tensor_from_numpy
from na_dd_tpu_torch.ops import kernels

pytestmark = pytest.mark.gpu

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
KRYLOV_TOL = {torch.float64: 1e-13, torch.float32: 1e-5}
DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return "cuda"


def assert_close(port, ref, rtol):
    port = port.detach().double().cpu()
    ref = ref.detach().double().cpu()
    assert port.shape == ref.shape
    assert float((port - ref).abs().max()) <= rtol * max(float(ref.abs().max()), 1e-300)


def _system(seed, shape, dtype, device):
    """A diagonally dominant Stencil5 (2-D shape) or Stencil7 (3-D shape)
    system with a zero boundary."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(shape)
    mask[(slice(1, -1),) * len(shape)] = 1.0
    c0 = (4.5 + 2.0 * (len(shape) - 2) + rng.random(shape)) * mask
    planes = [c0] + [-rng.random(shape) * mask for _ in range(2 * len(shape))]
    b = rng.standard_normal(shape) * mask
    inv = np.where(mask > 0, 1.0 / np.where(c0 == 0, 1.0, c0), 0.0)
    to_stencil = stencil5_from_numpy if len(shape) == 2 else stencil7_from_numpy
    st = to_stencil(planes, dtype, device)
    return st, *(tensor_from_numpy(a, dtype, device) for a in (b, inv, mask))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(257, 257), (257, 130), (5, 3)])
def test_stencil5_apply_kernel_vs_plain(card, dtype, shape):
    rng = np.random.default_rng(31)
    st = stencil5_from_numpy([rng.standard_normal(shape) for _ in range(5)], dtype, card)
    u = tensor_from_numpy(rng.standard_normal(shape), dtype, card)
    kernels.reset_launch_counts()
    out = kernels.stencil5_apply(st, u)
    assert kernels.LAUNCHES["stencil5_apply"] == 1
    assert out.device.type == "cuda" and out.dtype == dtype
    assert_close(out, kernels.stencil5_apply_plain(st, u), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(257, 257), (129, 70)])
def test_bicgstab_solve_kernel_vs_plain(card, dtype, shape):
    st, b, inv, mask = _system(32, shape, dtype, card)
    kernels.reset_launch_counts()
    xk, ik = kernels.bicgstab_solve(st, b, inv, mask, tol=KRYLOV_TOL[dtype], iters=40)
    assert kernels.LAUNCHES == {
        "stencil5_apply": 1, "bicgstab_solve": 1, "stencil7_apply": 0, "bicgstab_solve3": 0,
        "triple_solve": 0,
    }
    xp, ip = kernels.bicgstab_solve_plain(st, b, inv, mask, tol=KRYLOV_TOL[dtype], iters=40)
    assert int(ik["iters"]) == int(ip["iters"]) > 0
    assert bool(ik["converged"]) and bool(ip["converged"])
    assert_close(xk, xp, TOL[dtype])


@pytest.mark.parametrize("iters", [0, 1, 2])
def test_bicgstab_solve_kernel_budget_cut(card, iters):
    st, b, inv, mask = _system(33, (65, 65), torch.float64, card)
    xk, ik = kernels.bicgstab_solve(st, b, inv, mask, tol=1e-13, iters=iters)
    xp, ip = kernels.bicgstab_solve_plain(st, b, inv, mask, tol=1e-13, iters=iters)
    assert int(ik["iters"]) == int(ip["iters"]) == iters
    assert_close(xk, xp, 1e-12)


def test_kernel_refuses_non_contiguous_operands(card):
    st, b, inv, mask = _system(34, (17, 17), torch.float64, card)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.stencil5_apply(st, b.t())
    with pytest.raises(ValueError, match="must match"):
        kernels.bicgstab_solve(st, b.float(), inv, mask, tol=1e-13, iters=4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(33, 33, 33), (65, 65, 65), (129, 129, 129), (50, 65, 33), (3, 4, 5)])
def test_stencil7_apply_kernel_vs_plain(card, dtype, shape):
    rng = np.random.default_rng(35)
    st = stencil7_from_numpy([rng.standard_normal(shape) for _ in range(7)], dtype, card)
    u = tensor_from_numpy(rng.standard_normal(shape), dtype, card)
    kernels.reset_launch_counts()
    out = kernels.stencil7_apply(st, u)
    assert kernels.LAUNCHES["stencil7_apply"] == 1
    assert out.device.type == "cuda" and out.dtype == dtype
    assert_close(out, kernels.stencil7_apply_plain(st, u), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(65, 65, 65), (33, 20, 41)])
def test_bicgstab_solve3_kernel_vs_plain(card, dtype, shape):
    st, b, inv, mask = _system(36, shape, dtype, card)
    kernels.reset_launch_counts()
    xk, ik = kernels.bicgstab_solve3(st, b, inv, mask, tol=KRYLOV_TOL[dtype], iters=24)
    assert kernels.LAUNCHES == {
        "stencil5_apply": 0, "bicgstab_solve": 0, "stencil7_apply": 1, "bicgstab_solve3": 1,
        "triple_solve": 0,
    }
    xp, ip = kernels.bicgstab_solve3_plain(st, b, inv, mask, tol=KRYLOV_TOL[dtype], iters=24)
    assert int(ik["iters"]) == int(ip["iters"]) > 0
    assert bool(ik["converged"]) and bool(ip["converged"])
    assert_close(xk, xp, TOL[dtype])


@pytest.mark.parametrize("iters", [0, 1, 2])
def test_bicgstab_solve3_kernel_budget_cut(card, iters):
    st, b, inv, mask = _system(37, (17, 19, 21), torch.float64, card)
    xk, ik = kernels.bicgstab_solve3(st, b, inv, mask, tol=1e-13, iters=iters)
    xp, ip = kernels.bicgstab_solve3_plain(st, b, inv, mask, tol=1e-13, iters=iters)
    assert int(ik["iters"]) == int(ip["iters"]) == iters
    assert_close(xk, xp, 1e-12)


def test_3d_kernels_refuse_planes_and_mixed_operands(card):
    st, b, inv, mask = _system(38, (9, 9, 9), torch.float64, card)
    with pytest.raises(ValueError, match="3-D volumes"):
        kernels.stencil7_apply(type(st)(*(c[0] for c in st)), b[0])
    with pytest.raises(ValueError, match="must match"):
        kernels.bicgstab_solve3(st, b, inv.float(), mask, tol=1e-13, iters=4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1025, 1025), (2049, 1025), (33, 33), (40, 17), (9, 129), (129, 65)])
def test_stencil5_apply_kernel_vs_plain_large_and_ragged(card, dtype, shape):
    """The shapes where the TPU used its row-tiled kernel."""
    rng = np.random.default_rng(39)
    st = stencil5_from_numpy([rng.standard_normal(shape) for _ in range(5)], dtype, card)
    u = tensor_from_numpy(rng.standard_normal(shape), dtype, card)
    kernels.reset_launch_counts()
    out = kernels.stencil5_apply(st, u)
    assert kernels.LAUNCHES["stencil5_apply"] == 1
    assert_close(out, kernels.stencil5_apply_plain(st, u), TOL[dtype])


def _triple(seed, shape, dtype, device):
    """Operands of the fused triple solve: three dominant Newton systems, two
    unstructured coupling stencils, random diagonal coupling and rhs pieces."""
    rng = np.random.default_rng(seed)
    systems = [_system(seed + 10 * k, shape, dtype, device) for k in range(3)]
    couplings = [stencil5_from_numpy([rng.standard_normal(shape) for _ in range(5)], dtype, device)
                 for _ in range(2)]
    planes = [tensor_from_numpy(rng.standard_normal(shape), dtype, device) for _ in range(4)]
    return (*(s[0] for s in systems), *couplings, *planes, *(s[2] for s in systems),
            systems[0][3], 0.05)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(257, 257), (130, 257), (1025, 1025)])
def test_triple_solve_kernel_vs_plain(card, dtype, shape):
    operands = _triple(40, shape, dtype, card)
    kernels.reset_launch_counts()
    *xk, ik = kernels.triple_solve(*operands, tol=KRYLOV_TOL[dtype], iters=40)
    assert kernels.LAUNCHES == {
        "stencil5_apply": 0, "bicgstab_solve": 0, "stencil7_apply": 0, "bicgstab_solve3": 0,
        "triple_solve": 1,
    }
    *xp, ip = kernels.triple_solve_plain(*operands, tol=KRYLOV_TOL[dtype], iters=40)
    assert ik["iters"].tolist() == ip["iters"].tolist() and min(ik["iters"].tolist()) > 0
    assert ik["converged"].tolist() == ip["converged"].tolist() == [True] * 3
    for a, b in zip(xk, xp):
        assert a.device.type == "cuda" and a.dtype == dtype
        assert_close(a, b, TOL[dtype])
    rel = (ik["tol_sq"] - ip["tol_sq"]).abs() / ip["tol_sq"]
    assert float(rel.max()) <= (1e-10 if dtype == torch.float64 else 1e-4)


# Grids that leave threads without points: 9 x 9 is one block; 130 x 257
# takes 66 blocks at K4's two points a thread, the last one part full; 33 x 20
# takes two.
RAGGED = [(9, 9), (130, 257), (33, 20)]


@pytest.mark.parametrize("iters", [0, 1, 2])
@pytest.mark.parametrize("shape", [(65, 65)] + RAGGED)
def test_triple_solve_kernel_budget_cut(card, shape, iters):
    operands = _triple(41, shape, torch.float64, card)
    *xk, ik = kernels.triple_solve(*operands, tol=1e-13, iters=iters)
    *xp, ip = kernels.triple_solve_plain(*operands, tol=1e-13, iters=iters)
    assert ik["iters"].tolist() == ip["iters"].tolist() == [iters] * 3
    assert ik["converged"].tolist() == ip["converged"].tolist() == [False] * 3
    for a, b in zip(xk, xp):
        assert_close(a, b, 1e-12)
    rel = (ik["resnorm_sq"] - ip["resnorm_sq"]).abs() / ip["resnorm_sq"]
    assert float(rel.max()) <= 1e-10


def _stack(items):
    if isinstance(items[0], tuple):
        return type(items[0])(*(torch.stack(c) for c in zip(*items)))
    return torch.stack(items)


def _triple_stack(seed, shape, nsys, dtype, device):
    """``nsys`` sets of triple-solve operands stacked (B, n0, n1), one dt a
    system (a float64 tensor, as the batched ladder passes it); system 0's
    rhs_T is 0, so its T solve ends before its first iteration while the
    others iterate."""
    sets = [_triple(seed + k, shape, dtype, device) for k in range(nsys)]
    operands = [_stack([s[i] for s in sets]) for i in range(13)]
    operands[6][0].zero_()
    dt = torch.tensor([0.02 * (k + 1) for k in range(nsys)], dtype=torch.float64, device=device)
    return (*operands, dt)


def _system_of(operands, k):
    return tuple(type(t)(*(c[k] for c in t)) if isinstance(t, tuple) else t[k] for t in operands)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape, nsys", [((65, 65), 4), ((33, 20), 3), ((9, 9), 2)])
def test_batched_triple_solve_kernel_vs_plain(card, dtype, shape, nsys):
    """One launch for the stack against the plain stack, and each system
    against the unbatched kernel on it alone: equal (B, 3) iteration counts,
    increments within the dtype's tolerance."""
    operands = _triple_stack(44, shape, nsys, dtype, card)
    kernels.reset_launch_counts()
    *xk, ik = kernels.triple_solve(*operands, tol=KRYLOV_TOL[dtype], iters=40)
    assert kernels.LAUNCHES["triple_solve"] == 1
    *xp, ip = kernels.triple_solve_plain(*operands, tol=KRYLOV_TOL[dtype], iters=40)
    assert ik["iters"].shape == (nsys, 3) and ik["iters"].tolist() == ip["iters"].tolist()
    assert ik["iters"][0, 0] == 0 and int(ik["iters"][1:].min()) > 0
    assert ik["converged"].tolist() == ip["converged"].tolist()
    for a, b in zip(xk, xp):
        for k in range(nsys):
            assert_close(a[k], b[k], TOL[dtype])
    for k in range(nsys):
        *x1, i1 = kernels.triple_solve(*_system_of(operands, k), tol=KRYLOV_TOL[dtype], iters=40)
        assert i1["iters"].tolist() == ik["iters"][k].tolist()
        for a, b in zip(xk, x1):
            assert_close(a[k], b, TOL[dtype])


def test_triple_solve_batch_of_one_is_the_single_kernel(card):
    """A stack of one system launches the single-system kernel: bit for bit
    the unbatched call, dt as a float or as a one-element tensor."""
    operands = _triple(45, (257, 257), torch.float64, card)
    *x1, i1 = kernels.triple_solve(*operands, tol=1e-13, iters=40)
    one = [_stack([t]) if isinstance(t, (tuple, torch.Tensor)) else t for t in operands]
    for dt in (0.05, torch.tensor([0.05], dtype=torch.float64, device=card)):
        one[-1] = dt
        *xb, ib = kernels.triple_solve(*one, tol=1e-13, iters=40)
        assert ib["iters"].tolist() == [i1["iters"].tolist()]
        for a, b in zip(xb, x1):
            assert torch.equal(a[0], b)


def test_triple_solve_refuses_mixed_operands(card):
    operands = list(_triple(42, (17, 17), torch.float64, card))
    operands[6] = operands[6].float()  # rhs_T
    with pytest.raises(ValueError, match="must match"):
        kernels.triple_solve(*operands, tol=1e-13, iters=4)


def _edge_case(case, system):
    """'zero_rhs': b = 0 (the solve ends before its first iteration);
    'diagonal': A = c0·I (it ends on s_conv in iteration 1); 'dominant': the
    system as it is."""
    st, b, inv, mask = system
    if case == "zero_rhs":
        b = torch.zeros_like(b)
    elif case == "diagonal":
        st = type(st)(st[0], *(torch.zeros_like(c) for c in st[1:]))
    return st, b, inv, mask


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "case, shape",
    [
        ("zero_rhs", (65, 65)), ("diagonal", (65, 65)),
        ("dominant", (9, 9)),  # fewer points than one block has threads
        ("dominant", (130, 257)),  # ragged: 130 x 257 = 130.5 blocks
        ("zero_rhs", (17, 19, 21)), ("diagonal", (17, 19, 21)),
        ("dominant", (5, 5, 5)), ("dominant", (33, 20, 41)),
    ],
)
def test_solve_kernels_edge_cases(card, dtype, case, shape):
    """K1 (planes) and K5 (volumes) against their plain versions where the
    schedule of the solve branches: no iteration, an exit on s_conv, grids
    smaller than one block and ragged ones, a budget past convergence."""
    if len(shape) == 2:
        solve, plain = kernels.bicgstab_solve, kernels.bicgstab_solve_plain
    else:
        solve, plain = kernels.bicgstab_solve3, kernels.bicgstab_solve3_plain
    st, b, inv, mask = _edge_case(case, _system(43, shape, dtype, card))
    budget = 40
    xk, ik = solve(st, b, inv, mask, tol=KRYLOV_TOL[dtype], iters=budget)
    xp, ip = plain(st, b, inv, mask, tol=KRYLOV_TOL[dtype], iters=budget)
    used = int(ik["iters"])
    assert used == int(ip["iters"])
    assert bool(ik["converged"]) and bool(ip["converged"])
    if case == "zero_rhs":
        assert used == 0 and float(xk.abs().max()) == 0.0
    else:
        assert_close(xk, xp, TOL[dtype])
    if case == "diagonal":
        assert used == 1
    if case == "dominant":
        assert 0 < used < budget


@pytest.mark.parametrize(
    "case, shape",
    [("zero_rhs", (65, 65)), ("diagonal", (65, 65)), ("dominant", (9, 9)), ("dominant", (130, 257))]
    + [(case, shape) for case in ("zero_rhs_T", "diagonal_T") for shape in RAGGED + [(257, 257)]],
)
def test_triple_solve_kernel_edge_cases(card, case, shape):
    """K4 against its plain version where its sweep branches.  'zero_rhs_T':
    the T solve takes no iteration and writes dT after its only barrier, which
    cl's rhs then reads at every neighbour; 'diagonal_T': it ends on s_conv."""
    operands = list(_triple(44, shape, torch.float64, card))
    if case == "zero_rhs":  # rhs_T, base_cl, base_cd
        operands[6:9] = [torch.zeros_like(t) for t in operands[6:9]]
    elif case == "zero_rhs_T":
        operands[6] = torch.zeros_like(operands[6])
    elif case == "diagonal":  # J_T, J_cl, J_cd
        operands[:3] = [_edge_case(case, (J, None, None, None))[0] for J in operands[:3]]
    elif case == "diagonal_T":
        operands[0] = _edge_case("diagonal", (operands[0], None, None, None))[0]
    *xk, ik = kernels.triple_solve(*operands, tol=1e-13, iters=40)
    *xp, ip = kernels.triple_solve_plain(*operands, tol=1e-13, iters=40)
    used = ik["iters"].tolist()
    assert used == ip["iters"].tolist()
    assert ik["converged"].tolist() == ip["converged"].tolist() == [True] * 3
    if case == "zero_rhs":
        assert used == [0] * 3 and all(float(x.abs().max()) == 0.0 for x in xk)
    else:
        for a, b in zip(xk, xp):
            assert_close(a, b, 1e-12)
    if case == "diagonal":
        assert used == [1] * 3
    if case == "dominant":
        assert all(0 < u < 40 for u in used)
    if case in ("zero_rhs_T", "diagonal_T"):
        assert used[0] == (0 if case == "zero_rhs_T" else 1) and min(used[1:]) > 0


@pytest.mark.parametrize("grid", ["one block", "seven blocks", "one a SM", "rule"])
@pytest.mark.parametrize("shape", [(33, 20), (130, 257)])
def test_triple_solve_kernel_at_other_grids(card, monkeypatch, shape, grid):
    """K4 on grids other than its rule's (chip_smoke.py's grid table times
    them): the grid-stride passes and the sums over the blocks hold on any
    co-resident grid."""
    operands = _triple(48, shape, torch.float64, card)
    n = shape[0] * shape[1]
    kernels.triple_solve(*operands, tol=1e-13, iters=1)  # the rule's grid
    key = ("triple_solve", torch.float64, n)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    need = -(-n // 256)
    blocks = {"one block": 1, "seven blocks": min(7, need), "one a SM": min(sms, need),
              "rule": kernels._BLOCKS[key]}[grid]
    monkeypatch.setitem(kernels._BLOCKS, key, blocks)
    *xk, ik = kernels.triple_solve(*operands, tol=1e-13, iters=40)
    *xp, ip = kernels.triple_solve_plain(*operands, tol=1e-13, iters=40)
    assert ik["iters"].tolist() == ip["iters"].tolist()
    assert all(0 < u < 40 for u in ik["iters"].tolist())
    for a, b in zip(xk, xp):
        assert_close(a, b, 1e-12)


@pytest.mark.parametrize("golden", ["cstriple N=8", "hcstriple zero crossing"])
def test_golden_on_the_card(card, golden):
    """The CsTriple ExpSin N=8 golden (dt = 2e-3, Tf = 0.01) and the HCs
    zero-crossing golden (N=8, dt = 1e-3, Tf = 0.8) through K1/K2, at the
    golden file's 1e-8 (the reference's runs, tests/test_parity_golden.py)."""
    from na_dd_tpu_torch.core import (
        FieldCsTriple, FieldHCsTriple, MMSForcingCsTriple, MMSForcingHCsTriple,
    )
    from na_dd_tpu_torch.harness import MMSTrial
    from na_dd_tpu_torch.integrators import PCTrapezoidalCsTriple, PCTrapezoidalHCsTriple
    from na_dd_tpu_torch.mms.cases import MMSCaseCsZeroCrossing, MMSCaseExpSin
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import STUDY_MODEL_CONSTS
    from na_dd_tpu_torch.ops.grid import make_uniform_grid

    model = Model02(STUDY_MODEL_CONSTS)
    grid = make_uniform_grid(8, 8, device=card)
    if golden == "cstriple N=8":
        classes = (MMSCaseExpSin, FieldCsTriple, MMSForcingCsTriple, PCTrapezoidalCsTriple)
        run, ref = dict(Tf=0.01, dt=2e-3), 1.3027694406570663e-06
    else:
        classes = (MMSCaseCsZeroCrossing, FieldHCsTriple, MMSForcingHCsTriple, PCTrapezoidalHCsTriple)
        run, ref = dict(Tf=0.8, dt=1e-3), 3.5029545962258690e-03
    kernels.reset_launch_counts()
    summary = MMSTrial(grid, model, *classes).run_for_errors(**run)
    err = summary.overall_combined_error
    assert abs(err - ref) / ref <= 1e-8, (err, ref)
    assert kernels.LAUNCHES["bicgstab_solve"] > 0
    assert summary.series.krylov_converged.all()


def _pol_trial(N, device, **kw):
    from na_dd_tpu_torch.harness.studies import _make_trial, study_consts
    from na_dd_tpu_torch.mms.cases import MMSCasePol

    kw.setdefault("krylov_unroll", 8)
    return _make_trial(MMSCasePol, N, 50.0, mc=study_consts("pol"), device=device, **kw)


@pytest.mark.parametrize("form", ["per_solve", "fused"])
def test_mixed_step_on_the_card(card, form):
    """One mixed step of the pol level N=64 (float32 K1, or K4 for the fused
    block refinement, under float64 refinement) against the same step on
    the CPU plain versions: each field within 1e-10 of its max-norm, the same
    Krylov iterations, every solve converged; the kernels launched in
    float32."""
    from na_dd_tpu_torch.mms.engine import state_from_mms_when
    from na_dd_tpu_torch.ops.shifts import LOCAL_OPS

    extra = dict(precision="mixed", track_residuals=True)
    if form == "fused":
        extra["coupling_source"] = "analytic"
    out = {}
    for device in ("cpu", card):
        trial = _pol_trial(64, device, **extra)
        s0 = state_from_mms_when(mms_case=trial.mms_case, t=0.0, grid=trial.grid)
        kernels.reset_launch_counts()
        out[device] = trial.integrator.step_fn(trial.grid, LOCAL_OPS, s0, 0.0, (1 / 64) ** 1.5)
    launches = dict(kernels.LAUNCHES)
    (s_cpu, d_cpu), (s_gpu, d_gpu) = out["cpu"], out[card]
    for a, b in zip(s_gpu, s_cpu):
        assert a.dtype == torch.float64
        assert_close(a, b, 1e-10)
    assert int(d_gpu.krylov_iters) == int(d_cpu.krylov_iters) > 0
    assert bool(d_gpu.krylov_converged) and bool(d_cpu.krylov_converged)
    if form == "fused":
        assert launches["triple_solve"] == 3 and launches["bicgstab_solve"] == 0
    else:
        assert launches["bicgstab_solve"] == 9 and launches["triple_solve"] == 0


@pytest.mark.parametrize("mode", ["f64", "mixed", "mixed fused"])
def test_time_table_run_never_syncs(card, mode):
    """The 41 steps of the pol N=256 level with time tables (and the float32
    tail) under ``torch.cuda.set_sync_debug_mode("error")``: the table
    lookups, the solves and the error norms make no host synchronisation;
    the run's result matches the level without tables."""
    from na_dd_tpu_torch.harness import trial as trial_mod

    kw = {"f64": {}, "mixed": dict(precision="mixed"),
          "mixed fused": dict(precision="mixed", coupling_source="analytic")}[mode]
    trial = _pol_trial(256, card, **kw)
    dt = (1 / 256) ** 1.5
    ref = trial.run_for_errors(Tf=0.01, dt=dt)
    warm = trial.run_for_errors(Tf=0.01, dt=dt, collect_precompute=True, collect_tail="f32")
    assert abs(warm.overall_combined_error - ref.overall_combined_error) <= 1e-7 * ref.overall_combined_error
    num_steps = len(ref.series.krylov_iters)
    assert num_steps == 41
    integ, exact = trial_mod._tabled_run(
        grid=trial.grid, integrator=trial.integrator, exact_sol_pack=trial.mms_case, ops=trial.ops,
        t0=0.0, dt=0.01 / num_steps, num_steps=num_steps,
    )
    assert exact is not None and len(trial.integrator._sim_cache) == 1  # built by the warm run
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = trial_mod._simulate(
            grid=trial.grid, integrator=integ, exact_sol_pack=trial.mms_case, exact_stack=exact,
            initial_state=trial.initial_state, t0=0.0, dt=0.01 / num_steps, num_steps=num_steps,
            variable_names=tuple(trial.variable_names), integral_vars=tuple(trial.integral_vars),
            ops=trial.ops, tail_grid=trial_mod._tail_grid(trial.grid, torch.float32),
        )
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(packed).all()


def _grad_operands(card):
    """An operand set of every wrapper, one plane of each set requiring
    grad."""
    st, b, inv, mask = _system(50, (33, 33), torch.float64, card)
    st3, b3, inv3, mask3 = _system(51, (9, 9, 9), torch.float64, card)
    triple = _triple(52, (33, 33), torch.float64, card)
    leaf = b.clone().requires_grad_()
    leaf3 = b3.clone().requires_grad_()
    st_leaf = st._replace(c0=st.c0.clone().requires_grad_())
    t_leaf = (triple[0]._replace(c0=triple[0].c0.clone().requires_grad_()), *triple[1:])
    return {
        "stencil5_apply": lambda: kernels.stencil5_apply(st, leaf),
        "bicgstab_solve": lambda: kernels.bicgstab_solve(st_leaf, b, inv, mask, tol=1e-13, iters=8),
        "triple_solve": lambda: kernels.triple_solve(*t_leaf, tol=1e-13, iters=8),
        "stencil7_apply": lambda: kernels.stencil7_apply(st3, leaf3),
        "bicgstab_solve3": lambda: kernels.bicgstab_solve3(st3, leaf3, inv3, mask3, tol=1e-13, iters=8),
    }


@pytest.mark.parametrize("name", sorted(kernels.LAUNCHES))
def test_kernels_refuse_operands_that_require_grad(card, name):
    """A kernel reads raw pointers: with an operand that requires grad it
    would return a result with no gradient, where the CPU plain version
    returns one.  It raises instead (and launches nothing); under no_grad,
    or on detached operands, it runs."""
    call = _grad_operands(card)[name]
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="differentiable=True"):
        call()
    assert kernels.LAUNCHES[name] == 0
    with torch.no_grad():
        call()
    assert kernels.LAUNCHES[name] == 1


def _newton_like_system(seed, n, device):
    """Random non-symmetric planes with the Newton planes' structure (no
    coupling into a masked node), a rhs and a cotangent at n × n."""
    from na_dd_tpu_torch.ops.linsolve import Stencil5
    from na_dd_tpu_torch.ops.shifts import LOCAL_OPS

    rng = np.random.default_rng(seed)
    mask = torch.zeros((n, n), dtype=torch.float64)
    mask[1:-1, 1:-1] = 1.0
    into = [mask * f(mask) for f in (LOCAL_OPS.shift_xm, LOCAL_OPS.shift_xp,
                                     LOCAL_OPS.shift_ym, LOCAL_OPS.shift_yp)]
    planes = [(4.0 + torch.as_tensor(rng.random((n, n)))) * mask] + [
        torch.as_tensor(rng.standard_normal((n, n))) * m for m in into]
    b = torch.as_tensor(rng.standard_normal((n, n))) * mask
    gbar = torch.as_tensor(rng.standard_normal((n, n)))
    return Stencil5(*(p.to(device) for p in planes)), b.to(device), gbar.to(device), mask.to(device)


def test_adjoint_on_the_card_matches_the_cpu(card):
    """The IFT adjoint of a 65 × 65 solve: K1 forward and K1 on the
    transposed planes, against the same Function on the CPU plain versions
    (every gradient within 1e-10 of its max-norm: two solves of 1e-13
    relative residual, summed in another order)."""
    from na_dd_tpu_torch.integrators.pc_trapezoidal import KrylovBackend
    from na_dd_tpu_torch.ops import adjoint

    out = {}
    for device in ("cpu", card):
        st, b, gbar, mask = _newton_like_system(60, 65, device)
        leaves = [p.clone().requires_grad_() for p in (*st, b)]
        backend = KrylovBackend(iters=40)
        kernels.reset_launch_counts()
        x, info = adjoint.plane_solve(lambda s, bb: backend.solve(s, bb, mask), type(st)(*leaves[:5]),
                                      leaves[5], mask)
        assert bool(info["converged"])
        out[device] = (x, torch.autograd.grad(x, leaves, grad_outputs=gbar))
        launches = dict(kernels.LAUNCHES)
    assert launches["bicgstab_solve"] == 2  # the forward, and the transposed solve
    assert_close(out[card][0], out["cpu"][0], 1e-12)
    for a, b in zip(out[card][1], out["cpu"][1]):
        assert_close(a, b, 1e-10)


def test_simulate_on_the_card_matches_the_cpu(card):
    """10 steps of the release scenario at N=16 (make_integrator, simulate)
    on the card against the CPU plain versions: each field within 1e-10 of
    its max-norm, 30 K1 launches."""
    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.harness import make_integrator, simulate
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.ops.grid import make_uniform_grid

    out = {}
    for device in ("cpu", card):
        g = make_uniform_grid(16, 16, device=device)
        blob = torch.exp(-60.0 * ((g.xx - 0.5) ** 2 + (g.yy - 0.5) ** 2)) * g.interior_mask
        s0 = State(cp=0.5 * blob, T=0.1 * blob, cl=0.2 * blob, cd=0.05 * blob, cs=blob)
        integ = make_integrator(g, Model02(default_model_consts._replace(Kd=1e-2)))
        kernels.reset_launch_counts()
        out[device] = simulate(integ, g, s0, dt=2e-3, num_steps=10)[0]
    assert kernels.LAUNCHES["bicgstab_solve"] == 30
    for a, b in zip(out[card], out["cpu"]):
        assert_close(a, b, 1e-10)


# ---------------------------------------------------------------------------
# the batch dimension of K1/K2/K5/K6
# ---------------------------------------------------------------------------
def _batch_of(seed, shape, dtype, device, n=3):
    """A stack of systems of one shape: b = 0 (done at iteration 0), A = c0·I
    (one iteration), then dominant ones; and the same systems one by one."""
    systems = [list(_system(seed + k, shape, dtype, device)) for k in range(n)]
    systems[0][1] = torch.zeros_like(systems[0][1])
    st1 = systems[1][0]
    systems[1][0] = type(st1)(st1[0], *(torch.zeros_like(c) for c in st1[1:]))
    stacked = (type(systems[0][0])(*(torch.stack(c) for c in zip(*(s[0] for s in systems)))),
               *(torch.stack([s[k] for s in systems]) for k in (1, 2, 3)))
    return systems, stacked


BATCH_SHAPES = [(65, 65), (5, 3), (130, 257), (17, 19, 21), (5, 5, 5), (33, 20, 41)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("budget", [3, 40])
@pytest.mark.parametrize("shape", BATCH_SHAPES)
def test_batched_solve_kernels_vs_plain_and_one_by_one(card, dtype, budget, shape):
    """K1 (planes) and K5 (volumes) on a stack: ONE launch for the stack,
    each system's iteration count and solution the batched plain version's
    and the unbatched kernel's (at 1e-12 / 1e-5: the blocks split the sums
    differently), grids under one block and ragged ones included."""
    solve = kernels.bicgstab_solve if len(shape) == 2 else kernels.bicgstab_solve3
    plain = kernels.bicgstab_solve_plain if len(shape) == 2 else kernels.bicgstab_solve3_plain
    name = "bicgstab_solve" if len(shape) == 2 else "bicgstab_solve3"
    systems, (st, b, inv, mask) = _batch_of(60, shape, dtype, card, n=4)
    kernels.reset_launch_counts()
    xk, ik = solve(st, b, inv, mask, tol=KRYLOV_TOL[dtype], iters=budget)
    assert kernels.LAUNCHES[name] == 1
    xp, ip = plain(st, b, inv, mask, tol=KRYLOV_TOL[dtype], iters=budget)
    used = ik["iters"].tolist()
    assert ik["iters"].shape == (4,) and used == ip["iters"].tolist()
    assert used[:2] == [0, 1] and all(0 < u <= budget for u in used[2:])
    assert float(xk[0].abs().max()) == 0.0
    assert_close(xk, xp, TOL[dtype])
    for k, (st_k, b_k, inv_k, mask_k) in enumerate(systems):
        x1, i1 = solve(st_k, b_k, inv_k, mask_k, tol=KRYLOV_TOL[dtype], iters=budget)
        assert int(i1["iters"]) == used[k]
        assert_close(xk[k], x1, TOL[dtype])


@pytest.mark.parametrize("shape", [(257, 257), (65, 65, 65)])
def test_batch_of_one_is_the_unbatched_kernel_bit_for_bit(card, shape):
    solve = kernels.bicgstab_solve if len(shape) == 2 else kernels.bicgstab_solve3
    st, b, inv, mask = _system(61, shape, torch.float64, card)
    x1, i1 = solve(st, b, inv, mask, tol=1e-13, iters=40)
    xb, ib = solve(type(st)(*(c[None] for c in st)), b[None], inv[None], mask[None],
                   tol=1e-13, iters=40)
    assert ib["iters"].tolist() == [int(i1["iters"])]
    assert torch.equal(xb[0], x1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 257, 257), (3, 5, 3), (5, 65, 65, 65), (2, 5, 3, 4)])
def test_batched_apply_kernels_vs_plain(card, dtype, shape):
    """K2/K6 on a stack: one launch; each plane's (volume's) own zero
    inflow, so a stack of ones beside zeros leaks nothing."""
    rng = np.random.default_rng(62)
    to_st = stencil5_from_numpy if len(shape) == 3 else stencil7_from_numpy
    apply = kernels.stencil5_apply if len(shape) == 3 else kernels.stencil7_apply
    name = "stencil5_apply" if len(shape) == 3 else "stencil7_apply"
    st = to_st([rng.standard_normal(shape) for _ in range(2 * len(shape) - 1)], dtype, card)
    u = tensor_from_numpy(rng.standard_normal(shape), dtype, card)
    u[1:2] = 0.0
    kernels.reset_launch_counts()
    out = apply(st, u)
    assert kernels.LAUNCHES[name] == 1
    plain = kernels.stencil5_apply_plain if len(shape) == 3 else kernels.stencil7_apply_plain
    assert_close(out, plain(st, u), TOL[dtype])
    assert float(out[1].abs().max()) == 0.0


def test_batched_wrappers_refuse_bad_stacks(card):
    st, b, inv, mask = _batch_of(63, (17, 17), torch.float64, card)[1]
    with pytest.raises(ValueError, match="2-D planes or a stack"):
        kernels.bicgstab_solve(type(st)(*(c[None] for c in st)), b[None], inv[None], mask[None],
                               tol=1e-13, iters=4)
    with pytest.raises(ValueError, match="must match"):  # a mismatched batch
        kernels.bicgstab_solve(st, b[:2], inv[:2], mask[:2], tol=1e-13, iters=4)
    with pytest.raises(ValueError, match="must match"):
        kernels.stencil5_apply(st, b[:2])
    big = 1 + kernels._lib("bicgstab").bicgstab_max_batch()
    many = (type(st)(*(c[:1].expand(big, -1, -1).contiguous() for c in st)),
            *(t[:1].expand(big, -1, -1).contiguous() for t in (b, inv, mask)))
    with pytest.raises(ValueError, match="systems a launch"):
        kernels.bicgstab_solve(*many, tol=1e-13, iters=4)
    # K4 takes a stack, but not a mismatched one, a dt of another length, or
    # more systems than a launch holds
    with pytest.raises(ValueError, match="must match"):
        kernels.triple_solve(st, st, st, st, st, b, b[:2], b, b, inv, inv, inv, mask, 1e-3,
                             tol=1e-13, iters=4)
    with pytest.raises(ValueError, match="dt must hold"):
        kernels.triple_solve(st, st, st, st, st, b, b, b, b, inv, inv, inv, mask,
                             torch.ones(2, dtype=torch.float64, device=card), tol=1e-13, iters=4)
    big_st, big_b, big_inv, big_mask = many
    with pytest.raises(ValueError, match="systems a launch"):
        kernels.triple_solve(big_st, big_st, big_st, big_st, big_st, big_b, big_b, big_b, big_b,
                             big_inv, big_inv, big_inv, big_mask, 1e-3, tol=1e-13, iters=4)


def test_batched_solve_never_syncs(card):
    """A batched K1 and K5 call, with their true residuals, under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    planes = _batch_of(64, (65, 65), torch.float64, card)[1]
    volumes = _batch_of(65, (17, 17, 17), torch.float64, card)[1]
    kernels.bicgstab_solve(*planes, tol=1e-13, iters=40)  # builds and sizes the grid
    kernels.bicgstab_solve3(*volumes, tol=1e-13, iters=40)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x, info = kernels.bicgstab_solve(*planes, tol=1e-13, iters=40)
        x3, info3 = kernels.bicgstab_solve3(*volumes, tol=1e-13, iters=40)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(info["converged"].all()) and bool(info3["converged"].all())


def test_batched_ladder_on_the_card_matches_the_cpu(card):
    """The pol ladder N=2..64 as one batch on the card against the CPU plain
    run (1e-10): 3 K1 launches a step of the finest level, 6 steps."""
    from na_dd_tpu_torch.harness.batched_ladder import run_spatial_ladder_batched

    cpu = run_spatial_ladder_batched("pol", levels=6, verbose=False, device="cpu")
    kernels.reset_launch_counts()
    gpu = run_spatial_ladder_batched("pol", levels=6, verbose=False, device=card)
    assert kernels.LAUNCHES["bicgstab_solve"] == 3 * 6  # N=64: 6 steps
    for a, b in zip(gpu["errors"], cpu["errors"]):
        assert abs(a - b) <= 1e-10 * b


# ---------------------------------------------------------------------------
# the solver options on the card against the CPU plain run
# ---------------------------------------------------------------------------
def _release_step(device, **kw):
    """One step of the release blob (Kd = 1e-2) at N=16 with the options."""
    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.harness.simulate import make_integrator
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.ops.grid import make_uniform_grid
    from na_dd_tpu_torch.ops.shifts import LOCAL_OPS

    g = make_uniform_grid(16, 16, device=device)
    b = torch.exp(-60.0 * ((g.xx - 0.5) ** 2 + (g.yy - 0.5) ** 2)) * g.interior_mask
    s0 = State(0.5 * b, 0.1 * b, 0.2 * b, 0.05 * b, b)
    integ = make_integrator(g, Model02(default_model_consts._replace(Kd=1e-2)), **kw)
    return integ.step_fn(g, LOCAL_OPS, s0, 0.0, 2e-3)


@pytest.mark.parametrize("kw", [dict(stencil_source="probe"), dict(krylov_unroll=None),
                                dict(assemble_stencil=False, krylov_unroll=None)],
                         ids=["probe", "while_form", "matrix_free"])
def test_solver_option_step_on_the_card_matches_the_cpu(card, kw):
    """The probed planes (K1), the while form (K1 at budget 300) and the
    matrix-free route (no kernel) on the card against the CPU: 1e-12."""
    s_card, d_card = _release_step(card, **kw)
    s_cpu, d_cpu = _release_step("cpu", **kw)
    for a, b in zip(s_card, s_cpu):
        assert_close(a, b, 1e-12)
    assert bool(d_card.krylov_converged) and int(d_card.krylov_iters) == int(d_cpu.krylov_iters)


def test_heat_mms_error_on_the_card_matches_the_cpu(card):
    """The Crank-Nicolson heat solve through K5/K6 against the plain run:
    1e-10, as chip_smoke.py holds it (the error is a difference of O(1)
    fields, 1.08e-12 apart at N=16 on the H100); one K5 launch a step."""
    from na_dd_tpu_torch.three_d.diffusion import heat_mms_error

    kernels.reset_launch_counts()
    e_card = heat_mms_error(16, device=card)
    assert kernels.LAUNCHES["bicgstab_solve3"] == 20
    e_cpu = heat_mms_error(16, device="cpu")
    assert abs(e_card - e_cpu) <= 1e-10 * e_cpu


@pytest.mark.parametrize("kw", [dict(linear_solver="direct"), dict(stencil_source="probe")],
                         ids=["direct", "probe"])
def test_3d_option_step_on_the_card_matches_the_cpu(card, kw):
    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.three_d.grid import make_uniform_grid3
    from na_dd_tpu_torch.three_d.harness import make_integrator3
    from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

    def step(device):
        g = make_uniform_grid3(12, 12, 12, device=device)
        b = (torch.sin(np.pi * g.xx) * torch.sin(np.pi * g.yy) * torch.sin(np.pi * g.zz)
             * g.interior_mask)
        integ = make_integrator3(g, Model02(default_model_consts._replace(Kd=1e-2)), **kw)
        return integ.step_fn(g, LOCAL_OPS3, State(0.2 * b, 0.1 * b, 0 * b, 0.05 * b, b), 0.0, 1e-3)

    (s_card, d_card), (s_cpu, _) = step(card), step("cpu")
    for a, b in zip(s_card, s_cpu):
        assert_close(a, b, 1e-12)
    assert bool(d_card.krylov_converged)


def test_3d_gradient_on_the_card_matches_the_cpu(card):
    """differentiable=True in 3-D: K5 on Stencil7.transpose volumes in the
    adjoint; value and gradient against the CPU plain run, 1e-10."""
    from na_dd_tpu_torch.core.state import State
    from na_dd_tpu_torch.models.coefficients import Model02
    from na_dd_tpu_torch.models.consts import default_model_consts
    from na_dd_tpu_torch.three_d.grid import make_uniform_grid3
    from na_dd_tpu_torch.three_d.harness import make_integrator3
    from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

    def value_and_grad(device):
        g = make_uniform_grid3(10, 10, 10, device=device)
        b = (torch.sin(np.pi * g.xx) * torch.sin(np.pi * g.yy) * torch.sin(np.pi * g.zz)
             * g.interior_mask)
        Kd = torch.tensor(1e-2, dtype=torch.float64, device=device, requires_grad=True)
        integ = make_integrator3(g, Model02(default_model_consts._replace(Kd=Kd)),
                                 differentiable=True)
        s = State(0.2 * b, 0.1 * b, 0 * b, 0.05 * b, b)
        for k in range(2):
            s, _ = integ.step_fn(g, LOCAL_OPS3, s, k * 1e-3, 1e-3)
        v = LOCAL_OPS3.asum(g.w_H * s.cd)
        return v.item(), torch.autograd.grad(v, Kd)[0].item()

    (v_card, g_card), (v_cpu, g_cpu) = value_and_grad(card), value_and_grad("cpu")
    assert abs(v_card - v_cpu) <= 1e-12 * abs(v_cpu)
    assert abs(g_card - g_cpu) <= 1e-10 * abs(g_cpu)


def test_batched_mixed_ladder_on_the_card_matches_the_cpu(card):
    from na_dd_tpu_torch.harness.batched_ladder import run_spatial_ladder_batched

    kernels.reset_launch_counts()
    e_card = run_spatial_ladder_batched("pol", levels=3, precision="mixed", verbose=False,
                                        device=card)["errors"]
    assert kernels.LAUNCHES_F32["bicgstab_solve"] == kernels.LAUNCHES["bicgstab_solve"] > 0
    e_cpu = run_spatial_ladder_batched("pol", levels=3, precision="mixed", verbose=False,
                                       device="cpu")["errors"]
    for a, b in zip(e_card, e_cpu):
        assert abs(a - b) <= 1e-10 * b
