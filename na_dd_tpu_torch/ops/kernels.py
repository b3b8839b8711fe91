"""The port's hand-written Hopper kernels, each beside its plain PyTorch
twin.

==========================  ===================================================
wrapper                     replaces (na_dd_tpu/ops/pallas_kernels.py)
==========================  ===================================================
:func:`stencil5_apply`      ``stencil5_apply_pallas`` (:523) — K2, and
                            ``stencil5_apply_tiled`` (:466) — K3
:func:`bicgstab_solve`      ``bicgstab_solve_pallas`` (:342) — K1
:func:`triple_solve`        ``triple_solve_pallas`` (:263) — K4
:func:`stencil7_apply`      ``stencil7_apply_pallas`` (:615) — K6, and
                            ``stencil7_apply_tiled`` (:834) — K7
:func:`bicgstab_solve3`     ``bicgstab_solve3_pallas`` (:702) — K5
==========================  ===================================================

Every kernel takes an optional leading batch dimension, the written-out
counterpart of ``jax.vmap`` over the TPU kernel: a stack of B planes
(B, n0, n1) or volumes (B, n0, n1, n2) of one shape goes to ONE launch, each
system with its own zero inflow, and a solve's ``info`` holds one entry a
system (``iters`` (B,), ``resnorm_sq`` and ``converged`` (B, 1, 1) or
(B, 1, 1, 1); K4's (B, 3), one a system and solve, with ``dt`` one a
system).

Dispatch is by the tensor's device and nothing else: a CPU tensor takes the
plain version (which autograd traces like any PyTorch code); a CUDA tensor
is checked (device, dtype, shape, contiguity, and no operand that requires
grad while autograd records) and launches the kernel, or the wrapper
raises.  There is no fallback from a
refused or failed launch to the plain version.  Each launch adds one to its
wrapper's count in :data:`LAUNCHES` (and, on float32 operands, in
:data:`LAUNCHES_F32`).

The CUDA sources (``csrc/*.cu``) are compiled at first use with ``nvcc`` for
``sm_90a`` into plain-C shared libraries under ``build/kernels/`` at the
repository root, one ``nvcc`` per source, all started together, and loaded
with ``ctypes``.  Nothing here imports or builds anything when the module is
imported, so the module loads on a machine with no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from na_dd_tpu_torch.ops.linsolve import Stencil5, bicgstab, bicgstab_unrolled
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS
from na_dd_tpu_torch.three_d.diffusion import Stencil7
from na_dd_tpu_torch.three_d.shifts import LOCAL_OPS3

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {
    "stencil5": "stencil5.cu",
    "bicgstab": "bicgstab.cu",
    "stencil7": "stencil7.cu",
    "bicgstab3": "bicgstab3.cu",
    "triple_solve": "triple_solve.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: systems one launch of a solve kernel holds (``bicgstab::kMaxBatch`` in
#: ``csrc/bicgstab.cuh``); :func:`triple_solve` refuses more on either device
MAX_BATCH = 32

#: launches of each kernel since the last :func:`reset_launch_counts`
LAUNCHES = {
    "stencil5_apply": 0,
    "bicgstab_solve": 0,
    "stencil7_apply": 0,
    "bicgstab_solve3": 0,
    "triple_solve": 0,
}
#: of those, the launches on float32 operands
LAUNCHES_F32 = dict.fromkeys(LAUNCHES, 0)

#: per-source build record of the last :func:`build_kernels` in this process:
#: {"seconds", "cached", "ptxas"} (ptxas = nvcc's register/spill report)
BUILD_INFO: dict = {}

_LIBS: dict = {}
_LOCK = threading.Lock()
_BLOCKS: dict = {}


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0
        LAUNCHES_F32[key] = 0


def _count(name: str, dtype) -> None:
    LAUNCHES[name] += 1
    if dtype == torch.float32:
        LAUNCHES_F32[name] += 1


# ---------------------------------------------------------------------------
# plain PyTorch twins (the CPU path; also the yardstick on the card)
# ---------------------------------------------------------------------------
def system_sum(u, nd: int):
    """Sum over each system of ``u``: the whole array when it is one system
    (``nd`` dimensions), else each of its leading-dimension entries alone,
    kept as (B, 1, ...) to broadcast against the stack."""
    if u.dim() == nd:
        return torch.sum(u)
    return torch.sum(u, dim=tuple(range(-nd, 0)), keepdim=True)


def stencil5_apply_plain(stencil: Stencil5, u):
    """out = c0·u + cxm·u[i-1,j] + cxp·u[i+1,j] + cym·u[i,j-1] + cyp·u[i,j+1],
    zero inflow; on a stack of planes, plane by plane."""
    return stencil.apply(LOCAL_OPS, u)


def _residual_info(apply, stencil, b, x, iters, tol, nd):
    """True-residual diagnostics, as bicgstab_solve_pallas computes them
    outside its kernel (pallas_kernels.py:385-392), per system."""
    r = b - apply(stencil, x)
    rsq = system_sum(r * r, nd)
    tol_sq = tol * tol * system_sum(b * b, nd)
    return {"iters": iters, "resnorm_sq": rsq, "converged": rsq <= tol_sq}


def _plain_solve(matvec, b, inv_diag, tol, iters, nd):
    """The masked-early-exit BiCGStab of the kernels from x0 = 0 with the
    Jacobi preconditioner and per-system dot products.  On CPU tensors the
    loop also stops once every system is done (:func:`bicgstab`, one host
    read an iteration, which costs nothing there), which changes no value; on
    the card it runs the whole budget without a host read."""
    solve = bicgstab if b.device.type == "cpu" else bicgstab_unrolled
    budget = {"maxiter" if solve is bicgstab else "iters": iters}
    return solve(
        matvec, b, torch.zeros_like(b), dot=lambda u, v: system_sum(u * v, nd),
        minv=lambda r: r * inv_diag, tol=tol, **budget,
    )


def _bicgstab_plain(apply, stencil, b, inv_diag, mask, tol, iters, nd):
    """:func:`_plain_solve`, then ``x * mask`` and the true-residual info;
    ``iters`` has the batch's shape, (B,) or ()."""
    x, info = _plain_solve(lambda w: apply(stencil, w), b, inv_diag, tol, iters, nd)
    x = x * mask
    used = info["iters"].reshape(b.shape[: b.dim() - nd])
    return x, _residual_info(apply, stencil, b, x, used, tol, nd)


def bicgstab_solve_plain(stencil: Stencil5, b, inv_diag, mask, *, tol: float, iters: int):
    """Plain twin of K1 (a plane, or a stack of planes solved each alone)."""
    return _bicgstab_plain(stencil5_apply_plain, stencil, b, inv_diag, mask, tol, iters, 2)


def _dt_stack(dt, rhs_T):
    """``dt`` in the operands' dtype, as the kernel casts it: a float as it
    is, a tensor (one value, or one a system of a stack) as (B, 1, 1) on a
    stack."""
    if not isinstance(dt, torch.Tensor):
        return dt
    dt = dt.to(dtype=rhs_T.dtype, device=rhs_T.device)
    return dt.reshape(-1, 1, 1) if rhs_T.dim() == 3 and dt.numel() > 1 else dt.reshape(())


def triple_solve_plain(
    J_T: Stencil5, J_cl: Stencil5, J_cd: Stencil5, C_clT: Stencil5, C_cdT: Stencil5, d_cdcl,
    rhs_T, base_cl, base_cd, invd_T, invd_cl, invd_cd, mask, dt, *, tol: float, iters: int,
):
    """Plain twin of K4: three masked-early-exit solves from x0 = 0 with the
    coupling applies between them, on one system of planes or on a stack
    (B, n0, n1) solved each alone (``dt`` a float, or a tensor of one value
    a system).  ``info`` holds, per solve (and system: shape (3,) or
    (B, 3)), the iteration count, the recurrence residual ``r·r`` at exit,
    ``tol_sq = tol²·(b·b)`` of the masked, coupled rhs, and ``converged =
    resnorm_sq <= tol_sq``."""
    batch = rhs_T.shape[:-2]
    dt = _dt_stack(dt, rhs_T)
    infos = []

    def solve(J, b, inv_diag):
        x, info = _plain_solve(
            lambda w: J.apply(LOCAL_OPS, w), b, inv_diag, tol, iters, 2
        )
        tol_sq = tol * tol * system_sum(b * b, 2)
        infos.append(tuple(v.reshape(batch) for v in (info["iters"], info["resnorm_sq"], tol_sq)))
        return x * mask

    dT = solve(J_T, rhs_T * mask, invd_T)
    dcl = solve(J_cl, (base_cl + dt * C_clT.apply(LOCAL_OPS, dT)) * mask, invd_cl)
    coup_cd = C_cdT.apply(LOCAL_OPS, dT) + d_cdcl * dcl
    dcd = solve(J_cd, (base_cd + dt * coup_cd) * mask, invd_cd)
    its, res, tol_sq = (torch.stack(v, dim=-1) for v in zip(*infos))
    return dT, dcl, dcd, {
        "iters": its, "resnorm_sq": res, "tol_sq": tol_sq, "converged": res <= tol_sq,
    }


def stencil7_apply_plain(stencil: Stencil7, u):
    """out = c0·u + cxm·u[i-1,j,k] + cxp·u[i+1,j,k] + cym·u[i,j-1,k]
    + cyp·u[i,j+1,k] + czm·u[i,j,k-1] + czp·u[i,j,k+1], zero inflow; on a
    stack of volumes, volume by volume."""
    return stencil.apply(LOCAL_OPS3, u)


def bicgstab_solve3_plain(stencil: Stencil7, b, inv_diag, mask, *, tol: float, iters: int):
    """Plain twin of K5 (a volume, or a stack of volumes solved each alone)."""
    return _bicgstab_plain(stencil7_apply_plain, stencil, b, inv_diag, mask, tol, iters, 3)


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------
def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / source]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _declare(name: str, lib) -> None:
    vp, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.error_string.argtypes = [i32]
    lib.error_string.restype = ctypes.c_char_p
    if name == "stencil5":
        for fn in (lib.stencil5_apply_f64, lib.stencil5_apply_f32):
            fn.argtypes = [vp] * 7 + [i32, i32, i32, vp]
            fn.restype = i32
    elif name == "stencil7":
        for fn in (lib.stencil7_apply_f64, lib.stencil7_apply_f32):
            fn.argtypes = [vp] * 9 + [i32, i32, i32, i32, vp]
            fn.restype = i32
    elif name == "bicgstab":
        for fn in (lib.bicgstab_blocks_f64, lib.bicgstab_blocks_f32):
            fn.argtypes = [i32, i32, ctypes.POINTER(i32)]
            fn.restype = i32
        for fn in (lib.bicgstab_solve_f64, lib.bicgstab_solve_f32):
            fn.argtypes = [vp] * 12 + [i32, i32, i32, i32, f64, i32, vp]
            fn.restype = i32
        lib.bicgstab_num_slots.restype = i32
        lib.bicgstab_work_planes.restype = i32
        lib.bicgstab_max_batch.restype = i32
    elif name == "bicgstab3":
        for fn in (lib.bicgstab3_blocks_f64, lib.bicgstab3_blocks_f32):
            fn.argtypes = [i32, i32, ctypes.POINTER(i32)]
            fn.restype = i32
        for fn in (lib.bicgstab3_solve_f64, lib.bicgstab3_solve_f32):
            fn.argtypes = [vp] * 14 + [i32, i32, i32, i32, i32, f64, i32, vp]
            fn.restype = i32
        lib.bicgstab3_num_slots.restype = i32
        lib.bicgstab3_work_volumes.restype = i32
        lib.bicgstab3_max_batch.restype = i32
    elif name == "triple_solve":
        for fn in (lib.triple_solve_blocks_f64, lib.triple_solve_blocks_f32):
            fn.argtypes = [i32, i32, ctypes.POINTER(i32)]
            fn.restype = i32
        for fn in (lib.triple_solve_f64, lib.triple_solve_f32):
            fn.argtypes = [vp] * 6 + [i32, i32, i32, i32, f64, f64, vp, i32, vp]
            fn.restype = i32
        lib.triple_solve_input_planes.restype = i32
        lib.triple_solve_num_slots.restype = i32
        lib.triple_solve_work_planes.restype = i32
    else:
        raise ValueError(f"no declarations for the kernel library {name!r}")


def build_kernels() -> dict:
    """Compile (where not already built) and load every kernel library.

    One ``nvcc`` process per source, all started together.  A library is
    named by the digest of its sources and flags, so an unchanged source is
    not compiled twice.  Returns {name: ctypes library}.
    """
    with _LOCK:
        if len(_LIBS) == len(SOURCES):
            return dict(_LIBS)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name, source in SOURCES.items():
            target = BUILD_DIR / f"lib{name}_{_digest(source)}.so"
            if target.exists():
                BUILD_INFO[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
                continue
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs[name] = (proc, tmp, target, time.perf_counter())
        outputs = {}
        for name, (proc, _tmp, _target, t0) in jobs.items():  # wait for every nvcc
            outputs[name] = (proc.communicate()[0], time.perf_counter() - t0)
        for name, (proc, tmp, target, _t0) in jobs.items():
            out, seconds = outputs[name]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCES[name]}:\n{out}")
            tmp.replace(target)
            BUILD_INFO[name] = {"seconds": seconds, "cached": False, "ptxas": out}
        for name, source in SOURCES.items():
            lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}_{_digest(source)}.so"))
            _declare(name, lib)
            _LIBS[name] = lib
        return dict(_LIBS)


def _lib(name: str):
    if name not in _LIBS:
        build_kernels()
    return _LIBS[name]


def _check_launch(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} ({lib.error_string(code).decode()})")


def _check_operands(
    what: str, ndim: int, ref: torch.Tensor, *others: torch.Tensor, batched: bool = True
) -> None:
    """Device, dtype, rank (2 for planes, 3 for volumes, one more for a
    stack of them where the kernel takes a batch), shape and contiguity of
    every operand; raises on anything the kernel does not take.  A kernel has no autograd formula and reads raw pointers, so an
    operand that requires grad while autograd records is refused too:
    differentiating through a solve is the IFT adjoint's work
    (:mod:`na_dd_tpu_torch.ops.adjoint`), which calls the kernels on
    detached tensors."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (ref, *others)):
        raise RuntimeError(
            f"{what}: an operand requires grad and the kernel would detach it silently; "
            "use differentiable=True on the integrator (IFT adjoints), or detach the operands"
        )
    if ref.device.type != "cuda":
        raise ValueError(f"{what}: tensors must lie on the CPU or a CUDA device; got {ref.device}")
    if ref.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"{what}: dtype must be float64 or float32; got {ref.dtype}")
    if ref.dim() != ndim and not (batched and ref.dim() == ndim + 1):
        kind = "2-D planes" if ndim == 2 else "3-D volumes"
        kind += " or a stack of them" if batched else ""
        raise ValueError(f"{what}: operands must be {kind}; got shape {tuple(ref.shape)}")
    if ref.dim() == ndim + 1 and ref.shape[0] < 1:
        raise ValueError(f"{what}: an empty batch; got shape {tuple(ref.shape)}")
    if ref.numel() >= 2**31:
        raise ValueError(f"{what}: the kernels index with 32-bit ints; got {ref.numel()} points")
    for t in (ref, *others):
        if t.device != ref.device or t.dtype != ref.dtype or t.shape != ref.shape:
            raise ValueError(
                f"{what}: every operand must match {ref.dtype} {tuple(ref.shape)} on "
                f"{ref.device}; got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _batch(u: torch.Tensor, nd: int):
    """(B, shape of one system) of an operand of ``nd`` dimensions or a stack
    of them."""
    return (1 if u.dim() == nd else u.shape[0]), tuple(u.shape[-nd:])


def stencil5_apply(stencil: Stencil5, u):
    """K2/K3, any plane shape, or a stack of planes (B, n0, n1) in one
    launch.  CPU tensor → :func:`stencil5_apply_plain`; CUDA tensor →
    kernel."""
    if u.device.type == "cpu":
        return stencil5_apply_plain(stencil, u)
    _check_operands("stencil5_apply", 2, u, *stencil)
    lib = _lib("stencil5")
    fn = lib.stencil5_apply_f64 if u.dtype == torch.float64 else lib.stencil5_apply_f32
    out = torch.empty_like(u)
    nb, (n0, n1) = _batch(u, 2)
    code = fn(
        u.data_ptr(), *(c.data_ptr() for c in stencil), out.data_ptr(),
        nb, n0, n1, _stream(u),
    )
    _check_launch(lib, code, "stencil5_apply")
    _count("stencil5_apply", u.dtype)
    return out


def _bicgstab_blocks(lib, prefix: str, dtype, n: int, nsys: int = 1) -> int:
    """The cooperative grid of a BiCGStab kernel (``prefix`` "bicgstab",
    "bicgstab3" or "triple_solve") for ``nsys`` systems of n points, as its
    library reports it; keyed (prefix, dtype, n) for one system and
    (prefix, dtype, n, nsys) for a batch."""
    key = (prefix, dtype, n) if nsys == 1 else (prefix, dtype, n, nsys)
    if key not in _BLOCKS:
        suffix = "f64" if dtype == torch.float64 else "f32"
        fn = getattr(lib, f"{prefix}_blocks_{suffix}")
        blocks = ctypes.c_int(0)
        _check_launch(lib, fn(n, nsys, ctypes.byref(blocks)), f"{prefix} occupancy")
        _BLOCKS[key] = blocks.value
    return _BLOCKS[key]


def _solve(name: str, prefix: str, nd: int, apply, stencil, b, inv_diag, mask, tol, iters):
    """K1 (``nd`` = 2) or K5 (3) on CUDA operands: one cooperative launch
    for the one system or the whole stack, then the true residual through
    ``apply``."""
    _check_operands(name, nd, b, *stencil, inv_diag, mask)
    lib = _lib(prefix)
    nsys, shape = _batch(b, nd)
    if nsys > getattr(lib, f"{prefix}_max_batch")():
        raise ValueError(
            f"{name}: at most {getattr(lib, f'{prefix}_max_batch')()} systems a launch; "
            f"got {nsys}"
        )
    n = b[0].numel() if b.dim() > nd else b.numel()
    blocks = _bicgstab_blocks(lib, prefix, b.dtype, n, nsys)
    x = torch.empty_like(b)
    iters_out = torch.empty(nsys, dtype=torch.int32, device=b.device)
    slots = getattr(lib, f"{prefix}_num_slots")()
    work_arrays = getattr(lib, f"{prefix}_work_{'planes' if nd == 2 else 'volumes'}")()
    work = torch.empty((work_arrays, *b.shape), dtype=b.dtype, device=b.device)
    partials = torch.empty(slots * blocks, dtype=b.dtype, device=b.device)
    suffix = "f64" if b.dtype == torch.float64 else "f32"
    fn = getattr(lib, f"{prefix}_solve_{suffix}")
    code = fn(
        b.data_ptr(), *(c.data_ptr() for c in stencil), inv_diag.data_ptr(),
        mask.data_ptr(), x.data_ptr(), iters_out.data_ptr(), work.data_ptr(),
        partials.data_ptr(), nsys, *shape, int(iters), float(tol) * float(tol), blocks,
        _stream(b),
    )
    _check_launch(lib, code, name)
    _count(name, b.dtype)
    used = iters_out if b.dim() > nd else iters_out[0]
    return x, _residual_info(apply, stencil, b, x, used, tol, nd)


def bicgstab_solve(stencil: Stencil5, b, inv_diag, mask, *, tol: float, iters: int):
    """K1: whole Jacobi-BiCGStab solve (x0 = 0, ``iters`` masked-early-exit
    iterations) of ``stencil · x = b``, on a plane or on a stack of B planes
    (each system solved alone, all in one launch).

    Returns ``(x, info)`` with ``info = {"iters", "resnorm_sq", "converged"}``:
    the in-kernel iteration count and the true residual ``b − A·x`` through
    :func:`stencil5_apply`, as ``bicgstab_solve_pallas`` reports them, one
    each a system of a stack.  CPU tensors take :func:`bicgstab_solve_plain`.
    The solve never synchronises with the host.
    """
    if b.device.type == "cpu":
        return bicgstab_solve_plain(stencil, b, inv_diag, mask, tol=tol, iters=iters)
    return _solve(
        "bicgstab_solve", "bicgstab", 2, stencil5_apply, stencil, b, inv_diag, mask, tol, iters
    )


def triple_solve(
    J_T: Stencil5, J_cl: Stencil5, J_cd: Stencil5, C_clT: Stencil5, C_cdT: Stencil5, d_cdcl,
    rhs_T, base_cl, base_cd, invd_T, invd_cl, invd_cd, mask, dt, *, tol: float, iters: int,
):
    """K4: the whole triangular Newton sweep's linear algebra in one launch.

    Solves ``J_T·δT = rhs_T·m``, then ``J_cl·δcl = (base_cl + dt·C_clT·δT)·m``,
    then ``J_cd·δcd = (base_cd + dt·(C_cdT·δT + d_cdcl ⊙ δcl))·m``, each the
    solve of :func:`bicgstab_solve` (x0 = 0, ``iters`` masked-early-exit
    iterations), ``m = mask``.  Returns ``(δT·m, δcl·m, δcd·m, info)``;
    ``info["iters"]``, ``["resnorm_sq"]``, ``["tol_sq"]`` and ``["converged"]``
    have one entry per solve, the residual being the recurrence ``r·r`` at
    exit (``bicgstab_unrolled`` semantics), as ``triple_solve_pallas`` reports
    them.

    On a stack of B systems (every operand (B, n0, n1)) the B sweeps run in
    the same launch, each alone, with ``dt`` a float or one value a system
    ((B,) or (B, 1, 1), read on the device), and each info entry has shape
    (B, 3), as ``jax.vmap`` of the TPU kernel gives it.  CPU tensors take
    :func:`triple_solve_plain`.  Never synchronises with the host.  More
    than :data:`MAX_BATCH` systems raise, on the CPU too.
    """
    nsys = 1 if rhs_T.dim() == 2 else rhs_T.shape[0]
    if nsys > MAX_BATCH:
        raise ValueError(f"triple_solve: at most {MAX_BATCH} systems a launch; got {nsys}")
    if rhs_T.device.type == "cpu":
        return triple_solve_plain(
            J_T, J_cl, J_cd, C_clT, C_cdT, d_cdcl, rhs_T, base_cl, base_cd,
            invd_T, invd_cl, invd_cd, mask, dt, tol=tol, iters=iters,
        )
    planes = (
        *J_T, *J_cl, *J_cd, *C_clT, *C_cdT,
        d_cdcl, rhs_T, base_cl, base_cd, invd_T, invd_cl, invd_cd, mask,
    )
    _check_operands("triple_solve", 2, rhs_T, *planes)
    lib = _lib("triple_solve")
    if len(planes) != lib.triple_solve_input_planes():
        raise ValueError(f"triple_solve: expected {lib.triple_solve_input_planes()} planes")
    n0, n1 = rhs_T.shape[-2:]
    dtype, device = rhs_T.dtype, rhs_T.device
    dt_host, dt_sys = 0.0, None
    if isinstance(dt, torch.Tensor):
        if dt.numel() not in (1, nsys):
            raise ValueError(
                f"triple_solve: dt must hold one value or one a system; got {tuple(dt.shape)}"
            )
        dt_sys = dt.to(dtype=torch.float64, device=device).reshape(-1).expand(nsys).contiguous()
    else:
        dt_host = float(dt)
    blocks = _bicgstab_blocks(lib, "triple_solve", dtype, n0 * n1, nsys)
    out = torch.empty((3, *rhs_T.shape), dtype=dtype, device=device)
    iters_out = torch.empty((nsys, 3), dtype=torch.int32, device=device)
    scalars = torch.empty((2, nsys, 3), dtype=dtype, device=device)  # r·r, tol_sq
    work = torch.empty((lib.triple_solve_work_planes(), *rhs_T.shape), dtype=dtype, device=device)
    partials = torch.empty(lib.triple_solve_num_slots() * blocks, dtype=dtype, device=device)
    in_ptrs = (ctypes.c_void_p * len(planes))(*(t.data_ptr() for t in planes))
    out_ptrs = (ctypes.c_void_p * 3)(*(out[k].data_ptr() for k in range(3)))
    fn = lib.triple_solve_f64 if dtype == torch.float64 else lib.triple_solve_f32
    code = fn(
        ctypes.cast(in_ptrs, ctypes.c_void_p), ctypes.cast(out_ptrs, ctypes.c_void_p),
        iters_out.data_ptr(), scalars.data_ptr(), work.data_ptr(), partials.data_ptr(),
        nsys, n0, n1, int(iters), float(tol) * float(tol), dt_host,
        None if dt_sys is None else dt_sys.data_ptr(), blocks, _stream(rhs_T),
    )
    _check_launch(lib, code, "triple_solve")
    _count("triple_solve", dtype)
    its, res, tol_sq = iters_out, scalars[0], scalars[1]
    if rhs_T.dim() == 2:
        its, res, tol_sq = its[0], res[0], tol_sq[0]
    return out[0], out[1], out[2], {
        "iters": its, "resnorm_sq": res, "tol_sq": tol_sq, "converged": res <= tol_sq,
    }


def stencil7_apply(stencil: Stencil7, u):
    """K6/K7, a volume or a stack of volumes (B, n0, n1, n2) in one launch.
    CPU tensor → :func:`stencil7_apply_plain`; CUDA tensor → kernel."""
    if u.device.type == "cpu":
        return stencil7_apply_plain(stencil, u)
    _check_operands("stencil7_apply", 3, u, *stencil)
    lib = _lib("stencil7")
    fn = lib.stencil7_apply_f64 if u.dtype == torch.float64 else lib.stencil7_apply_f32
    out = torch.empty_like(u)
    nb, (n0, n1, n2) = _batch(u, 3)
    code = fn(
        u.data_ptr(), *(c.data_ptr() for c in stencil), out.data_ptr(),
        nb, n0, n1, n2, _stream(u),
    )
    _check_launch(lib, code, "stencil7_apply")
    _count("stencil7_apply", u.dtype)
    return out


def bicgstab_solve3(stencil: Stencil7, b, inv_diag, mask, *, tol: float, iters: int):
    """K5: whole Jacobi-BiCGStab solve (x0 = 0, ``iters`` masked-early-exit
    iterations) of ``stencil · x = b`` on a volume, or on a stack of B
    volumes in one launch.

    Returns ``(x, info)`` as :func:`bicgstab_solve` does, the true residual
    through :func:`stencil7_apply`.  CPU tensors take
    :func:`bicgstab_solve3_plain`.  The solve never synchronises with the
    host.
    """
    if b.device.type == "cpu":
        return bicgstab_solve3_plain(stencil, b, inv_diag, mask, tol=tol, iters=iters)
    return _solve(
        "bicgstab_solve3", "bicgstab3", 3, stencil7_apply, stencil, b, inv_diag, mask, tol, iters
    )
