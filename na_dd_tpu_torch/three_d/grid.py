"""Tensor-product grid on [0,1]³ (counterpart of :mod:`na_dd_tpu.three_d.grid`).

The same two rules as the 2-D grid (:mod:`na_dd_tpu_torch.ops.grid`): the
reciprocal metrics hold 0 where a division would hit the boundary, so every
consumer multiplies; and every array is a full (N+1, M+1, P+1) volume, so
quadrature and inner products are whole-array sums with masked weights.  The
metrics are computed on the host in float64 with numpy, exactly as the JAX
package does, and shipped once to the device in the working dtype.
The probing path's colourings (``red_mask``, ``color7``) are made once with
the grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from na_dd_tpu_torch.config import resolve_device, resolve_dtype


@dataclasses.dataclass(frozen=True)
class Grid3:
    # coordinates, broadcast to (N+1, M+1, P+1)
    xx: torch.Tensor
    yy: torch.Tensor
    zz: torch.Tensor
    # staggered midpoints (0 at the last plane)
    xx_phalf: torch.Tensor  # x_{i+1/2} at [i,:,:] for i < N; 0 at i = N
    yy_phalf: torch.Tensor
    zz_phalf: torch.Tensor
    # dual-cell widths (0 at the boundary planes)
    hh_phalf: torch.Tensor  # h_{i+1/2}; 0 at i = 0, N
    kk_phalf: torch.Tensor
    ll_phalf: torch.Tensor
    # metrics (0 where a division would hit the boundary)
    inv_hh: torch.Tensor  # 1/h_i; 0 at i = 0
    inv_kk: torch.Tensor
    inv_ll: torch.Tensor
    inv_hh_phalf: torch.Tensor  # 1/h_{i+1/2}; 0 at i = 0, N
    inv_kk_phalf: torch.Tensor
    inv_ll_phalf: torch.Tensor
    # masks and inner-product weights
    interior_mask: torch.Tensor  # 1 on the open interior
    mask_x1: torch.Tensor  # 0 on plane i = 0
    mask_y1: torch.Tensor  # 0 on plane j = 0
    mask_z1: torch.Tensor  # 0 on plane k = 0
    w_H: torch.Tensor  # h_{i+1/2} k_{j+1/2} l_{k+1/2} on the interior
    w_gx: torch.Tensor  # h_i k_{j+1/2} l_{k+1/2}
    w_gy: torch.Tensor  # h_{i+1/2} k_j l_{k+1/2}
    w_gz: torch.Tensor  # h_{i+1/2} k_{j+1/2} l_k
    red_mask: torch.Tensor  # 1 where (i+j+k) is even (two-colour diagonal probing)
    color7: torch.Tensor  # (i + 2j + 3k) mod 7, int32: a node and its 6 neighbours differ
    N: int
    M: int
    P: int

    @property
    def full_shape(self):
        return (self.N + 1, self.M + 1, self.P + 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.xx.dtype

    @property
    def device(self) -> torch.device:
        return self.xx.device


def colourings3(N: int, M: int, P: int):
    """``(red_mask, color7)`` of an (N+1, M+1, P+1) volume as numpy arrays:
    the (i+j+k) parity (float64) and the (i + 2j + 3k) mod 7 colouring
    (int32), under which the neighbour at offset (a, b, c) has colour
    (q + a + 2b + 3c) mod 7 (the offsets 0, ±1, ±2, ±3 differ mod 7)."""
    ii, jj, kk = np.meshgrid(np.arange(N + 1), np.arange(M + 1), np.arange(P + 1), indexing="ij")
    red_mask = ((ii + jj + kk) % 2 == 0).astype(np.float64)
    return red_mask, ((ii + 2 * jj + 3 * kk) % 7).astype(np.int32)


def make_grid3(x, y, z, dtype=None, device=None) -> Grid3:
    """Grid3 from 1-D node vectors (non-uniform spacings allowed)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    if not x.ndim == y.ndim == z.ndim == 1:
        raise ValueError("make_grid3 expects 1-D node vectors")
    N, M, P = len(x) - 1, len(y) - 1, len(z) - 1
    if min(N, M, P) < 2:
        raise ValueError("grid needs at least one interior point per axis")
    if not all(np.all(np.diff(c) > 0) for c in (x, y, z)):
        raise ValueError("node vectors must increase strictly")
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)

    shape = (N + 1, M + 1, P + 1)
    xx, yy, zz = np.meshgrid(x, y, z, indexing="ij")

    def spacings(c):
        n = len(c) - 1
        h = np.concatenate([[0.0], np.diff(c)])  # h[i] = c_i - c_{i-1}
        h_phalf = np.zeros(n + 1)
        h_phalf[1:n] = 0.5 * (h[1:n] + h[2 : n + 1])
        return h, h_phalf

    def midpoints(c):
        out = np.zeros_like(c)
        out[:-1] = 0.5 * (c[:-1] + c[1:])
        return out

    def safe_recip(a):
        out = np.zeros_like(a)
        nz = a != 0.0
        out[nz] = 1.0 / a[nz]
        return out

    def bx(v):
        return np.broadcast_to(v[:, None, None], shape).copy()

    def by(v):
        return np.broadcast_to(v[None, :, None], shape).copy()

    def bz(v):
        return np.broadcast_to(v[None, None, :], shape).copy()

    h, h_phalf = spacings(x)
    k, k_phalf = spacings(y)
    l, l_phalf = spacings(z)

    interior_mask = np.zeros(shape)
    interior_mask[1:-1, 1:-1, 1:-1] = 1.0
    mask_x1 = np.ones(shape)
    mask_x1[0] = 0.0
    mask_y1 = np.ones(shape)
    mask_y1[:, 0] = 0.0
    mask_z1 = np.ones(shape)
    mask_z1[:, :, 0] = 0.0

    # the 0-sentinels of h (at 0) and h_phalf (at 0 and N) restrict each
    # product to its defining index range
    w_H = bx(h_phalf) * by(k_phalf) * bz(l_phalf) * interior_mask
    w_gx = bx(h) * by(k_phalf) * bz(l_phalf)
    w_gy = bx(h_phalf) * by(k) * bz(l_phalf)
    w_gz = bx(h_phalf) * by(k_phalf) * bz(l)

    red_mask, color7 = colourings3(N, M, P)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    return Grid3(
        xx=dev(xx),
        yy=dev(yy),
        zz=dev(zz),
        xx_phalf=dev(bx(midpoints(x))),
        yy_phalf=dev(by(midpoints(y))),
        zz_phalf=dev(bz(midpoints(z))),
        hh_phalf=dev(bx(h_phalf)),
        kk_phalf=dev(by(k_phalf)),
        ll_phalf=dev(bz(l_phalf)),
        inv_hh=dev(bx(safe_recip(h))),
        inv_kk=dev(by(safe_recip(k))),
        inv_ll=dev(bz(safe_recip(l))),
        inv_hh_phalf=dev(bx(safe_recip(h_phalf))),
        inv_kk_phalf=dev(by(safe_recip(k_phalf))),
        inv_ll_phalf=dev(bz(safe_recip(l_phalf))),
        interior_mask=dev(interior_mask),
        mask_x1=dev(mask_x1),
        mask_y1=dev(mask_y1),
        mask_z1=dev(mask_z1),
        w_H=dev(w_H),
        w_gx=dev(w_gx),
        w_gy=dev(w_gy),
        w_gz=dev(w_gz),
        red_mask=dev(red_mask),
        color7=torch.as_tensor(color7, device=device).contiguous(),
        N=N,
        M=M,
        P=P,
    )


def make_uniform_grid3(N: int, M: int, P: int, dtype=None, device=None) -> Grid3:
    """Uniform grid on [0,1]³ with N×M×P cells."""
    return make_grid3(
        np.linspace(0.0, 1.0, N + 1),
        np.linspace(0.0, 1.0, M + 1),
        np.linspace(0.0, 1.0, P + 1),
        dtype,
        device,
    )
