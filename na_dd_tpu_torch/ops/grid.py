"""Tensor-product grid on [0,1]² (counterpart of :mod:`na_dd_tpu.ops.grid`).

The metrics are computed on the host in float64 with numpy, exactly as the
JAX package does, and shipped once to the device in the working dtype.  Where
the reference stored ``inf`` (h[0], k[0], the half-steps at the ends) the
reciprocal metrics hold 0, so every consumer multiplies and boundary rows and
columns vanish without ``inf * 0``.  Every array is a full (N+1, M+1) plane.
The probing path's colourings (``red_mask``, ``color5``) are made once with
the grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from na_dd_tpu_torch.config import resolve_device, resolve_dtype


@dataclasses.dataclass(frozen=True)
class Grid:
    # coordinates
    xx: torch.Tensor  # node x, broadcast to (N+1, M+1)
    yy: torch.Tensor  # node y
    xx_phalf: torch.Tensor  # x_{i+1/2} at [i, j] for i < N; 0 at i = N
    yy_phalf: torch.Tensor  # y_{j+1/2} at [i, j] for j < M; 0 at j = M
    # metrics (0 where the reference stored inf)
    hh: torch.Tensor  # h_i for i >= 1; 0 at i = 0
    kk: torch.Tensor  # k_j for j >= 1; 0 at j = 0
    hh_phalf: torch.Tensor  # h_{i+1/2} on rows 1..N-1; 0 at 0, N
    kk_phalf: torch.Tensor  # k_{j+1/2} on cols 1..M-1; 0 at 0, M
    inv_hh: torch.Tensor
    inv_kk: torch.Tensor
    inv_hh_phalf: torch.Tensor
    inv_kk_phalf: torch.Tensor
    # masks and inner-product weights
    interior_mask: torch.Tensor  # 1 on 1..N-1 × 1..M-1
    mask_x1: torch.Tensor  # 0 on row 0
    mask_y1: torch.Tensor  # 0 on col 0
    w_H: torch.Tensor  # h_{i+1/2} k_{j+1/2} on the interior
    w_pk: torch.Tensor  # h_i k_{j+1/2} on rows 1..N × cols 1..M-1
    w_hp: torch.Tensor  # h_{i+1/2} k_j on rows 1..N-1 × cols 1..M
    red_mask: torch.Tensor  # 1 where (i+j) is even (two-colour diagonal probing)
    color5: torch.Tensor  # (i + 2j) mod 5, int32: a node and its 4 neighbours differ
    N: int
    M: int

    @property
    def dtype(self) -> torch.dtype:
        return self.xx.dtype

    @property
    def device(self) -> torch.device:
        return self.xx.device


def colourings(N: int, M: int):
    """``(red_mask, color5)`` of an (N+1, M+1) plane as numpy arrays: the
    (i+j) parity (float64) and the (i + 2j) mod 5 colouring (int32), under
    which the neighbour at offset (a, b) has colour (c + a + 2b) mod 5."""
    ii, jj = np.meshgrid(np.arange(N + 1), np.arange(M + 1), indexing="ij")
    red_mask = ((ii + jj) % 2 == 0).astype(np.float64)
    return red_mask, ((ii + 2 * jj) % 5).astype(np.int32)


def make_grid(x, y, dtype=None, device=None) -> Grid:
    """Grid from 1-D node vectors (non-uniform spacings allowed)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    assert x.ndim == 1 and y.ndim == 1, "make_grid expects 1-D coordinate vectors"
    N = len(x) - 1
    M = len(y) - 1
    assert N >= 2 and M >= 2, "grid needs at least one interior point per axis"
    assert np.all(np.diff(x) > 0) and np.all(np.diff(y) > 0)
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)

    xx, yy = np.meshgrid(x, y, indexing="ij")
    xx_phalf = np.zeros_like(xx)
    xx_phalf[:-1, :] = 0.5 * (xx[:-1, :] + xx[1:, :])
    yy_phalf = np.zeros_like(yy)
    yy_phalf[:, :-1] = 0.5 * (yy[:, :-1] + yy[:, 1:])

    h = np.concatenate([[0.0], np.diff(x)])
    k = np.concatenate([[0.0], np.diff(y)])
    h_phalf = np.zeros(N + 1)
    h_phalf[1:N] = 0.5 * (h[1:N] + h[2 : N + 1])
    k_phalf = np.zeros(M + 1)
    k_phalf[1:M] = 0.5 * (k[1:M] + k[2 : M + 1])

    def bx(v):
        return np.broadcast_to(v[:, None], (N + 1, M + 1)).copy()

    def by(v):
        return np.broadcast_to(v[None, :], (N + 1, M + 1)).copy()

    hh, kk, hh_phalf, kk_phalf = bx(h), by(k), bx(h_phalf), by(k_phalf)

    def safe_recip(a):
        out = np.zeros_like(a)
        nz = a != 0.0
        out[nz] = 1.0 / a[nz]
        return out

    interior_mask = np.zeros((N + 1, M + 1))
    interior_mask[1:-1, 1:-1] = 1.0
    mask_x1 = np.ones((N + 1, M + 1))
    mask_x1[0, :] = 0.0
    mask_y1 = np.ones((N + 1, M + 1))
    mask_y1[:, 0] = 0.0

    w_H = hh_phalf * kk_phalf * interior_mask
    w_pk = np.zeros((N + 1, M + 1))
    w_pk[1:, 1:-1] = hh[1:, 1:-1] * kk_phalf[1:, 1:-1]
    w_hp = np.zeros((N + 1, M + 1))
    w_hp[1:-1, 1:] = hh_phalf[1:-1, 1:] * kk[1:-1, 1:]

    red_mask, color5 = colourings(N, M)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    return Grid(
        xx=dev(xx),
        yy=dev(yy),
        xx_phalf=dev(xx_phalf),
        yy_phalf=dev(yy_phalf),
        hh=dev(hh),
        kk=dev(kk),
        hh_phalf=dev(hh_phalf),
        kk_phalf=dev(kk_phalf),
        inv_hh=dev(safe_recip(hh)),
        inv_kk=dev(safe_recip(kk)),
        inv_hh_phalf=dev(safe_recip(hh_phalf)),
        inv_kk_phalf=dev(safe_recip(kk_phalf)),
        interior_mask=dev(interior_mask),
        mask_x1=dev(mask_x1),
        mask_y1=dev(mask_y1),
        w_H=dev(w_H),
        w_pk=dev(w_pk),
        w_hp=dev(w_hp),
        red_mask=dev(red_mask),
        color5=torch.as_tensor(color5, device=device).contiguous(),
        N=N,
        M=M,
    )


def make_uniform_grid(N: int, M: int, dtype=None, device=None) -> Grid:
    """Uniform grid on [0,1]² with N×M cells."""
    return make_grid(
        np.linspace(0.0, 1.0, N + 1), np.linspace(0.0, 1.0, M + 1), dtype, device
    )
