"""Zero-inflow axis shifts and global reductions on (N+1, M+1, P+1) volumes
(counterpart of :mod:`na_dd_tpu.three_d.shifts`).

    shift_xm(u)[i,j,k] = u[i-1,j,k]       shift_xp(u)[i,j,k] = u[i+1,j,k]
    shift_ym(u)[i,j,k] = u[i,j-1,k]       shift_yp(u)[i,j,k] = u[i,j+1,k]
    shift_zm(u)[i,j,k] = u[i,j,k-1]       shift_zp(u)[i,j,k] = u[i,j,k+1]
    asum(u), amax(u)   = sum / max over the whole array

Out-of-range entries are 0.  The shifts act on the three trailing
dimensions, so a stack of volumes (B, N+1, M+1, P+1) shifts volume by volume;
:class:`BatchedOps3` reduces each volume alone, to (B, 1, 1, 1).  Every 3-D
operator of the port is written through these, so :class:`HaloOps3` takes
the place of :class:`LocalOps3` under domain decomposition: x and y sharded
over a 2-D mesh of ranks (halo planes by point-to-point exchanges, the
reductions all-reduced; :mod:`na_dd_tpu_torch.ops.halo`), z whole on
each rank, as in the JAX package.
"""

from __future__ import annotations

import torch

from na_dd_tpu_torch.ops.halo import HaloOpsBase


class Ops3:
    """Protocol for 3-D shift/reduction providers (duck-typed)."""

    #: True for a halo-exchange provider (one rank's block of a grid)
    sharded = False

    def matvec(self, st):
        """``w ↦ st·w`` for a Stencil7 ``st`` on the arrays this provider
        shifts: :func:`~na_dd_tpu_torch.ops.kernels.stencil7_apply` (K6 on
        CUDA tensors, its plain twin on CPU ones)."""
        from na_dd_tpu_torch.ops import kernels

        return lambda w: kernels.stencil7_apply(st, w)

    def shift_xm(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def shift_xp(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def shift_ym(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def shift_yp(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def shift_zm(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def shift_zp(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def asum(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def amax(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def gather_full(self, u):  # pragma: no cover - interface
        """The full global array (identity on one device)."""
        raise NotImplementedError

    def local_slice(self, u_full):  # pragma: no cover - interface
        """This rank's block of a full global array (identity locally)."""
        raise NotImplementedError


class LocalOps3(Ops3):
    """Single-device shifts along the three trailing dimensions: slice +
    concatenate of a zero edge plane."""

    def shift_xm(self, u):
        return torch.cat([torch.zeros_like(u[..., :1, :, :]), u[..., :-1, :, :]], dim=-3)

    def shift_xp(self, u):
        return torch.cat([u[..., 1:, :, :], torch.zeros_like(u[..., :1, :, :])], dim=-3)

    def shift_ym(self, u):
        return torch.cat([torch.zeros_like(u[..., :1, :]), u[..., :-1, :]], dim=-2)

    def shift_yp(self, u):
        return torch.cat([u[..., 1:, :], torch.zeros_like(u[..., :1, :])], dim=-2)

    def shift_zm(self, u):
        return torch.cat([torch.zeros_like(u[..., :1]), u[..., :-1]], dim=-1)

    def shift_zp(self, u):
        return torch.cat([u[..., 1:], torch.zeros_like(u[..., :1])], dim=-1)

    def asum(self, u):
        return torch.sum(u)

    def amax(self, u):
        return torch.amax(u)

    def gather_full(self, u):
        return u

    def local_slice(self, u_full):
        return u_full


class BatchedOps3(LocalOps3):
    """:class:`LocalOps3` on a stack of volumes (B, N+1, M+1, P+1): the
    reductions run over each volume alone and keep its dimensions,
    (B, 1, 1, 1)."""

    def asum(self, u):
        return torch.sum(u, dim=(-3, -2, -1), keepdim=True)

    def amax(self, u):
        return torch.amax(u, dim=(-3, -2, -1), keepdim=True)


class HaloOps3(HaloOpsBase, Ops3):
    """Shift provider for a block of a 3-D grid sharded over a 2-D mesh:
    array axis 0 over ``axis_x``, axis 1 over ``axis_y``; the z axis (the
    last) is never sharded, so its shifts are the local ones."""

    XDIM = -3
    YDIM = -2

    shift_zm = LocalOps3.shift_zm
    shift_zp = LocalOps3.shift_zp


LOCAL_OPS3 = LocalOps3()
BATCHED_OPS3 = BatchedOps3()
