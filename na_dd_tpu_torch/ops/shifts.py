"""Zero-inflow axis shifts and global reductions (counterpart of
:mod:`na_dd_tpu.ops.shifts`).

    shift_xm(u)[i, j] = u[i-1, j]     (row 0 of the result is 0)
    shift_xp(u)[i, j] = u[i+1, j]     (row N of the result is 0)
    shift_ym(u)[i, j] = u[i, j-1]     (col 0 of the result is 0)
    shift_yp(u)[i, j] = u[i, j+1]     (col M of the result is 0)
    asum(u), amax(u)  = sum / max over the whole array

The shifts act on the two trailing dimensions, so a stack of planes
(B, N+1, M+1), the batch axis of :mod:`na_dd_tpu_torch.harness.batched_ladder`,
shifts plane by plane and nothing crosses from one plane to the next.
:class:`BatchedOps` reduces each plane of such a stack on its own, to a
(B, 1, 1) tensor that broadcasts against the stack where ``jax.vmap`` would
broadcast a scalar.  Every discrete operator of the port is written through
these, so the sharded provider
(:class:`na_dd_tpu_torch.parallel.halo.HaloOps`) takes the place of
:class:`LocalOps` under domain decomposition.  The provider also owns what
differs there: ``sharded`` (False here), ``matvec`` (the stencil apply of
the Newton solves: K2 here, a halo exchange and K2 on the padded block
there), and ``gather_full`` / ``local_slice``, the whole-array access of
the replicated direct solve (identities on one device).
"""

from __future__ import annotations

import torch


class Ops:
    """Protocol for shift/reduction providers (duck-typed)."""

    #: True for a halo-exchange provider (one rank's block of a grid)
    sharded = False

    def matvec(self, st):
        """``w ↦ st·w`` for a Stencil5 ``st`` on the arrays this provider
        shifts: :func:`~na_dd_tpu_torch.ops.kernels.stencil5_apply` (K2 on
        CUDA tensors, its plain twin on CPU ones)."""
        from na_dd_tpu_torch.ops import kernels

        return lambda w: kernels.stencil5_apply(st, w)

    def shift_xm(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def shift_xp(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def shift_ym(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def shift_yp(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def asum(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    def amax(self, u):  # pragma: no cover - interface
        raise NotImplementedError

    # abstract like the shifts: a provider that forgot them would otherwise
    # make the sharded direct solve factorize its block against zero halos
    def gather_full(self, u):  # pragma: no cover - interface
        """The full global array (identity on one device)."""
        raise NotImplementedError

    def local_slice(self, u_full):  # pragma: no cover - interface
        """This rank's block of a full global array (identity locally)."""
        raise NotImplementedError


class LocalOps(Ops):
    """Single-device shifts along the two trailing dimensions: slice +
    concatenate of a zero edge line."""

    def shift_xm(self, u):
        return torch.cat([torch.zeros_like(u[..., :1, :]), u[..., :-1, :]], dim=-2)

    def shift_xp(self, u):
        return torch.cat([u[..., 1:, :], torch.zeros_like(u[..., :1, :])], dim=-2)

    def shift_ym(self, u):
        return torch.cat([torch.zeros_like(u[..., :1]), u[..., :-1]], dim=-1)

    def shift_yp(self, u):
        return torch.cat([u[..., 1:], torch.zeros_like(u[..., :1])], dim=-1)

    def asum(self, u):
        return torch.sum(u)

    def amax(self, u):
        return torch.amax(u)

    def gather_full(self, u):
        return u

    def local_slice(self, u_full):
        return u_full


class BatchedOps(LocalOps):
    """:class:`LocalOps` on a stack of planes (B, N+1, M+1): the reductions
    run over each plane alone and keep its dimensions, (B, 1, 1)."""

    def asum(self, u):
        return torch.sum(u, dim=(-2, -1), keepdim=True)

    def amax(self, u):
        return torch.amax(u, dim=(-2, -1), keepdim=True)


LOCAL_OPS = LocalOps()
BATCHED_OPS = BatchedOps()
