"""The halo exchanges and all-reduces of spatial domain decomposition: the
machinery of the sharded ops providers (:class:`HaloOpsBase`;
:class:`na_dd_tpu_torch.parallel.halo.HaloOps` in 2-D,
:class:`na_dd_tpu_torch.three_d.shifts.HaloOps3` in 3-D), counterparts of the
JAX package's ``HaloOps``/``HaloOps3``.

Each rank of a ``torch.distributed`` process group holds one contiguous
block of the grid's rows (and, on a 2-D mesh, of its columns): the
counterpart of one device's block inside the JAX package's ``shard_map``.
The zero-inflow shifts of :mod:`na_dd_tpu_torch.ops.shifts` need one line
from a neighbour, which the provider moves with point-to-point sends and
receives (``lax.ppermute`` in JAX); a block on the edge of the mesh
receives zeros, which is exactly the single-device shift's zero fill, so the
physics code runs unchanged.  The global reductions become all-reduces
(``psum``/``pmax``), :meth:`HaloOpsBase.gather_full` /
:meth:`HaloOpsBase.local_slice` serve the replicated direct solve, and
:meth:`HaloOpsBase.matvec` is the sharded Krylov matvec: one exchange of the
iterate's edges, then K2 (2-D) or K6 (3-D) on the halo-padded block.

Each exchange is a :class:`torch.autograd.Function` whose backward is the
reverse exchange and whose forward-mode rule exchanges the tangent the same
way, so ``torch.func.jvp`` (the Newton couplings) and ``.backward()`` (the
IFT gradients) run through the shifts as they run through the local ones;
:meth:`HaloOpsBase.asum` is a differentiable all-reduce in the same way.
Each exchange posts its sends and receives together
(``dist.batch_isend_irecv``), so no pair of ranks waits on the other's
order.  The gradient convention is the one of a loss summed over the ranks:
each rank's ``backward`` of its own part gives its block's share of the
gradient of the sum.

The gloo backend refuses CUDA tensors in send/recv and all_gather; there a
halo goes through one explicit pinned host copy each way, and
:class:`HaloStats` counts the bytes staged so.  The compute stays on the
card.  No control flow here reads a value of one block alone: every rank
takes the same branches and posts the same exchanges in the same order.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist



@dataclasses.dataclass
class HaloStats:
    """What a rank's ops moved since the last :meth:`reset`: halo exchanges
    (one batch of sends and receives each), all-reduces, all-gathers, and
    the bytes copied through pinned host memory because the backend refused
    a CUDA tensor."""

    exchanges: int = 0
    reductions: int = 0
    gathers: int = 0
    staged_bytes: int = 0

    def reset(self) -> None:
        self.exchanges = self.reductions = self.gathers = self.staged_bytes = 0


def _host_staged(t: torch.Tensor) -> bool:
    """True where the process group's backend cannot take ``t`` in
    send/recv or all_gather: gloo with a CUDA tensor."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _to_host(t: torch.Tensor, stats: HaloStats) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    stats.staged_bytes += host.numel() * host.element_size()
    return host


def _exchange(stats: HaloStats, sends, recvs):
    """Post every ``(tensor, peer)`` of ``sends`` and every ``(like, peer)``
    of ``recvs`` together and wait for all; returns one received tensor per
    receive, shaped and typed as its ``like`` and on its device."""
    ops, bufs = [], []
    for t, peer in sends:
        t = t.contiguous()
        t = _to_host(t, stats) if _host_staged(t) else t
        ops.append(dist.P2POp(dist.isend, t, peer))
    for like, peer in recvs:
        staged = _host_staged(like)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device, pin_memory=staged)
        ops.append(dist.P2POp(dist.irecv, buf, peer))
        bufs.append((buf, like.device, staged))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        stats.exchanges += 1
    out = []
    for buf, device, staged in bufs:
        if staged:
            stats.staged_bytes += buf.numel() * buf.element_size()
            buf = buf.to(device, non_blocking=True)
        out.append(buf)
    return out


def gather_ranks(t: torch.Tensor, stats: HaloStats | None = None, group=None) -> list:
    """Every rank's ``t`` (one shape on all) of ``group`` (None: the default
    group), in rank order, on ``t``'s device: one all-gather, through pinned
    host memory where the backend refuses a CUDA tensor."""
    stats = HaloStats() if stats is None else stats
    t = t.contiguous()
    staged = _host_staged(t)
    src = _to_host(t, stats) if staged else t
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    stats.gathers += 1
    if staged:
        stats.staged_bytes += sum(p.numel() * p.element_size() for p in parts)
        parts = [p.to(t.device, non_blocking=True) for p in parts]
    return parts


def _send_recv(stats: HaloStats, slab, to_rank, from_rank):
    """Send ``slab`` to ``to_rank`` and receive a slab of its shape from
    ``from_rank`` (either may be None: the mesh's edge); zeros where nothing
    is received."""
    sends = [] if to_rank is None else [(slab, to_rank)]
    recvs = [] if from_rank is None else [(slab, from_rank)]
    got = _exchange(stats, sends, recvs)
    return got[0] if got else torch.zeros_like(slab)


class _Shifted(torch.autograd.Function):
    """The halo slab a shift receives: ``slab`` goes to ``to_rank`` and the
    result comes from ``from_rank``.  Backward sends each cotangent back the
    way its value came; the tangent travels as the value does."""

    @staticmethod
    def forward(slab, stats, to_rank, from_rank):
        return _send_recv(stats, slab, to_rank, from_rank)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _slab, ctx.stats, ctx.to_rank, ctx.from_rank = inputs

    @staticmethod
    def backward(ctx, grad):
        return _send_recv(ctx.stats, grad, ctx.from_rank, ctx.to_rank), None, None, None

    @staticmethod
    def jvp(ctx, tangent, *_):
        # through the Function again, so that reverse mode sees the tangent's
        # exchange too (the IFT gradients run through jvp couplings)
        return _Shifted.apply(tangent, ctx.stats, ctx.to_rank, ctx.from_rank)


def _all_reduce(stats: HaloStats, t: torch.Tensor, op) -> torch.Tensor:
    t = t.contiguous()
    dist.all_reduce(t, op=op)
    stats.reductions += 1
    return t


class _AllReduceSum(torch.autograd.Function):
    """``Σ_ranks Σ u``, on every rank.  Under the summed-loss convention the
    cotangent of a replicated sum is the sum of every rank's cotangent; the
    tangent is the all-reduced sum of the tangent."""

    @staticmethod
    def forward(u, stats):
        return _all_reduce(stats, torch.sum(u), dist.ReduceOp.SUM)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, ctx.stats = inputs
        ctx.shape = u.shape

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(ctx.stats, grad.clone(), dist.ReduceOp.SUM).expand(ctx.shape), None

    @staticmethod
    def jvp(ctx, tangent, _):
        return _AllReduceSum.apply(tangent, ctx.stats)


class HaloOpsBase:
    """The sharded shifts and reductions shared by ``HaloOps`` (2-D) and
    ``HaloOps3`` (3-D), each of which also derives from its dimension's
    local protocol (``Ops``/``Ops3``, whose ``matvec`` it pads around): the
    mesh's x axis shards array dimension ``XDIM``, its y axis ``YDIM``
    (negative, counted from the end).

    Args (the JAX twin's fields, and the mesh they come from):
        mesh: a :class:`na_dd_tpu_torch.parallel.sharding.Mesh` whose ranks
            are exactly the blocks of this decomposition.
        axis_x / axis_y: mesh axis names sharding x / y (None: unsharded).
    ``nx``/``ny`` are the blocks along each; ``stats`` counts the traffic.
    """

    XDIM = -2
    YDIM = -1
    sharded = True

    def __init__(self, mesh, axis_x: str | None = "x", axis_y: str | None = None):
        if mesh.group is not None:
            raise ValueError("halo exchanges run over the default group's ranks; "
                             "a mesh of a sub-group serves the data-parallel ensemble only")
        self.mesh = mesh
        self.axis_x = axis_x if axis_x is not None and mesh.size(axis_x) > 1 else None
        self.axis_y = axis_y if axis_y is not None and mesh.size(axis_y) > 1 else None
        self.nx = mesh.size(axis_x) if axis_x is not None else 1
        self.ny = mesh.size(axis_y) if axis_y is not None else 1
        if self.nx * self.ny != mesh.num_ranks:
            raise ValueError(
                f"the ops' axes ({axis_x}: {self.nx}, {axis_y}: {self.ny}) must cover every rank "
                f"of the mesh {dict(zip(mesh.axis_names, mesh.shape))}"
            )
        self.ix, self.iy = self.block_coords(mesh.rank)
        self._rank_of = {self.block_coords(r): r for r in range(mesh.num_ranks)}
        self.stats = HaloStats()

    def block_coords(self, rank: int):
        """(row block, column block) of ``rank``'s block."""
        return (self.mesh.coord(self.axis_x, rank) if self.axis_x is not None else 0,
                self.mesh.coord(self.axis_y, rank) if self.axis_y is not None else 0)

    def __repr__(self):
        return (f"{type(self).__name__}(axis_x={self.axis_x!r}, nx={self.nx}, "
                f"axis_y={self.axis_y!r}, ny={self.ny}, rank={self.mesh.rank})")

    def _peers(self, axis):
        """(previous, next) rank along a sharded mesh axis (None at the
        edge)."""
        return self.mesh.neighbour(axis, -1), self.mesh.neighbour(axis, +1)

    def _shift(self, u, dim, axis, down: bool):
        """``down``: out[i] = u[i-1] along ``dim`` (the "m" shift), else
        out[i] = u[i+1]; the edge line comes from the neighbour block, or is
        0 at the mesh's edge."""
        n = u.shape[dim]
        if down:
            keep, edge = u.narrow(dim, 0, n - 1), u.narrow(dim, n - 1, 1)
        else:
            keep, edge = u.narrow(dim, 1, n - 1), u.narrow(dim, 0, 1)
        if axis is None:
            halo = torch.zeros_like(edge)
        else:
            prev, nxt = self._peers(axis)
            to_rank, from_rank = (nxt, prev) if down else (prev, nxt)
            halo = _Shifted.apply(edge, self.stats, to_rank, from_rank)
        return torch.cat([halo, keep] if down else [keep, halo], dim=dim)

    def shift_xm(self, u):
        return self._shift(u, self.XDIM, self.axis_x, True)

    def shift_xp(self, u):
        return self._shift(u, self.XDIM, self.axis_x, False)

    def shift_ym(self, u):
        return self._shift(u, self.YDIM, self.axis_y, True)

    def shift_yp(self, u):
        return self._shift(u, self.YDIM, self.axis_y, False)

    # -- reductions -------------------------------------------------------
    def asum(self, u):
        """The sum over the global array, on every rank (differentiable)."""
        return _AllReduceSum.apply(u, self.stats)

    def amax(self, u):
        """The max over the global array, on every rank; it feeds only
        verdicts and early exits, so it carries no gradient."""
        return _all_reduce(self.stats, torch.amax(u.detach()), dist.ReduceOp.MAX)

    # -- whole-array access (the replicated direct solve) ------------------
    def gather_full(self, u):
        """The global array on every rank: one all-gather of every block,
        placed by its mesh coordinates.  O(N·M) bytes a call; only the
        replicated direct solve uses it, never the Krylov path."""
        parts = gather_ranks(u, self.stats)
        rows = [torch.cat([parts[self._rank_of[ix, iy]] for iy in range(self.ny)], dim=self.YDIM)
                for ix in range(self.nx)]
        return torch.cat(rows, dim=self.XDIM)

    def local_slice(self, u_full):
        """This rank's block of a global array."""
        rows = u_full.shape[self.XDIM] // self.nx
        cols = u_full.shape[self.YDIM] // self.ny
        u = u_full.narrow(self.XDIM, self.ix * rows, rows)
        return u.narrow(self.YDIM, self.iy * cols, cols).contiguous()

    # -- the halo-padded block (the sharded Krylov matvec) -----------------
    def halo_pad(self, u):
        """``u`` with one more line on each side of the sharded dimensions,
        holding the neighbours' edge lines (0 at the mesh's edge and in the
        corners), from ONE exchange of all four edges."""
        xd, yd = u.dim() + self.XDIM, u.dim() + self.YDIM
        n0, n1 = u.shape[xd], u.shape[yd]
        shape = list(u.shape)
        shape[xd] += 2
        shape[yd] += 2
        out = u.new_zeros(shape)

        def at(rows, cols):
            idx = [slice(None)] * u.dim()
            idx[xd], idx[yd] = rows, cols
            return tuple(idx)

        rows, cols = slice(1, n0 + 1), slice(1, n1 + 1)
        out[at(rows, cols)] = u
        sends, recvs, places = [], [], []

        def edges(axis, first, last, halo_first, halo_last):
            if axis is None:
                return
            for peer, mine, place in zip(self._peers(axis), (first, last),
                                         (halo_first, halo_last)):
                if peer is not None:
                    sends.append((u[mine], peer))
                    recvs.append((u[mine], peer))
                    places.append(place)

        every = slice(None)
        edges(self.axis_x, at(slice(0, 1), every), at(slice(n0 - 1, n0), every),
              at(slice(0, 1), cols), at(slice(n0 + 1, n0 + 2), cols))
        edges(self.axis_y, at(every, slice(0, 1)), at(every, slice(n1 - 1, n1)),
              at(rows, slice(0, 1)), at(rows, slice(n1 + 1, n1 + 2)))
        for place, got in zip(places, _exchange(self.stats, sends, recvs)):
            out[place] = got
        return out

    def halo_crop(self, v):
        """The block's own lines of a halo-padded array."""
        v = v.narrow(self.XDIM, 1, v.shape[self.XDIM] - 2)
        return v.narrow(self.YDIM, 1, v.shape[self.YDIM] - 2)

    def matvec(self, st):
        """``w ↦ st·w`` on a block: one halo exchange of ``w``
        (:meth:`halo_pad`) and the local provider's apply (K2 or K6, the
        plain apply on CPU tensors) on the halo-padded block, whose planes
        are padded once here with zero coefficients in the halo (zero
        inflow at the padded block's edge is what a missing neighbour
        means); the block's own lines of the result."""
        apply = super().matvec(self.pad_planes(st))
        return lambda w: self.halo_crop(apply(self.halo_pad(w)))

    def pad_planes(self, st):
        """A stencil's planes padded as :meth:`halo_pad` pads an operand,
        with zero coefficients in the halo: applied to a halo-padded
        operand, the block's own lines are the sharded apply."""

        def pad(p):
            out = p.new_zeros([n + 2 if d in (p.dim() + self.XDIM, p.dim() + self.YDIM) else n
                               for d, n in enumerate(p.shape)])
            out.narrow(self.XDIM, 1, p.shape[self.XDIM]).narrow(
                self.YDIM, 1, p.shape[self.YDIM]).copy_(p)
            return out

        return type(st)(*(pad(p) for p in st))

