"""Meshes of ranks and the placement of grids and states on them
(counterpart of :mod:`na_dd_tpu.parallel.sharding`).

A :class:`Mesh` lays the ranks of a process group out on named axes, row
major as ``jax.sharding.Mesh`` lays devices out (the last axis fastest), and
knows this rank's coordinates and neighbours.  :func:`shard_grid_and_state`
gives this rank its block of every (N+1, M+1) plane of a ``Grid`` and a
``State`` (and of every (N+1, M+1, P+1) volume of their 3-D twins, x and y
split, z whole): rows split over the mesh's ``axis_x``, columns over
``axis_y``.  ``N`` and ``M`` stay global, as the static fields of the JAX
package's sharded pytrees do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` ranks on the axes ``axis_names``; ``rank`` is this
    process's, at ``coords``.  ``group``: the process group whose ranks
    these are (None: every rank of the default group)."""

    shape: tuple
    axis_names: tuple
    rank: int
    group: object = dataclasses.field(default=None, compare=False)

    @property
    def num_ranks(self) -> int:
        return math.prod(self.shape)

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def coords_of(self, rank: int) -> tuple:
        """The coordinates of ``rank``, one per axis."""
        out = []
        for n in reversed(self.shape):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    @property
    def coords(self) -> tuple:
        return self.coords_of(self.rank)

    def coord(self, axis: str, rank: int | None = None) -> int:
        """``rank``'s (default: this rank's) coordinate along ``axis``."""
        coords = self.coords if rank is None else self.coords_of(rank)
        return coords[self.axis_names.index(axis)]

    def rank_at(self, *coords) -> int:
        """The rank at ``coords`` (one per axis)."""
        rank = 0
        for c, n in zip(coords, self.shape):
            rank = rank * n + c
        return rank

    def neighbour(self, axis: str, step: int):
        """The rank ``step`` places along ``axis`` from this one, or None
        past the mesh's edge."""
        coords = list(self.coords)
        k = self.axis_names.index(axis)
        coords[k] += step
        if not 0 <= coords[k] < self.shape[k]:
            return None
        return self.rank_at(*coords)


def make_mesh(shape: Sequence[int] | None = None, axis_names: Sequence[str] = ("x",), *,
              rank: int | None = None, group=None) -> Mesh:
    """A mesh of the process group's ranks, 1-D over all of them by default.
    ``group`` (default: the whole default group) is the process group of
    the mesh's ranks, as the JAX package's meshes may take the first few
    devices; a process outside it has no mesh and must not call this.
    ``rank`` (default: this process's) names the rank the mesh is seen
    from; a layout may be built for any rank without a process group, which
    is how a checkpoint is read back on fewer or more ranks than wrote it."""
    layout = rank is not None
    if rank is None:
        rank = dist.get_rank(group)
    if shape is None:
        shape = (dist.get_world_size(group),)
    shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    if not layout and math.prod(shape) != dist.get_world_size(group):
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} ranks; the process group "
                         f"has {dist.get_world_size(group)}")
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} is not on a mesh of {shape}")
    return Mesh(shape, axis_names, int(rank), group)


def block_of(mesh: Mesh, u: torch.Tensor, *, axis_x="x", axis_y=None) -> torch.Tensor:
    """This rank's block of a global array: dimension 0 split over
    ``axis_x``, dimension 1 over ``axis_y``."""
    for dim, axis in ((0, axis_x), (1, axis_y)):
        if axis is None:
            continue
        n = mesh.size(axis)
        rows = u.shape[dim] // n
        u = u.narrow(dim, mesh.coord(axis) * rows, rows)
    return u.contiguous()


def _split(mesh, obj, axis_x, axis_y):
    """``obj`` (a Grid/Grid3 dataclass or a State) with every tensor of two
    or more dimensions replaced by this rank's block."""

    def block(v):
        if isinstance(v, torch.Tensor) and v.dim() >= 2:
            return block_of(mesh, v, axis_x=axis_x, axis_y=axis_y)
        return v

    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: block(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return type(obj)(*(block(v) for v in obj))


def shard_grid_and_state(mesh: Mesh, grid, state, *, axis_x="x", axis_y=None):
    """This rank's blocks of a grid and a state (2-D or 3-D).  Requires
    (N+1) % (the mesh's size along axis_x) == 0, and likewise M+1 along
    axis_y."""
    nx = mesh.size(axis_x) if axis_x else 1
    ny = mesh.size(axis_y) if axis_y else 1
    if (grid.N + 1) % nx != 0:
        raise ValueError(f"rows (N+1)={grid.N + 1} must divide evenly over {nx} shards")
    if (grid.M + 1) % ny != 0:
        raise ValueError(f"cols (M+1)={grid.M + 1} must divide evenly over {ny} shards")
    return _split(mesh, grid, axis_x, axis_y), _split(mesh, state, axis_x, axis_y)
