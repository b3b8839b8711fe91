"""Halo-exchange shift ops for spatial domain decomposition (counterpart of
:mod:`na_dd_tpu.parallel.halo`).

:class:`HaloOps` is the provider of one rank's block of a (N+1, M+1) grid:
rows sharded over the mesh's ``axis_x``, columns over ``axis_y``.  Its
exchanges, all-reduces, gathers and halo-padded matvec are those of
:class:`na_dd_tpu_torch.ops.halo.HaloOpsBase`, which the 3-D provider
(:class:`na_dd_tpu_torch.three_d.shifts.HaloOps3`) shares.
"""

from __future__ import annotations

from na_dd_tpu_torch.ops.halo import HaloOpsBase
from na_dd_tpu_torch.ops.shifts import Ops


class HaloOps(HaloOpsBase, Ops):
    """Shift provider for a block of a (N+1, M+1) grid sharded over a mesh:
    rows over ``axis_x``, columns over ``axis_y``."""
