"""ops (port of na_dd_tpu.ops)."""

from na_dd_tpu_torch.ops.grid import Grid, make_grid, make_uniform_grid
from na_dd_tpu_torch.ops.shifts import LOCAL_OPS, LocalOps, Ops
from na_dd_tpu_torch.ops import stencils
from na_dd_tpu_torch.ops import inner_products
from na_dd_tpu_torch.ops.quadrature import avg_int
from na_dd_tpu_torch.ops import linsolve

__all__ = [
    "Grid",
    "make_uniform_grid",
    "make_grid",
    "Ops",
    "LocalOps",
    "LOCAL_OPS",
    "stencils",
    "inner_products",
    "avg_int",
    "linsolve",
]
