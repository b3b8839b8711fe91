"""parallel (port of na_dd_tpu.parallel): multi-rank execution over
``torch.distributed``.

* :mod:`.launch` — :func:`run_ranks`, one SPMD process per block;
* :mod:`.sharding` — :func:`make_mesh`, :func:`shard_grid_and_state`;
* :mod:`.halo` — :class:`HaloOps`, the halo-exchange shift provider
  (its machinery is :mod:`na_dd_tpu_torch.ops.halo`; ``HaloOps3`` is in
  :mod:`na_dd_tpu_torch.three_d.shifts`);
* :mod:`.step` — :func:`build_sharded_step`, :func:`build_sharded_simulation`;
* :mod:`.dryrun` — :func:`dryrun_multichip`;
* :func:`simulate_ensemble` — the data-parallel ensemble
  (:mod:`na_dd_tpu_torch.harness.ensemble`).
"""

from na_dd_tpu_torch.harness.ensemble import simulate_ensemble
from na_dd_tpu_torch.parallel.dryrun import dryrun_multichip
from na_dd_tpu_torch.parallel.halo import HaloOps
from na_dd_tpu_torch.parallel.launch import run_ranks
from na_dd_tpu_torch.parallel.sharding import make_mesh, shard_grid_and_state
from na_dd_tpu_torch.parallel.step import build_sharded_simulation, build_sharded_step

__all__ = [
    "HaloOps",
    "make_mesh",
    "shard_grid_and_state",
    "build_sharded_step",
    "build_sharded_simulation",
    "run_ranks",
    "dryrun_multichip",
    "simulate_ensemble",
]
