"""Carry state across from numpy (or from the JAX package's objects, through
``._asdict()`` / ``np.asarray``) into the port's objects.

This system has no weights: its parameters are the model constants, the grid
nodes, the initial :class:`State` and assembled :class:`Stencil5` planes
(:class:`Stencil7` volumes in 3-D).
Feeding both packages from the same numpy arrays is how the tests hold the
port against the JAX reference.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from na_dd_tpu_torch.config import resolve_device, resolve_dtype
from na_dd_tpu_torch.core.state import State
from na_dd_tpu_torch.models.consts import ModelConsts
from na_dd_tpu_torch.ops.grid import Grid, make_grid
from na_dd_tpu_torch.ops.linsolve import Stencil5
from na_dd_tpu_torch.three_d.diffusion import Stencil7
from na_dd_tpu_torch.three_d.grid import Grid3, make_grid3


def consts_from_dict(d: Mapping[str, float]) -> ModelConsts:
    """ModelConsts from a dict of floats (e.g. a ModelConsts' ``_asdict()``)."""
    return ModelConsts(**{k: float(v) for k, v in d.items()})


def grid_from_nodes(x, y, dtype=None, device=None) -> Grid:
    """Grid from the 1-D node vectors x (length N+1) and y (length M+1)."""
    return make_grid(np.asarray(x), np.asarray(y), dtype=dtype, device=device)


def grid3_from_nodes(x, y, z, dtype=None, device=None) -> Grid3:
    """Grid3 from the 1-D node vectors x, y and z."""
    return make_grid3(np.asarray(x), np.asarray(y), np.asarray(z), dtype=dtype, device=device)


def tensor_from_numpy(a, dtype=None, device=None) -> torch.Tensor:
    return torch.as_tensor(
        np.asarray(a), dtype=resolve_dtype(dtype), device=resolve_device(device)
    ).contiguous()


def state_from_numpy(fields, dtype=None, device=None) -> State:
    """State from a mapping {cp, T, cl, cd, cs} or a sequence in that order."""
    if isinstance(fields, Mapping):
        fields = [fields[name] for name in State._fields]
    return State(*(tensor_from_numpy(a, dtype, device) for a in fields))


def stencil5_from_numpy(planes: Sequence, dtype=None, device=None) -> Stencil5:
    """Stencil5 from (c0, cxm, cxp, cym, cyp) or a mapping with those keys."""
    if isinstance(planes, Mapping):
        planes = [planes[name] for name in Stencil5._fields]
    return Stencil5(*(tensor_from_numpy(a, dtype, device) for a in planes))


def stencil7_from_numpy(planes: Sequence, dtype=None, device=None) -> Stencil7:
    """Stencil7 from (c0, cxm, cxp, cym, cyp, czm, czp) or a mapping with
    those keys."""
    if isinstance(planes, Mapping):
        planes = [planes[name] for name in Stencil7._fields]
    return Stencil7(*(tensor_from_numpy(a, dtype, device) for a in planes))
