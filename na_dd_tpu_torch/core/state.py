"""Five-field simulation state (counterpart of :mod:`na_dd_tpu.core.state`)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class State(NamedTuple):
    cp: torch.Tensor  # polymer concentration
    T: torch.Tensor  # temperature
    cl: torch.Tensor  # solvent (liquid) concentration
    cd: torch.Tensor  # dissolved drug concentration
    cs: torch.Tensor  # solid drug concentration


def heaviside_regularized(x, regularization_factor: float):
    """H_eta(x) = 1 / (1 + exp(-eta x)) as the stable sigmoid, so a large
    |eta x| saturates to exactly 0 or 1 instead of overflowing ``exp``."""
    return torch.sigmoid(regularization_factor * x)
