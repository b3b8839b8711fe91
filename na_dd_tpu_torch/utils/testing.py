"""Test utilities (counterpart of :mod:`na_dd_tpu.utils.testing` and of the
reference's src/utils_for_testing.py).

The rate-report helpers live in :mod:`na_dd_tpu_torch.harness.rates`; this
module adds the dense Newton-step helper used by algebraic unit tests.
"""

from __future__ import annotations

import numpy as np


def solve_newton_step_Fx_eq_C(*, x0, Fx0, JacFx0, C):
    """One dense Newton step for F(x) = C: x1 = x0 + JacFx0⁻¹ (C - F(x0))
    (reference src/utils_for_testing.py:7-62).  NumPy-dense, test-only;
    tensors are moved to the host first."""
    x0, Fx0, C, JacFx0 = (_host(a) for a in (x0, Fx0, C, JacFx0))
    if x0.ndim != 1 or Fx0.ndim != 1 or C.ndim != 1:
        raise ValueError("x0, Fx0, C must be 1-D arrays")
    dim = x0.shape[0]
    if Fx0.shape != (dim,) or C.shape != (dim,) or JacFx0.shape != (dim, dim):
        raise ValueError(
            f"Inconsistent dimensions: x0{x0.shape}, Fx0{Fx0.shape}, "
            f"C{C.shape}, JacFx0{JacFx0.shape}"
        )
    try:
        delta = np.linalg.solve(JacFx0, C - Fx0)
    except np.linalg.LinAlgError as e:
        raise np.linalg.LinAlgError(f"Jacobian matrix is singular: {e}")
    return x0 + delta


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
