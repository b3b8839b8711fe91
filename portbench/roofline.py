"""Peaks of one NVIDIA H100 SXM (published data sheet, 700 W) and the
least time a float64 solve kernel could take: each input read once and
the output written once over the HBM rate, or its operations over the
float64 rate, whichever is larger."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_F64_FLOPS = 34e12

#: arrays read or written once by one solve: b, the stencil's planes, the
#: Jacobi diagonal, the mask and x (K1: 5 planes, K5: 7 volumes)
SOLVE_ARRAYS = {"K1": 9, "K5": 11}
#: operations a point and iteration: two stencil applies (2·stencil−1
#: each), six dot products (2 each) and the updates (~14)
STENCIL_POINTS = {"K1": 5, "K5": 7}


def solve_bytes(kernel: str, systems: int, points: int) -> int:
    return SOLVE_ARRAYS[kernel] * systems * points * 8


def solve_ops(kernel: str, systems: int, points: int, iterations: float) -> float:
    per_point = 2 * (2 * STENCIL_POINTS[kernel] - 1) + 6 * 2 + 14
    return per_point * systems * points * max(iterations, 1.0)


def solve_bound_s(kernel: str, systems: int, points: int, iterations: float = 1.0) -> float:
    """The least seconds one launch could take."""
    t_bytes = solve_bytes(kernel, systems, points) / HBM_BYTES_PER_S
    t_ops = solve_ops(kernel, systems, points, iterations) / PEAK_F64_FLOPS
    return max(t_bytes, t_ops)
