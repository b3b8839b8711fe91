"""solve_wrapper_us: the median host time of one call of the K1/K5 solve
wrappers (``kernels.bicgstab_solve`` / ``bicgstab_solve3``: checks,
scratch, launch and true residual), by the host clock around each call in
the traced run's window.  Layer: solver backend."""

import statistics


def read(ctx):
    if not ctx["wrapper_us"]:
        return None
    return statistics.median(ctx["wrapper_us"])
