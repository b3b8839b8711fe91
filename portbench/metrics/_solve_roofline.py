"""The roofline share of a solve kernel in the traced segment: the sum over
its launches of the least time each could take (``portbench.roofline``)
over the sum of their device times."""

from portbench.roofline import solve_bound_s


def share(ctx, kernel: str, op_name: str, wrapper: str):
    cfg = ctx["config"]
    launches = [(b - a) / 1e9 for name, a, b in ctx["device_ops"]
                if "bicgstab_kernel" in name and op_name in name]
    if not launches:
        return None
    iters = ctx["solve_iters"].get(wrapper) or [1.0]
    mean_iters = sum(iters) / len(iters)
    points = (cfg["N"] + 1) ** cfg["dim"]
    bound = solve_bound_s(kernel, ctx["members"], points, mean_iters)
    return 100.0 * bound * len(launches) / sum(launches)
