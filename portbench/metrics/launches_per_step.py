"""launches_per_step: device kernels (copies and fills left out) in the
traced segment over its steps.  Layer: integrator (step_fn and the physics
it calls)."""

from portbench.kineto import is_kernel


def read(ctx):
    if not ctx["steps"] or not ctx["device_ops"]:
        return None
    return sum(1 for name, _a, _b in ctx["device_ops"] if is_kernel(name)) / ctx["steps"]
