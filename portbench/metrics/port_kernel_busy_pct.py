"""port_kernel_busy_pct: the share of the device's kernel time in the
traced segment spent in the program's hand-written kernels (K1–K7, by
their names) against PyTorch's own.  Layer: kernels."""

from portbench.kineto import PORT_KERNELS, is_kernel


def read(ctx):
    total = sum(b - a for name, a, b in ctx["device_ops"] if is_kernel(name))
    if not total:
        return None
    port = sum(b - a for name, a, b in ctx["device_ops"]
               if any(k in name for k in PORT_KERNELS))
    return 100.0 * port / total
