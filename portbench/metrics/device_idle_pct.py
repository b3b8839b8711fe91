"""device_idle_pct: the share of the traced segment in which no operation
ran on the device (1 − the union of the device intervals over the
segment's host-clock length).  Layer: device."""


def read(ctx):
    if not ctx["window_s"] or not ctx["device_ops"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
