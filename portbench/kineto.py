"""What a traced segment of the window holds, read from the profiler's raw
kineto events (the host operator tree of ``prof.events()`` costs ~70 us an
event, seconds for a segment of tens of thousands of launches): the device
operations, the device's busy time as the union of their intervals, and
the idle gaps between them, each named by the innermost span of the
benchmark's own that was open on the host in the middle of the gap."""

from __future__ import annotations

import bisect

SPAN_PREFIX = "portbench."
#: the program's hand-written kernels, by the names the profiler reports
PORT_KERNELS = ("bicgstab_kernel", "triple_solve_kernel", "stencil5_apply_kernel",
                "stencil7_apply_kernel")


def read_events(prof):
    """(device ops [(name, start_ns, end_ns)], spans [(name, start_ns,
    end_ns)]) of a finished profile.  The spans' copies on the device's
    timeline (user annotations) are not device operations."""
    device, spans = [], []
    for evt in prof.profiler.kineto_results.events():
        dur = evt.duration_ns()
        if str(evt.device_type()).endswith("CUDA") and not evt.name().startswith(SPAN_PREFIX):
            if not evt.is_async() and dur > 0:
                device.append((evt.name(), evt.start_ns(), evt.start_ns() + dur))
        elif evt.name().startswith(SPAN_PREFIX):
            spans.append((evt.name()[len(SPAN_PREFIX):], evt.start_ns(), evt.start_ns() + dur))
    device.sort(key=lambda e: e[1])
    return device, spans


def is_kernel(name: str) -> bool:
    """A launched kernel, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def busy_intervals(device):
    """The union of the device operations' intervals, sorted."""
    merged = []
    for _name, a, b in device:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_gaps(merged, spans, top: int = 10):
    """[(span name, seconds)] of the gaps between busy intervals, summed by
    the innermost (shortest) span open at each gap's middle ("no span"
    where none is), the longest first."""
    mids = [0.5 * (end + start) for (_, end), (start, _) in zip(merged, merged[1:])]
    lengths = [(start - end) / 1e9 for (_, end), (start, _) in zip(merged, merged[1:])]
    labels = ["no span"] * len(mids)
    # longest spans first, so each gap keeps the innermost span over it
    for name, a, b in sorted(spans, key=lambda s: s[1] - s[2]):
        for i in range(bisect.bisect_left(mids, a), bisect.bisect_right(mids, b)):
            labels[i] = name
    by_name: dict = {}
    for name, sec in zip(labels, lengths):
        by_name[name] = by_name.get(name, 0.0) + sec
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


def top_ops(device, top: int = 10):
    """[(device operation, seconds)], the longest in total first."""
    total: dict = {}
    for name, a, b in device:
        total[name] = total.get(name, 0.0) + (b - a) / 1e9
    return sorted(total.items(), key=lambda kv: -kv[1])[:top]
