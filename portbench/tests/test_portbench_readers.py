"""The trace reduction and the per-layer readers on a synthetic traced
segment: device intervals, their union, idle gaps named by the innermost
span, and each reader's value (or None where it finds nothing)."""

import pytest

from portbench import kineto, roofline
from portbench.harness import ROOT, load_module

K5 = "void bicgstab::bicgstab_kernel<double, (anonymous namespace)::Stencil7Op<double>, false>"
K1B = "void bicgstab::bicgstab_kernel<double, Stencil5Op<double>, true>"


def _ctx(device, **kw):
    ctx = {"config": {"N": 128, "dim": 3}, "members": 1, "device_ops": device, "spans": [],
           "busy_s": 0.0, "window_s": 0.0, "steps": 0, "wrapper_us": [], "solve_iters": {}}
    ctx.update(kw)
    return ctx


def read(name, ctx):
    return load_module(ROOT, "metrics", name).read(ctx)


def test_union_and_gaps_by_innermost_span():
    dev = [("a", 0, 10), ("b", 5, 20), ("a", 30, 40), ("c", 100, 110)]
    merged = kineto.busy_intervals(dev)
    assert merged == [[0, 20], [30, 40], [100, 110]]
    spans = [("unit", 0, 200), ("step", 0, 50), ("solve_wrapper", 22, 28)]
    gaps = dict(kineto.idle_gaps(merged, spans))
    assert gaps == pytest.approx({"solve_wrapper": 10e-9, "unit": 60e-9})
    assert dict(kineto.idle_gaps(merged, [])) == pytest.approx({"no span": 70e-9})


def test_top_ops_and_kernel_filter():
    dev = [("k", 0, 10), ("Memcpy DtoH (Device -> Pinned)", 10, 40), ("k", 50, 60)]
    assert kineto.top_ops(dev)[0] == ("Memcpy DtoH (Device -> Pinned)", 30e-9)
    assert not kineto.is_kernel("Memset (Device)")
    assert kineto.is_kernel(K5)


def test_idle_launches_and_port_share():
    dev = [("elementwise", 0, 300), (K5, 400, 600), ("Memcpy HtoD", 700, 800)]
    ctx = _ctx(dev, busy_s=600e-9, window_s=1000e-9, steps=2)
    assert read("device_idle_pct", ctx) == pytest.approx(40.0)
    assert read("launches_per_step", ctx) == pytest.approx(1.0)
    assert read("port_kernel_busy_pct", ctx) == pytest.approx(40.0)


def test_roofline_readers_use_the_bound_over_device_time():
    t = roofline.solve_bound_s("K5", 1, 129 ** 3, 1.0)
    dev = [(K5, 0, int(4 * t * 1e9)), (K1B, 0, 1000)]
    ctx = _ctx(dev, solve_iters={"bicgstab_solve3": [1.0, 1.0]})
    assert read("k5_roofline_pct", ctx) == pytest.approx(25.0, rel=1e-4)
    tb = roofline.solve_bound_s("K1", 32, 257 ** 2, 2.0)
    ctx1 = _ctx([(K1B, 0, int(10 * tb * 1e9))], config={"N": 256, "dim": 2}, members=32,
                solve_iters={"bicgstab_solve": [2.0]})
    assert read("k1_roofline_pct", ctx1) == pytest.approx(10.0, rel=1e-4)


def test_readers_return_nothing_where_nothing_was_traced():
    ctx = _ctx([])
    for name in ("device_idle_pct", "launches_per_step", "port_kernel_busy_pct",
                 "solve_wrapper_us", "k5_roofline_pct", "k1_roofline_pct"):
        assert read(name, ctx) is None
    assert read("solve_wrapper_us", _ctx([], wrapper_us=[3.0, 1.0, 2.0])) == 2.0
