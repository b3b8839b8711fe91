"""One module a per-layer metric (its ``name`` in ``BENCHMARK.json``): a
``read(ctx)`` that returns the metric's value from a traced run, or None
when the run holds nothing for it to read."""
