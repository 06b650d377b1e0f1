"""Per-layer metric readers, one file each, named as the metric is in
``BENCHMARK.json``; each defines ``read(trace)`` (``tracing.Trace``) and
returns a number, or None when the trace holds nothing to read."""
