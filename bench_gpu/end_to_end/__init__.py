"""End-to-end metric readers, one file each, named as the metric is in
``BENCHMARK.json``; each defines ``read(window)`` (``harness.Window``: the
measured steps on the host clock, and the set-up seconds)."""
