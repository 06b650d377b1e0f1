"""Share of the traced window in which no kernel, copy or memset ran on the
card, over the traced pairing calls (taken under the profiler; the copy of
the values to host memory counts as busy)."""

from bench_gpu.metrics._common import idle_share


def read(trace):
    return idle_share(trace)
