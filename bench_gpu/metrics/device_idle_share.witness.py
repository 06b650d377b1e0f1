"""Share of the traced window in which no kernel, copy or memset ran on the
card, over the traced hand-overs of the witness stream (taken under the
profiler; the device-to-host copies count as busy)."""

from bench_gpu.metrics._common import idle_share


def read(trace):
    return idle_share(trace)
