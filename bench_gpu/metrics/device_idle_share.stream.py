"""Share of the traced window in which no kernel, copy or memset ran on the
card, over the traced steps of ``pairing_stream`` (computed and resumed
chunks; taken under the profiler)."""

from bench_gpu.metrics._common import idle_share


def read(trace):
    return idle_share(trace)
