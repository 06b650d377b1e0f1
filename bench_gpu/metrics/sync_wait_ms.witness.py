"""ms a witness chunk that the host waited in the blocking copies that
``host_syncs.witness`` counts: from each copy's launch call to the end of
the host operation that made it, on the host's clock."""

from bench_gpu.metrics._spans import sync_wait_ms


def read(trace):
    return sync_wait_ms(trace)
