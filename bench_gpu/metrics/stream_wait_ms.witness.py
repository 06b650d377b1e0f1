"""Host ms a hand-over of the witness stream inside
``witness.stream.wait``: the host waiting for the previous chunk's copy to
host memory, which the next chunk's compute did not hide."""

from bench_gpu.metrics._spans import host_ms


def read(trace):
    return host_ms(trace, ("witness.stream.wait",))
