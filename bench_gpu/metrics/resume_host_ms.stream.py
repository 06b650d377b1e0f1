"""Host ms a resumed chunk of ``pairing_stream`` inside ``stream.resume``:
the checkpoint loaded and its digest checked against the inputs."""

from bench_gpu.metrics._stream import RESUME, host_ms_per


def read(trace):
    return host_ms_per(trace, (RESUME,), RESUME)
