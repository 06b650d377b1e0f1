"""Host ms a computed chunk of ``pairing_stream`` inside the union of
``stream.digest`` (SHA-256 of the chunk's inputs) and ``stream.checkpoint``
(the npz written to a temporary name and renamed)."""

from bench_gpu.metrics._stream import CHUNK, host_ms_per


def read(trace):
    return host_ms_per(trace, ("stream.digest", "stream.checkpoint"), CHUNK)
