"""Host ms a computed chunk of ``pairing_stream`` inside ``stream.encode``:
the chunk's Python int points packed by the native codec
(``fp_from_ints_mont``) and copied to the card."""

from bench_gpu.metrics._stream import CHUNK, host_ms_per


def read(trace):
    return host_ms_per(trace, ("stream.encode",), CHUNK)
