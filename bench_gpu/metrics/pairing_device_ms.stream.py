"""Device ms a computed chunk of ``pairing_stream`` of the kernels launched
inside ``pairing.pairing`` (the whole of ``pairing()`` at the chunk's
lanes), counted per ``stream.chunk`` range."""

from bench_gpu.metrics._stream import CHUNK, device_ms_per


def read(trace):
    return device_ms_per(trace, ("pairing.pairing",), CHUNK)
