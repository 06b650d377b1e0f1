"""Device ms a computed chunk of ``pairing_stream`` of the kernels launched
inside ``stream.canonical``: the canonical export
(``fq12_to_canonical_limbs``: ``from_mont`` glue, then ``k_canonical``'s
digits mode)."""

from bench_gpu.metrics._stream import CHUNK, device_ms_per


def read(trace):
    return device_ms_per(trace, ("stream.canonical",), CHUNK)
