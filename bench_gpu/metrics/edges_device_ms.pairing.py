"""Device ms a pairing call of the kernels launched inside the port's
``pairing.flatten`` (the public points flattened to the kernels' lanes) and
``pairing.output`` (the result from the kernel layout to the public Fq12,
twelve transposed copies) ranges; nothing where the port has neither."""

from bench_gpu.metrics._common import device_ms_in


def read(trace):
    return device_ms_in(trace, ("pairing.flatten", "pairing.output"))
