"""Device ms a verify call of the kernels launched inside the port's
``miller_loop.*`` ranges (phases B, N, C and D of ``multi_pairing``)."""

from bench_gpu.metrics._common import device_ms_in


def read(trace):
    return device_ms_in(trace, ("miller_loop.",))
