"""Device ms a pairing call of the kernels launched inside the port's
``miller_loop.*`` ranges (phases B, N, C and D of ``pairing``, kernel C at
K = 1)."""

from bench_gpu.metrics._common import device_ms_in


def read(trace):
    return device_ms_in(trace, ("miller_loop.",))
