"""Device ms a verify call of the kernels launched inside the port's
``validate.*`` ranges (``validate_inputs`` with kernel H's end-only mode,
the curve equations of C and vk_x, and their glue)."""

from bench_gpu.metrics._common import device_ms_in


def read(trace):
    return device_ms_in(trace, ("validate.",))
