"""Device ms a pairing call of the kernels launched inside the port's
``final_exp.*`` ranges (easy part, the three x-power ladders, the hard-part
chain)."""

from bench_gpu.metrics._common import device_ms_in


def read(trace):
    return device_ms_in(trace, ("final_exp.",))
