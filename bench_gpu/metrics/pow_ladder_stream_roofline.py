"""Kernel D (``k_pow_ladder_stream``), three launches a final
exponentiation: the least time of one at the call's products
(``roofline/pow_ladder_stream.py``) over its mean device time, in %."""

from bench_gpu.metrics._common import roofline_share
from bench_gpu.roofline import pow_ladder_stream


def read(trace):
    return roofline_share(trace, pow_ladder_stream)
