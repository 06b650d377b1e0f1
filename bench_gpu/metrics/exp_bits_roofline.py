"""Kernel K12 (``k_exp_bits``), three launches a witness chunk: the least
time of one at the chunk's lanes (``roofline/exp_bits.py``) over its mean
device time, in %."""

from bench_gpu.metrics._common import roofline_share
from bench_gpu.roofline import exp_bits


def read(trace):
    return roofline_share(trace, exp_bits)
