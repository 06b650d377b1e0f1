"""Kernel C in its K-pair mode (``k_miller_f``): the least time its work
needs at the call's products and pairs (``roofline/miller_f_multi.py``)
over its mean device time, in %."""

from bench_gpu.metrics._common import roofline_share
from bench_gpu.roofline import miller_f_multi


def read(trace):
    return roofline_share(trace, miller_f_multi)
