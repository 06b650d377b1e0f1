"""Kernel C in its collecting mode (``k_miller_f``): the least time its work
needs at the chunk's lanes (``roofline/miller_f_collect.py``) over its mean
device time, in %."""

from bench_gpu.metrics._common import roofline_share
from bench_gpu.roofline import miller_f_collect


def read(trace):
    return roofline_share(trace, miller_f_collect)
