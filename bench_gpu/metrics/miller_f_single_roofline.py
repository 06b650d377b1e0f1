"""Kernel C with one pair a lane (``k_miller_f``, K = 1): the least time its
work needs at the call's lanes (``roofline/miller_f_multi.py`` at the shapes
(products, pairs) = (lanes, 1)) over its mean device time, in %."""

from bench_gpu.metrics._common import roofline_share
from bench_gpu.roofline import miller_f_multi


def read(trace):
    return roofline_share(trace, miller_f_multi)
