"""Blocking copies a pairing call: copies between the device and pageable
host memory whose launch call lies inside the port's ranges (``pairing.``,
``validate.``, ``miller_loop.``, ``final_exp.``, ``witness.``). Each one
blocks the host until the stream has drained. A count."""

from bench_gpu.metrics._spans import syncs_a_step


def read(trace):
    return syncs_a_step(trace)
