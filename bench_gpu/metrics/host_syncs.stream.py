"""Blocking copies a step of ``pairing_stream``: copies between the device
and pageable host memory whose launch call lies inside the port's ranges
(``stream.``, ``pairing.``, ``validate.``, ``miller_loop.``,
``final_exp.``, ``witness.``); a step is one chunk, computed or resumed.
Each one blocks the host until the stream has drained. A count."""

from bench_gpu.metrics._stream import syncs_a_step


def read(trace):
    return syncs_a_step(trace)
