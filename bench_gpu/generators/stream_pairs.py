"""A job of independent pairs as a user hands it to ``pairing_stream``: the
``stream_pairs`` kind.

Two pools of points along seeded arithmetic progressions: ``g1_pool`` G1
points, and ``chunk_size + (T - 1) g2_shift`` G2 points, where a job of
``pairs`` pairs is ``S T`` chunks with S = ``g1_pool / chunk_size``. Chunk
c = S t + s (s = c mod S) holds, at its lane k,

    P = G1[chunk_size s + k],   Q = G2[g2_shift t + k].

P's index fixes (s, k) and Q's index then fixes t, so every pair of the job
is distinct; and within a chunk both points run along one progression each
(step 1), as ``reference/pairing_batch.lane_values`` needs. The job is two
lists of ``pairs`` references to the pools' tuples of Python ints.
"""

from __future__ import annotations

import random
from typing import Tuple

from ..generate import g1_progression, g2_progression, scalar


def make(seed: int, pairs: int, chunk_size: int, g1_pool: int, g2_shift: int,
         **_) -> Tuple[list, list]:
    if pairs % chunk_size or g1_pool % chunk_size:
        raise ValueError("the job and the G1 pool must hold whole chunks")
    strides = g1_pool // chunk_size
    chunks = pairs // chunk_size
    if chunks % strides:
        raise ValueError("the job must hold whole runs of the G1 pool")
    shifts = chunks // strides
    rng = random.Random(seed)
    p0, dp, q0, dq = (scalar(rng) for _ in range(4))
    g1 = g1_progression(p0, dp, g1_pool)
    g2 = g2_progression(q0, dq, chunk_size + (shifts - 1) * g2_shift)
    ps, qs = [], []
    for c in range(chunks):
        s, t = c % strides, c // strides
        ps.extend(g1[chunk_size * s:chunk_size * (s + 1)])
        qs.extend(g2[g2_shift * t:g2_shift * t + chunk_size])
    return ps, qs
