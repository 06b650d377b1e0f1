"""Distinct (P, Q) pairs: the ``pairs`` kind."""

from __future__ import annotations

import random
from typing import Tuple

from ..generate import g1_progression, g2_progression, scalar


def make(seed: int, pool: int, g2_pool: int, **_) -> Tuple[list, list]:
    """``pool`` distinct pairs (P_i, Q_i) = ([p0 + i dp] G1, [q0 + j dq] G2)
    with j = i mod ``g2_pool``: every P differs, and every Q within any
    ``g2_pool`` consecutive pairs (a G2 point costs three times a G1 point)."""
    if pool % g2_pool:
        raise ValueError("the pool must hold whole strides of G2 points")
    rng = random.Random(seed)
    p0, dp, q0, dq = (scalar(rng) for _ in range(4))
    qs = g2_progression(q0, dq, g2_pool)
    return g1_progression(p0, dp, pool), qs * (pool // g2_pool)
