"""Plain reference of a batch of independent pairings, and its comparison.

A call of the ``bn254_pairing_batch`` cells computes e(P_i, Q_i) over one
slice of the ``pairs`` pool (``generators/pairs.py``). Along a slice both
points run along arithmetic progressions, P_i = [a + i da] G1 and
Q_i = [b + i db] G2, so e(P_i, Q_i) = g^((a + i da)(b + i db)) with
g = e(G1, G2): the exponent is quadratic in i. That gives every lane's
value from three pairings and two Fq12 products a lane, without reading
anything the program computed:

  v_{i+1} = v_i r_i,   r_{i+1} = r_i h,   h = e(P_1 - P_0, Q_1 - Q_0)^2,

with v_0 = e(P_0, Q_0) and r_0 = e(P_1, Q_1) / v_0 from the slice's first
two lanes, the point differences by the oracle's G1 and G2 additions. All
of it is the frozen integer oracle beside this file. A few lanes drawn from
the seed are also checked directly with ``oracle.pairing``, which guards
the recurrence itself.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import oracle as o
from .bn254 import P
from .limbs import NLIMBS, R_MONT, RADIX_BITS, montgomery_matches

_BYTES = -(-RADIX_BITS * NLIMBS // 8)


def lane_values(ps, qs, lanes: range) -> List[list]:
    """e(ps[i], qs[i]) for each i in ``lanes`` (step 1), whose points must run
    along one progression each, by the recurrence above."""
    i0 = lanes.start
    v = o.pairing(ps[i0], qs[i0])
    out = [v]
    if len(lanes) == 1:
        return out
    r = o.fq12_mul(o.pairing(ps[i0 + 1], qs[i0 + 1]), o.fq12_inv(v))
    h = o.pairing(o.g1_add(ps[i0 + 1], o.g1_neg(ps[i0])), o.g2_add(qs[i0 + 1], o.g2_neg(qs[i0])))
    h = o.fq12_mul(h, h)
    for k in range(1, len(lanes)):
        v = o.fq12_mul(v, r)
        out.append(v)
        if k + 1 < len(lanes):
            r = o.fq12_mul(r, h)
    return out


def _digit_rows(vals: Sequence[int]) -> np.ndarray:
    """[N, 21] base-2^13 digits of values below 2^273."""
    raw = np.frombuffer(b"".join(v.to_bytes(_BYTES, "little") for v in vals), dtype=np.uint8)
    bits = np.unpackbits(raw.reshape(len(vals), _BYTES), axis=1, bitorder="little")
    bits = bits[:, :RADIX_BITS * NLIMBS].reshape(len(vals), NLIMBS, RADIX_BITS)
    return bits.astype(np.int64) @ (np.int64(1) << np.arange(RADIX_BITS, dtype=np.int64))


def expected_rows(values: Sequence[list]) -> torch.Tensor:
    """Fq12 values (the oracle's 12 coefficients each) -> [N, 12, 2, 21]: the
    two Montgomery digit rows each coefficient may take below 2p, as
    ``limbs.representatives`` gives them."""
    mont = [c * R_MONT % P for v in values for c in v]
    rows = np.stack([_digit_rows(mont), _digit_rows([m + P for m in mont])], axis=1)
    return torch.from_numpy(rows.reshape(len(values), 12, 2, NLIMBS))


def compare(ps, qs, calls: Sequence[Tuple[range, torch.Tensor]],
            sampled: Sequence[int]) -> Dict[str, int]:
    """Count the program's wrong values.

    ``calls``: (the range of pool indices of a call's lanes, the values it
    produced as limbs [B, 12, 21] in the oracle's coefficient order), for
    every call checked. ``sampled``: pool indices whose value the oracle
    also computes outright, compared wherever a checked call holds them.
    ``value_wrong`` counts the lanes that differ from the recurrence's
    values (every lane of a call of another shape), ``oracle_wrong`` the
    sampled lanes that differ from the oracle's."""
    counts = {"value_wrong": 0, "oracle_wrong": 0}
    want: Dict[Tuple[int, int], torch.Tensor] = {}
    direct = {i: expected_rows([o.pairing(ps[i], qs[i])])[0] for i in sampled}
    for lanes, limbs in calls:
        if tuple(limbs.shape) != (len(lanes), 12, NLIMBS):
            counts["value_wrong"] += len(lanes)
            continue
        key = (lanes.start, lanes.stop)
        if key not in want:
            want[key] = expected_rows(lane_values(ps, qs, lanes))
        ok = montgomery_matches(limbs, want[key].to(limbs.device)).all(dim=-1)
        counts["value_wrong"] += int((~ok).sum())
        for i, reps in direct.items():
            if i in lanes:
                got = montgomery_matches(limbs[lanes.index(i)], reps.to(limbs.device))
                counts["oracle_wrong"] += int(not bool(got.all()))
    return counts
