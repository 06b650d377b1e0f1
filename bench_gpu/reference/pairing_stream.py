"""Plain reference of a checkpointed pairing stream, and its comparisons.

A chunk of the ``bn254_pairing_stream`` cells holds e(P_i, Q_i) of the
pairs ``generators/stream_pairs.py`` lays out, whose points run along one
progression each within a chunk; so ``pairing_batch.lane_values`` gives
every lane's value from three pairings and two Fq12 products a lane, all of
it the frozen integer oracle beside this file. The stream yields each value
as its canonical limbs: the base-2^13 digits of every coefficient in
[0, p), out of the Montgomery domain, in the oracle's coefficient order.
A few lanes drawn from the seed are also compared with ``oracle.pairing``
outright, which guards the recurrence itself.

The checkpoints are compared from what the driver saw: which files were
there when it preempted the stream, their inode and modification time then
and after the resumed stream read them, and the bytes the stream yielded
before and after. Nothing here imports the program; numpy compares.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from . import oracle as o
from .limbs import NLIMBS
from .pairing_batch import _digit_rows, lane_values


def canonical_rows(values: Sequence[list]) -> np.ndarray:
    """Fq12 values (the oracle's 12 coefficients each) -> their canonical
    limbs [N, 12, 21] (int64)."""
    return _digit_rows([c for v in values for c in v]).reshape(len(values), 12, NLIMBS)


def compare_values(ps, qs, chunks: Iterable[Tuple[range, np.ndarray]],
                   sampled: Sequence[int]) -> Dict[str, int]:
    """Count the stream's wrong values.

    ``chunks``: (the range of job indices of a chunk's lanes, the limbs the
    stream yielded for it, [m, 12, 21]), for every chunk checked; a chunk
    that appears more than once is worked out once. ``sampled``: job
    indices whose value the oracle also computes outright, compared wherever
    a checked chunk holds them. ``value_wrong`` counts the lanes that differ
    from the recurrence's canonical limbs (every lane of a chunk of another
    shape), ``oracle_wrong`` the sampled lanes that differ from the
    oracle's."""
    counts = {"value_wrong": 0, "oracle_wrong": 0}
    want: Dict[Tuple[int, int], np.ndarray] = {}
    direct = {i: canonical_rows([o.pairing(ps[i], qs[i])])[0] for i in sampled}
    for lanes, limbs in chunks:
        got = np.asarray(limbs)
        if got.shape != (len(lanes), 12, NLIMBS):
            counts["value_wrong"] += len(lanes)
            continue
        key = (lanes.start, lanes.stop)
        if key not in want:
            want[key] = canonical_rows(lane_values(ps, qs, lanes))
        ok = (got.astype(np.int64) == want[key]).all(axis=(1, 2))
        counts["value_wrong"] += int((~ok).sum())
        for i, rows in direct.items():
            if i in lanes:
                counts["oracle_wrong"] += int(not np.array_equal(got[lanes.index(i)], rows))
    return counts


def same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    """Two yielded chunks are the same bytes: dtype, shape and content."""
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def compare_checkpoints(preemptions: List[dict]) -> int:
    """``checkpoint_wrong``: over every preemption, the chunks yielded before
    it whose file was missing at it, those the resumed stream rewrote (a
    changed inode or modification time), and the resumed chunks whose bytes
    differ from those yielded before.

    A preemption is ``{"yielded": {chunk: limbs}, "at": {chunk: (inode,
    mtime_ns) or None}, "after": {chunk: (inode, mtime_ns) or None},
    "resumed": {chunk: limbs}}``: what the stream yielded before it, the
    files' identity at it and after the resumed stream's reads (``after``
    holds the chunks the resumed stream yielded), and what that stream
    yielded for the chunks it resumed."""
    wrong = 0
    for pre in preemptions:
        at: Dict[int, Optional[tuple]] = pre["at"]
        wrong += sum(1 for c in pre["yielded"] if at.get(c) is None)
        wrong += sum(1 for c, ident in pre["after"].items()
                     if at.get(c) is not None and ident != at[c])
        for c, limbs in pre["resumed"].items():
            before = pre["yielded"].get(c)
            wrong += int(before is None or not same_bytes(before, limbs))
    return wrong
