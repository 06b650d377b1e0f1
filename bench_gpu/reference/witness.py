"""Plain reference of one pairing witness lane, and its comparison.

``lane_trace(p, q)`` works out, with the frozen integer oracle beside this
file, every value that the witness of e(P, Q) holds (``pairing_circuit`` of
qope/plonky2-bn254-pairing, ``src/pairing.rs``: the Miller loop's targets
and the final exponentiation's), in the order the program hands them over:

  r_affine   the affine point before each of the 64 steps, after each of
             the 64 doublings, the end point and the end point + Q1 [130, 4]
  tg_lines   the tangent line at each step's point, slots 0, 3, 4 [64, 6]
  ch_lines   the chord line of each of the 25 addition steps, slots 2, 3, 5
  ep_lines   the two Frobenius chords of the epilogue [2, 6]
  q1, neg_q2 the twisted Frobenius points [4]
  f_steps    the Miller accumulator after each of the 64 steps [64, 12]
  miller_out the Miller value [12]
  easy_out   its easy part [12]
  exp_inputs the three x-power ladders' inputs [3, 12]
  exp_offsets their offsets, one [3, 12]
  exp_bits   their exponent's bits, BN_X LSB first [3, 64] (plain ints)
  exp_rows   their 64 rows each, MSB first [3, 64, 12]
  exp_outs   their outputs [3, 12]
  out        the pairing value [12]

Fq12 values are in the oracle's coefficient basis (c_i + c_{i+6} u) w^i;
Fq2 values are (c0, c1). It takes nothing from the program.

``lines="projective"`` gives the control: the same witness with every line
left scaled by a nonzero Fq2 factor, as lines computed without the
normalisation to affine form are (here 2y of the line's first point). The
pairing value is unchanged, since the final exponentiation maps every Fq2
factor to one; the lines, the Miller accumulator and the Miller value are
not what the circuit constrains.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import oracle as o
from .bn254 import BN_X, SIX_U_PLUS_2_NAF
from .limbs import montgomery_rows, values

N_STEPS = 64
DIGITS = [SIX_U_PLUS_2_NAF[63 - t] for t in range(N_STEPS)]
BITS_MSB = [(BN_X >> (63 - i)) & 1 for i in range(64)]
BITS_LSB = BITS_MSB[::-1]
#: values compared as they are, not as limb rows: the ladders' exponent bits
RAW = ("exp_bits",)
TG_SLOTS, CH_SLOTS = (0, 3, 4), (2, 3, 5)


def _fq2s(slots, keep) -> List[int]:
    return [c for s in keep for c in slots[s]]


def _pt(q) -> List[int]:
    return [q[0][0], q[0][1], q[1][0], q[1][1]]


def _scaled(slots, k):
    return [None if s is None else o.fq2_mul(s, k) for s in slots]


def lane_trace(p, q, lines: str = "affine") -> Dict[str, list]:
    """Every value of the witness of e(p, q) (affine ints), by name."""
    if lines not in ("affine", "projective"):
        raise ValueError(lines)
    nq = o.g2_neg(q)
    tops, dbls, r = [], [], q
    for t in range(N_STEPS):
        tops.append(r)
        r = o.g2_double(r)
        dbls.append(r)
        if DIGITS[t]:
            r = o.g2_add(r, q if DIGITS[t] > 0 else nq)
    end = r
    q1 = o.twisted_frobenius(q)
    nq2 = o.neg_twisted_frobenius(q1)
    st91 = o.g2_add(end, q1)

    def line(slots, first):
        if lines == "projective":
            return _scaled(slots, o.fq2_scale(first[1], 2))
        return slots

    tg = [line(o.sparse_line_function_equal(tops[t], p), tops[t]) for t in range(N_STEPS)]
    ch = {t: line(o.sparse_line_function_unequal(dbls[t], q if DIGITS[t] > 0 else nq, p),
                  dbls[t])
          for t in range(N_STEPS) if DIGITS[t]}
    ep = [line(o.sparse_line_function_unequal(end, q1, p), end),
          line(o.sparse_line_function_unequal(st91, nq2, p), st91)]

    f, f_steps = o.fq12_one(), []
    for t in range(N_STEPS):
        f = o.sparse_fp12_multiply(o.fq12_mul(f, f), tg[t])
        if DIGITS[t]:
            f = o.sparse_fp12_multiply(f, ch[t])
        f_steps.append(f)
    for slots in ep:
        f = o.sparse_fp12_multiply(f, slots)
    miller_out = f
    easy = o.easy_part(miller_out)
    x, exp_inputs, exp_rows, exp_outs = easy, [], [], []
    for _ in range(3):
        res, rows = o.fq12_one(), []
        for bit in BITS_MSB:
            res = o.fq12_mul(res, res)
            if bit:
                res = o.fq12_mul(res, x)
            rows.append(res)
        exp_inputs.append(x)
        exp_rows.append(rows)
        exp_outs.append(res)
        x = res
    return {
        "r_affine": [_pt(s) for s in tops + dbls + [end, st91]],
        "tg_lines": [_fq2s(s, TG_SLOTS) for s in tg],
        "ch_lines": [_fq2s(ch[t], CH_SLOTS) for t in sorted(ch)],
        "ep_lines": [_fq2s(s, CH_SLOTS) for s in ep],
        "q1": _pt(q1),
        "neg_q2": _pt(nq2),
        "f_steps": f_steps,
        "miller_out": miller_out,
        "easy_out": easy,
        "exp_inputs": exp_inputs,
        "exp_offsets": [o.fq12_one()] * 3,
        "exp_bits": [BITS_LSB] * 3,
        "exp_rows": exp_rows,
        "exp_outs": exp_outs,
        "out": o.hard_part(easy),
    }


def mismatches(got: Dict[str, np.ndarray], want: Dict[str, list]) -> Dict[str, int]:
    """Per name, how many field elements of the program's limb rows ``got``
    (``[..., 21]`` each, the shape of ``want`` plus the limb axis) differ
    from the reference's values ``want``; a name missing on either side or
    of another shape counts every element of the other side."""
    out = {}
    for name in sorted(set(got) | set(want)):
        ref = np.asarray(want.get(name, []), dtype=object)
        raw = name in RAW
        if name not in got or name not in want or \
                (got[name].shape if raw else got[name].shape[:-1]) != ref.shape:
            out[name] = max(ref.size, got[name].size if name in got else 0)
            continue
        have = np.asarray(got[name], dtype=object) if raw else values(got[name])
        out[name] = int((have != ref).sum())
    return out


def as_rows(trace: Dict[str, list]) -> Dict[str, np.ndarray]:
    """A trace of values -> the limb rows a program holding them exactly
    would hand over (Montgomery form, reduced); the control is handed over
    this way."""
    return {name: np.asarray(v, dtype=np.int64) if name in RAW else montgomery_rows(v)
            for name, v in trace.items()}
