"""Independent replay-checker for serialized pairing witnesses.

The `connect` analogue (final_exp_target.rs:142-147): validates every
recorded transition *locally* against the pure-int oracle without
re-running the pairing pipeline —

  miller:    trajectory steps (R_{t+1} = 2R_t [+ sgn Q]), line coeffs
             from the recorded affine states, the f-recurrence
             f_{t+1} = f_t^2 · tg_t [· ch_t], epilogue points/lines and
             the final two multiplies (miller_loop_native.rs:112-188);
  final exp: the easy part from miller_out (one conj/div/frob/mul), the
             per-bit ladder-row recurrence of the three x-power
             exponentiations (the rows a starky AIR would constrain,
             final_exp_target.rs:89-147), the exp splice, and the
             hard-part addition chain reconstructed from the recorded
             x-powers (final_exp_native.rs:130-169).

Cost is O(lanes · steps) host bignum work — this is a validation tool,
not a production path; restrict ``lanes`` for spot checks on big batches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..oracle import native as o


class WitnessError(AssertionError):
    """A recorded transition is inconsistent with the oracle."""


def _mk_val(meta):
    p = int(meta["p"])
    rinv = pow(int(meta["r_mont"]), -1, p)
    radix = meta["radix_bits"]

    def val(limbs: np.ndarray) -> int:
        """Montgomery limb row -> canonical int."""
        x = 0
        for v in reversed(np.asarray(limbs, dtype=np.int64)):
            x = (x << radix) + int(v)
        return x * rinv % p

    return val


def _check(ok: bool, where: str, report: Dict[str, int]):
    if not ok:
        raise WitnessError(f"witness inconsistency at {where}")
    report[where.split("[")[0]] = report.get(where.split("[")[0], 0) + 1


def verify_pairing_witness(
    meta: Dict, data: Dict[str, np.ndarray], lanes: Optional[Sequence[int]] = None
) -> Dict[str, int]:
    """Raise :class:`WitnessError` on any bad transition; returns the
    per-check pass-count report."""
    val = _mk_val(meta)
    K = meta["k"]
    naf = meta["naf"]
    add_steps = list(meta["add_steps"])
    n_steps = meta["n_steps"]
    B = data["f_steps"].shape[1]
    lanes = range(B) if lanes is None else lanes
    report: Dict[str, int] = {}

    def fq2(row: np.ndarray):
        return (val(row[0]), val(row[1]))

    def g2pt(x_entry, y_entry, idx):
        return (fq2(data[x_entry][idx]), fq2(data[y_entry][idx]))

    def fq12(row: np.ndarray) -> List[int]:
        return [val(row[i]) for i in range(12)]

    def line3(row: np.ndarray):
        return [fq2(row[j]) for j in range(3)]

    digits = [naf[63 - t] for t in range(n_steps)]

    for b in lanes:
        # ---------------- Miller side, per pair ----------------
        tg_all = [[None] * n_steps for _ in range(K)]
        ch_all = [dict() for _ in range(K)]
        ep_all = []
        for k in range(K):
            Q = g2pt("q_x", "q_y", (k, b))
            P1 = (val(data["p_x"][k, b]), val(data["p_y"][k, b]))
            nQ = o.g2_neg(Q)

            tops = [
                g2pt("r_affine_x", "r_affine_y", (t, k, b))
                for t in range(n_steps)
            ]
            dbls = [
                g2pt("r_affine_x", "r_affine_y", (n_steps + t, k, b))
                for t in range(n_steps)
            ]
            end = g2pt("r_affine_x", "r_affine_y", (2 * n_steps, k, b))
            st91 = g2pt("r_affine_x", "r_affine_y", (2 * n_steps + 1, k, b))

            _check(tops[0] == Q, "traj_init", report)
            for t in range(n_steps):
                _check(dbls[t] == o.g2_double(tops[t]), f"traj_double[{t}]", report)
                nxt = dbls[t]
                if digits[t] != 0:
                    nxt = o.g2_add(nxt, Q if digits[t] > 0 else nQ)
                expect = tops[t + 1] if t + 1 < n_steps else end
                _check(nxt == expect, f"traj_step[{t}]", report)

            q1 = o.twisted_frobenius(Q)
            nq2 = o.neg_twisted_frobenius(q1)
            _check(g2pt("q1_x", "q1_y", (k, b)) == q1, "q1", report)
            _check(g2pt("nq2_x", "nq2_y", (k, b)) == nq2, "nq2", report)
            _check(st91 == o.g2_add(end, q1), "st91", report)

            # lines from recorded states
            for t in range(n_steps):
                got = line3(data["tg_lines"][t, k, b])
                slots = o.sparse_line_function_equal(tops[t], P1)
                _check(
                    got == [slots[0], slots[3], slots[4]],
                    f"tg_line[{t}]",
                    report,
                )
                tg_all[k][t] = slots
            for j, t in enumerate(add_steps):
                got = line3(data["ch_lines"][j, k, b])
                partner = Q if digits[t] > 0 else nQ
                slots = o.sparse_line_function_unequal(dbls[t], partner, P1)
                _check(
                    got == [slots[2], slots[3], slots[5]],
                    f"ch_line[{t}]",
                    report,
                )
                ch_all[k][t] = slots
            for j, (pt, partner) in enumerate(((end, q1), (st91, nq2))):
                got = line3(data["ep_lines"][j, k, b])
                slots = o.sparse_line_function_unequal(pt, partner, P1)
                _check(got == [slots[2], slots[3], slots[5]], f"ep_line[{j}]", report)
                ep_all.append(slots)

        # f-recurrence (shared squaring across pairs,
        # miller_loop_native.rs:237-264)
        f = o.fq12_one()
        for t in range(n_steps):
            f = o.fq12_mul(f, f)
            for k in range(K):
                f = o.sparse_fp12_multiply(f, tg_all[k][t])
            if digits[t] != 0:
                for k in range(K):
                    f = o.sparse_fp12_multiply(f, ch_all[k][t])
            _check(fq12(data["f_steps"][t, b]) == f, f"f_step[{t}]", report)
        for slots in ep_all:
            f = o.sparse_fp12_multiply(f, slots)
        m_out = fq12(data["miller_out"][b])
        _check(m_out == f, "miller_out", report)

        # ---------------- final exponentiation ----------------
        easy = fq12(data["easy_out"][b])
        _check(easy == o.easy_part(m_out), "easy_part", report)

        bits = [int(v) for v in data["exp_bits"]]  # LSB first
        _check(
            sum(bb << i for i, bb in enumerate(bits)) == int(meta["bn_x"]),
            "exp_bits",
            report,
        )
        xs = [easy]
        for j in range(3):
            x = xs[-1]
            res = o.fq12_one()
            for i, bit in enumerate(reversed(bits)):  # MSB first
                res = o.fq12_mul(res, res)
                if bit:
                    res = o.fq12_mul(res, x)
                _check(
                    fq12(data["exp_rows"][j, i, b]) == res,
                    f"exp_row[{j},{i}]",
                    report,
                )
            out_j = fq12(data["exp_outs"][j, b])
            _check(out_j == res, f"exp_splice[{j}]", report)
            xs.append(out_j)

        # hard-part chain from the recorded x-powers
        # (final_exp_native.rs:130-169)
        m, mx, mx2, mx3 = easy, xs[1], xs[2], xs[3]
        mul, conj, frob, sq = (
            o.fq12_mul,
            o.fq12_conj,
            o.frobenius_map,
            lambda a: o.fq12_mul(a, a),
        )
        y0 = mul(frob(m, 1), mul(frob(m, 2), frob(m, 3)))
        y1 = conj(m)
        y2 = frob(mx2, 2)
        y3 = conj(frob(mx, 1))
        y4 = conj(mul(mx, frob(mx2, 1)))
        y5 = conj(mx2)
        y6 = conj(mul(mx3, frob(mx3, 1)))
        t0 = mul(mul(sq(y6), y4), y5)
        t1 = mul(mul(y3, y5), t0)
        t0 = mul(y2, t0)
        t1 = mul(sq(t1), t0)
        t1v = sq(t1)
        t0 = mul(sq(mul(t1v, y1)), mul(t1v, y0))
        _check(fq12(data["final_out"][b]) == t0, "final_out", report)

    return report
