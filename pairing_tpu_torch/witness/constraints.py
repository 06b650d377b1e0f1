"""Limb-level AIR constraint evaluator for serialized pairing witnesses.

:mod:`.verify` replays the recorded transitions at the
VALUE level (host bigints).  This module is the constraint-system consumer
(VERDICT r3 item 3): it checks the *limb-level polynomial identities* a
starky-style AIR would enforce over the npz columns — the same semantic
payload as the reference's in-circuit pairing (`pairing_circuit`,
src/pairing.rs:24-38; the per-row AIR of
`fq12_exp_u64_circuit`, src/final_exp_target.rs:89-147;
`Fq12Target::connect`, final_exp_target.rs:142-147) — proving that the
schema documented in :mod:`.serialize` is actually
constrainable.

How an identity is checked
--------------------------
Witness columns are 21x13-bit limb vectors in redundant Montgomery form
(value v stands for v*R^-1 mod p, R = 2^273).  Every schema rule reduces
to identities of the shape

    sum_k s_k * (a_k * b_k)  +  R * sum_j s_j' * c_j   ==  0   (mod p)

with small integer scales s (the R factor keeps Montgomery degrees equal:
a product of two Montgomery operands carries one excess R versus a plain
operand).  The evaluator forms the SIGNED WIDE LIMB VECTOR of the left
side by convolution of the committed limb columns — never collapsing to a
bigint — and then verifies divisibility by p with the base-2^13 Hensel
exact-division recurrence an AIR realises as a quotient column with range
checks (the non-native `FqTarget` mul gadget family, SURVEY.md §2.3 C9):

    q_k = (t_k + carry) * p0^-1  mod 2^13 ;  subtract q_k * p at offset k;
    carry = exact shift;  all tail positions and the final carry must be 0.

A single perturbed limb anywhere in a committed column changes the wide
vector by +-2^(13*i) * (partner operand), which is not a multiple of p,
so the division leaves a nonzero tail and the row is rejected.

Derivation-free (schema v2): every auxiliary wire — chord/tangent slopes,
x^2 helpers, the easy-part Fq12 inverse, and ALL intermediate products of
the multi-factor mul chains — is **committed in the npz** by the witness
generator (:mod:`.aux`), exactly like the reference's
witness generators fill every plonky2 wire before constraints check them
(pairing.rs:77-78).  This evaluator therefore does *zero* value
derivation: it is pure vectorized numpy int64 convolution + Hensel
division over committed columns, fast enough to run full-batch.

Cost: O(lanes * steps) vectorized numpy; use ``lanes`` to spot check
huge batches, or run full-batch (throughput recorded in PERF.md).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..fields.fp import NLIMBS, P_LIMBS, RADIX, RADIX_BITS, int_to_limbs
from ..utils.bn254 import P, TWIST_C2, TWIST_C3, frob_coeff_pow

L = NLIMBS
MASK = RADIX - 1
#: Wide accumulator positions: conv gives 2L-1; quotient digits + p tail
#: must fit (Q_DIGITS + L <= ACC_W).
ACC_W = 72
#: Quotient digit positions processed by the exact-division recurrence.
Q_DIGITS = ACC_W - L  # 51
#: Additive offset making every accumulator nonnegative: a multiple of p
#: strictly larger than any identity's negative excursion (see bound
#: accounting in _identity).  2^312 * p ~ 2^566.
_OFFSET_INT = (1 << 312) * P
_P0_INV = pow(int(P_LIMBS[0]), -1, RADIX)
_P_D = np.asarray(P_LIMBS, dtype=np.int64)

#: | Sum s_k a_k b_k | value bound per identity, asserted in _identity:
#: operand values < 2^275 (limbs |.| <= 2^14), so each product term is
#: < 2^550 * |scale|; the offset must dominate the total.
_TERM_BOUND = 1 << 550


def _offset_limbs() -> np.ndarray:
    v = _OFFSET_INT
    out = np.zeros((ACC_W,), dtype=np.int64)
    for i in range(ACC_W):
        out[i] = v & MASK
        v >>= RADIX_BITS
    assert v == 0
    return out


_OFFSET_D = _offset_limbs()


class ConstraintError(AssertionError):
    """A committed column violates a limb-level AIR identity."""


# ---------------------------------------------------------------------------
# Core limb-level machinery
# ---------------------------------------------------------------------------


def _check_zero_mod_p(acc: np.ndarray, where: str, report: Dict[str, int]):
    """Verify each row of ``acc`` [N, ACC_W] (signed int64 limbs) encodes a
    multiple of p, via the Hensel exact-division-by-p recurrence."""
    t = acc + _OFFSET_D[None, :]
    n = t.shape[0]
    carry = np.zeros((n,), dtype=np.int64)
    ok = np.ones((n,), dtype=bool)
    for k in range(ACC_W):
        v = t[:, k] + carry
        if k < Q_DIGITS:
            qk = ((v & MASK) * _P0_INV) & MASK
            v = v - qk * _P_D[0]
            # subtract qk * p at offset k (columns k+1 .. k+L-1)
            t[:, k + 1 : k + L] -= qk[:, None] * _P_D[None, 1:]
        else:
            ok &= (v & MASK) == 0
        carry = v >> RADIX_BITS
    ok &= carry == 0
    if not ok.all():
        bad = int(np.nonzero(~ok)[0][0])
        raise ConstraintError(
            f"limb-level constraint violated at {where} (row {bad})"
        )
    key = where.split("[")[0]
    report[key] = report.get(key, 0) + n


def _identity(
    where: str,
    report: Dict[str, int],
    products: Sequence[Tuple[np.ndarray, np.ndarray, int]],
    linears: Sequence[Tuple[np.ndarray, int, int]] = (),
):
    """Check sum_k s_k*conv(a_k,b_k) + sum_j s_j*2^(13*shift_j)*v_j == 0 mod p.

    ``products``: (a [N|1, L], b [N|1, L], scale) limb rows, |limb| <= 2^14.
    ``linears``:  (v [N|1, L], scale, shift) — shift=L multiplies by R.
    """
    n = 1
    for a, b, _ in products:
        n = max(n, a.shape[0], b.shape[0])
    for v, _, _ in linears:
        n = max(n, v.shape[0])
    acc = np.zeros((n, ACC_W), dtype=np.int64)
    val_bound = 0
    for a, b, s in products:
        a64 = np.broadcast_to(a, (n, L)).astype(np.int64)
        b64 = np.broadcast_to(b, (n, L)).astype(np.int64)
        for i in range(L):
            acc[:, i : i + L] += (a64[:, i : i + 1] * b64) * s
        val_bound += abs(s) * _TERM_BOUND
    for v, s, shift in linears:
        v64 = np.broadcast_to(v, (n, L)).astype(np.int64)
        acc[:, shift : shift + L] += v64 * s
        val_bound += abs(s) * (1 << (275 + RADIX_BITS * shift))
    assert val_bound < _OFFSET_INT // 2, f"identity {where} exceeds offset budget"
    _check_zero_mod_p(acc, where, report)


# ---------------------------------------------------------------------------
# Column plumbing: committed npz limb columns + public constants
# ---------------------------------------------------------------------------

_R = 1 << (RADIX_BITS * L)


def _const_mont_row(v: int) -> np.ndarray:
    """Canonical Montgomery limb row of a public CONSTANT (not a witness
    value — AIR constants are baked into the constraint polynomials)."""
    return int_to_limbs((v % P) * _R % P).astype(np.int64)[None, :]


_ONE_M = _const_mont_row(1)
_ZERO = np.zeros((1, L), dtype=np.int64)


def _const_fq2(c: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    return _const_mont_row(c[0]), _const_mont_row(c[1])


Fq2Col = Tuple[np.ndarray, np.ndarray]  # (c0 [N, L], c1 [N, L])


def _fq2_neg(a: Fq2Col) -> Fq2Col:
    return (-a[0], -a[1])


def _fq2_conj(a: Fq2Col) -> Fq2Col:
    return (a[0], -a[1])


def _fq2_sub(a: Fq2Col, b: Fq2Col) -> Fq2Col:
    return (a[0] - b[0], a[1] - b[1])


def _fq2_mul_check(
    where: str,
    report: Dict[str, int],
    a: Fq2Col,
    b: Fq2Col,
    extra_products0=(),
    extra_products1=(),
    out: Optional[Fq2Col] = None,
    out_shift: int = L,
    scale: int = 1,
):
    """scale*(a*b) [+ extra] == out * R^(out_shift==L) as two Fq identities.

    (a0+a1u)(b0+b1u) = (a0b0 - a1b1) + (a0b1 + a1b0)u.
    """
    p0 = [(a[0], b[0], scale), (a[1], b[1], -scale)] + list(extra_products0)
    p1 = [(a[0], b[1], scale), (a[1], b[0], scale)] + list(extra_products1)
    lin0 = [(out[0], -1, out_shift)] if out is not None else []
    lin1 = [(out[1], -1, out_shift)] if out is not None else []
    _identity(where + ".c0", report, p0, lin0)
    _identity(where + ".c1", report, p1, lin1)


def _fq2_equal_check(where, report, a: Fq2Col, b: Fq2Col):
    """a == b as values mod p (degree-1 identity, no R factor)."""
    _identity(where + ".c0", report, [], [(a[0], 1, 0), (b[0], -1, 0)])
    _identity(where + ".c1", report, [], [(a[1], 1, 0), (b[1], -1, 0)])


# ---------------------------------------------------------------------------
# Dense Fq12 product constraints (batched)
# ---------------------------------------------------------------------------


class MulBatch:
    """Collects Fq12 product constraints c == a*b (coefficient basis) and
    checks all of them with 12 vectorized limb identities over the stack.

    The product in MyFq12 coefficient basis (SURVEY.md §2.2;
    miller_loop_native.rs:46-96): with Fq2 slots a_j = (a[j], a[j+6]),
        c_i = sum_{j+k=i} a_j*b_k + xi * sum_{j+k=i+6} a_j*b_k,  xi = 9+u.
    """

    def __init__(self):
        self.a: List[np.ndarray] = []  # [N, 12, L] blocks
        self.b: List[np.ndarray] = []
        self.c: List[np.ndarray] = []

    def add(self, a: np.ndarray, b: np.ndarray, c: np.ndarray):
        """a/b/c: [N, 12, L] int64 (signed limbs allowed for conj folds)."""
        n = max(a.shape[0], b.shape[0], c.shape[0])
        self.a.append(np.broadcast_to(a, (n, 12, L)))
        self.b.append(np.broadcast_to(b, (n, 12, L)))
        self.c.append(np.broadcast_to(c, (n, 12, L)))

    def check(self, where: str, report: Dict[str, int]):
        if not self.a:
            return
        A = np.concatenate(self.a).astype(np.int64)
        B = np.concatenate(self.b).astype(np.int64)
        C = np.concatenate(self.c).astype(np.int64)

        def s(arr, j, comp):  # Fq2 slot j, component comp of stack arr
            return arr[:, j + 6 * comp, :]

        for i in range(6):
            # direct terms j+k == i ; xi-folded terms j+k == i+6
            prod0, prod1 = [], []
            for j in range(6):
                k = i - j
                if 0 <= k < 6:
                    prod0 += [(s(A, j, 0), s(B, k, 0), 1), (s(A, j, 1), s(B, k, 1), -1)]
                    prod1 += [(s(A, j, 0), s(B, k, 1), 1), (s(A, j, 1), s(B, k, 0), 1)]
                k = i + 6 - j
                if 0 <= k < 6:
                    # xi*(t0 + t1 u) = (9 t0 - t1) + (t0 + 9 t1) u
                    t0 = [(s(A, j, 0), s(B, k, 0), 1), (s(A, j, 1), s(B, k, 1), -1)]
                    t1 = [(s(A, j, 0), s(B, k, 1), 1), (s(A, j, 1), s(B, k, 0), 1)]
                    prod0 += [(a, b, 9 * sc) for a, b, sc in t0]
                    prod0 += [(a, b, -sc) for a, b, sc in t1]
                    prod1 += [(a, b, sc) for a, b, sc in t0]
                    prod1 += [(a, b, 9 * sc) for a, b, sc in t1]
            _identity(f"{where}.s{i}.c0", report, prod0, [(s(C, i, 0), -1, L)])
            _identity(f"{where}.s{i}.c1", report, prod1, [(s(C, i, 1), -1, L)])


def _fq12_conj_cols(a: np.ndarray) -> np.ndarray:
    """conjugate_fp12 as a sign pattern on coefficient columns
    (final_exp_native.rs:171-181: negate odd-index coeffs)."""
    signs = np.asarray([1 if i % 2 == 0 else -1 for i in range(12)])
    return a * signs[None, :, None]


def _sparse12(slots: Dict[int, Fq2Col], n: int) -> np.ndarray:
    """Materialize sparse Fq2 slots as a dense [N, 12, L] operand."""
    out = np.zeros((n, 12, L), dtype=np.int64)
    for j, (c0, c1) in slots.items():
        out[:, j, :] = np.broadcast_to(c0, (n, L))
        out[:, j + 6, :] = np.broadcast_to(c1, (n, L))
    return out


def _frob_check(
    where: str,
    report: Dict[str, int],
    m: np.ndarray,
    out: np.ndarray,
    power: int,
):
    """out == frobenius_map(m, power) (final_exp_native.rs:17-54): per-slot
    constant Fq2 multiply (with conjugation for odd powers) — 12 identities
    over the stack."""
    pw = power % 12
    for i in range(6):
        cst = _const_fq2(frob_coeff_pow(pw, i))
        a: Fq2Col = (m[:, i, :], m[:, i + 6, :])
        if pw % 2 != 0:
            a = _fq2_conj(a)
        _fq2_mul_check(
            f"{where}.s{i}", report, a, cst,
            out=(out[:, i, :], out[:, i + 6, :]),
        )


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


def check_pairing_constraints(
    meta: Dict,
    data: Dict[str, np.ndarray],
    lanes: Optional[Sequence[int]] = None,
) -> Dict[str, int]:
    """Evaluate the full limb-level constraint system over a loaded witness
    (schema: witness/serialize.py docstring sections 1-6, aux columns per
    witness/aux.py).  Pure numpy over committed columns — no value
    derivation.  Raises :class:`ConstraintError` on any violated identity;
    returns the per-identity-group pass-count report."""
    K = meta["k"]
    naf = meta["naf"]
    add_steps = list(meta["add_steps"])
    n_steps = meta["n_steps"]
    B = data["f_steps"].shape[1]
    lanes = list(range(B)) if lanes is None else list(lanes)
    report: Dict[str, int] = {}
    digits = [naf[63 - t] for t in range(n_steps)]

    # -- range checks: every committed limb must be a settled 13-bit digit
    # (quasi-carry settles to [0, 2^13] inclusive, fields/fp.py) ----------
    for name, arr in data.items():
        if name == "exp_bits":
            if not np.isin(arr, (0, 1)).all():
                raise ConstraintError("exp_bits not boolean")
            report["range_bits"] = report.get("range_bits", 0) + arr.size
            continue
        if int(arr.min()) < 0 or int(arr.max()) > RADIX:
            raise ConstraintError(f"limb range check failed on {name}")
        report["range"] = report.get("range", 0) + arr.size

    bits_lsb = [int(v) for v in data["exp_bits"]]
    if sum(bb << i for i, bb in enumerate(bits_lsb)) != int(meta["bn_x"]):
        raise ConstraintError("exp_bits recomposition != BN_X public input")
    report["exp_bits_recompose"] = 1

    def fq2_cols(arr: np.ndarray) -> Fq2Col:
        """[N, 2, L] committed -> Fq2Col."""
        a = arr.astype(np.int64)
        return (a[:, 0, :], a[:, 1, :])

    sel = np.asarray(lanes, dtype=np.int64)
    n_lane = len(lanes)

    # ======================= 1. trajectory ==============================
    # stack doubles over (t, k, lane); committed states:
    aff_x = data["r_affine_x"][:, :, sel]  # [130, K, n, 2, L]
    aff_y = data["r_affine_y"][:, :, sel]
    qx = fq2_cols(data["q_x"][:, sel].reshape(-1, 2, L))
    qy = fq2_cols(data["q_y"][:, sel].reshape(-1, 2, L))

    tops_x = fq2_cols(aff_x[:n_steps].reshape(-1, 2, L))
    tops_y = fq2_cols(aff_y[:n_steps].reshape(-1, 2, L))
    dbls_x = fq2_cols(aff_x[n_steps : 2 * n_steps].reshape(-1, 2, L))
    dbls_y = fq2_cols(aff_y[n_steps : 2 * n_steps].reshape(-1, 2, L))
    end_x = fq2_cols(aff_x[2 * n_steps].reshape(-1, 2, L))
    end_y = fq2_cols(aff_y[2 * n_steps].reshape(-1, 2, L))
    s91_x = fq2_cols(aff_x[2 * n_steps + 1].reshape(-1, 2, L))
    s91_y = fq2_cols(aff_y[2 * n_steps + 1].reshape(-1, 2, L))

    # boundary: T_0 == Q
    t0x = fq2_cols(aff_x[0].reshape(-1, 2, L))
    t0y = fq2_cols(aff_y[0].reshape(-1, 2, L))
    _fq2_equal_check("traj_init.x", report, t0x, qx)
    _fq2_equal_check("traj_init.y", report, t0y, qy)

    def mixed_add_checks(
        where: str,
        ax: Fq2Col, ay: Fq2Col,      # committed input point A
        bx: Fq2Col, by: Fq2Col,      # committed partner B
        ox: Fq2Col, oy: Fq2Col,      # committed output A + B
        mu_c: Fq2Col,                # committed aux slope column
    ):
        """Chord-slope addition identities over the committed slope mu:
          (a) mu*(B.x - A.x) == B.y - A.y
          (b) O.x == mu^2 - A.x - B.x
          (c) O.y == mu*(A.x - O.x) - A.y
        (the AIR's aux column, committed by witness/aux.py)."""
        _fq2_mul_check(
            where + ".slope", report, mu_c, _fq2_sub(bx, ax),
            out=_fq2_sub(by, ay), out_shift=L,
        )
        _fq2_mul_check(
            where + ".x", report, mu_c, mu_c,
            out=(ox[0] + ax[0] + bx[0], ox[1] + ax[1] + bx[1]), out_shift=L,
        )
        _fq2_mul_check(
            where + ".y", report, mu_c, _fq2_sub(ax, ox),
            out=(oy[0] + ay[0], oy[1] + ay[1]), out_shift=L,
        )

    # doubling D_t = 2*T_t with committed aux slope lambda:
    #   (a) lam * 2*T.y == 3*T.x^2
    #   (b) D.x == lam^2 - 2*T.x
    #   (c) D.y == lam*(T.x - D.x) - T.y
    lam_c = fq2_cols(data["tg_lambda"][:, :, sel].reshape(-1, 2, L))
    _fq2_mul_check(
        "traj_double.slope", report, lam_c, (2 * tops_y[0], 2 * tops_y[1]),
        extra_products0=[(tops_x[0], tops_x[0], -3), (tops_x[1], tops_x[1], 3)],
        extra_products1=[(tops_x[0], tops_x[1], -6)],
    )
    _fq2_mul_check(
        "traj_double.x", report, lam_c, lam_c,
        out=(dbls_x[0] + 2 * tops_x[0], dbls_x[1] + 2 * tops_x[1]),
    )
    _fq2_mul_check(
        "traj_double.y", report, lam_c, _fq2_sub(tops_x, dbls_x),
        out=(dbls_y[0] + tops_y[0], dbls_y[1] + tops_y[1]),
    )

    # additions at nonzero NAF digits: T_{t+1} = D_t + sgn*Q; zero digits:
    # T_{t+1} == D_t (pure copy identity).
    def pick(cols: Fq2Col, steps: List[int]) -> Fq2Col:
        c0 = cols[0].reshape(n_steps, K * n_lane, L)
        c1 = cols[1].reshape(n_steps, K * n_lane, L)
        return (
            c0[steps].reshape(-1, L),
            c1[steps].reshape(-1, L),
        )

    def next_top(steps: List[int]) -> Tuple[Fq2Col, Fq2Col]:
        """Committed successor state of step t (top t+1, or the end row)."""
        xs, ys = [], []
        for t in steps:
            if t + 1 < n_steps:
                xs.append(aff_x[t + 1].reshape(-1, 2, L))
                ys.append(aff_y[t + 1].reshape(-1, 2, L))
            else:
                xs.append(aff_x[2 * n_steps].reshape(-1, 2, L))
                ys.append(aff_y[2 * n_steps].reshape(-1, 2, L))
        return (
            fq2_cols(np.concatenate(xs)),
            fq2_cols(np.concatenate(ys)),
        )

    ch_mu = data["ch_mu"][:, :, sel]  # [n_adds, K, n, 2, L]
    zero_steps = [t for t in range(n_steps) if digits[t] == 0]
    for sgn in (1, -1):
        jts = [(j, t) for j, t in enumerate(add_steps) if digits[t] == sgn]
        if not jts:
            continue
        js = [j for j, _ in jts]
        steps = [t for _, t in jts]
        dx, dy = pick(dbls_x, steps), pick(dbls_y, steps)
        ox, oy = next_top(steps)
        reps = len(steps)
        bx = (np.tile(qx[0], (reps, 1)), np.tile(qx[1], (reps, 1)))
        by_sign = qy if sgn > 0 else _fq2_neg(qy)
        by = (np.tile(by_sign[0], (reps, 1)), np.tile(by_sign[1], (reps, 1)))
        mu_c = fq2_cols(ch_mu[js].reshape(-1, 2, L))
        mixed_add_checks(f"traj_add.{sgn}", dx, dy, bx, by, ox, oy, mu_c)
    if zero_steps:
        dx, dy = pick(dbls_x, zero_steps), pick(dbls_y, zero_steps)
        ox, oy = next_top(zero_steps)
        _fq2_equal_check("traj_copy.x", report, dx, ox)
        _fq2_equal_check("traj_copy.y", report, dy, oy)

    # epilogue points: Q1 = twisted_frobenius(Q) = (C2*conj(Qx), C3*conj(Qy));
    # -Q2 = (C2*conj(Q1x), C3*neg_conj(Q1y)) (miller_loop_native.rs:298-312);
    # S = E + Q1 (mixed add over the committed ep_mu slope).
    q1x = fq2_cols(data["q1_x"][:, sel].reshape(-1, 2, L))
    q1y = fq2_cols(data["q1_y"][:, sel].reshape(-1, 2, L))
    nq2x = fq2_cols(data["nq2_x"][:, sel].reshape(-1, 2, L))
    nq2y = fq2_cols(data["nq2_y"][:, sel].reshape(-1, 2, L))
    C2 = _const_fq2(TWIST_C2)
    C3 = _const_fq2(TWIST_C3)
    _fq2_mul_check("q1.x", report, _fq2_conj(qx), C2, out=q1x)
    _fq2_mul_check("q1.y", report, _fq2_conj(qy), C3, out=q1y)
    _fq2_mul_check("nq2.x", report, _fq2_conj(q1x), C2, out=nq2x)
    # neg_conjugate: -(conj(y)) = (-y0, y1)
    _fq2_mul_check("nq2.y", report, (-q1y[0], q1y[1]), C3, out=nq2y)
    ep_mu_c = fq2_cols(data["ep_mu"][:, sel].reshape(-1, 2, L))
    mixed_add_checks(
        "st91", end_x, end_y, q1x, q1y, s91_x, s91_y, ep_mu_c
    )

    # ======================= 2. line coefficients ========================
    px = data["p_x"][:, sel].reshape(-1, L).astype(np.int64)  # [K*n, L]
    py = data["p_y"][:, sel].reshape(-1, L).astype(np.int64)
    px_t = np.tile(px, (n_steps, 1))
    py_t = np.tile(py, (n_steps, 1))

    # committed x^2 helper wire, bound by its own identity
    sqx = fq2_cols(data["tg_sqx"][:, :, sel].reshape(-1, 2, L))
    _fq2_mul_check("tg_sqx", report, tops_x, tops_x, out=sqx)

    tg = data["tg_lines"][:, :, sel].reshape(n_steps * K * n_lane, 3, 2, L)
    tg_c0 = fq2_cols(tg[:, 0])
    tg_c3 = fq2_cols(tg[:, 1])
    tg_c4 = fq2_cols(tg[:, 2])
    # c0 = xi*(3*sqx*x - 2*y^2): with t = 3*sqx*x - 2*y*y (Fq2 products),
    # xi*t = (9 t0 - t1) + (t0 + 9 t1) u  (XI_0 = 9, miller_loop_target.rs:15)
    t0_prods = lambda s: [
        (sqx[0], tops_x[0], 3 * s), (sqx[1], tops_x[1], -3 * s),
        (tops_y[0], tops_y[0], -2 * s), (tops_y[1], tops_y[1], 2 * s),
    ]
    t1_prods = lambda s: [
        (sqx[0], tops_x[1], 3 * s), (sqx[1], tops_x[0], 3 * s),
        (tops_y[0], tops_y[1], -4 * s),
    ]
    _identity(
        "tg_line.c0.c0", report,
        t0_prods(9) + t1_prods(-1), [(tg_c0[0], -1, L)],
    )
    _identity(
        "tg_line.c0.c1", report,
        t0_prods(1) + t1_prods(9), [(tg_c0[1], -1, L)],
    )
    # c3 = 2*y*py (Fq2 x Fq scalar)
    _identity("tg_line.c3.c0", report, [(tops_y[0], py_t, 2)], [(tg_c3[0], -1, L)])
    _identity("tg_line.c3.c1", report, [(tops_y[1], py_t, 2)], [(tg_c3[1], -1, L)])
    # c4 = -3*sqx*px
    _identity("tg_line.c4.c0", report, [(sqx[0], px_t, -3)], [(tg_c4[0], -1, L)])
    _identity("tg_line.c4.c1", report, [(sqx[1], px_t, -3)], [(tg_c4[1], -1, L)])

    # chords (in-loop at add_steps, plus the two epilogue lines):
    # c2 = (B.x - A.x)*py, c3 = (A.y - B.y)*px, c5 = A.x*B.y - B.x*A.y
    def chord_checks(where, A_x, A_y, B_x, B_y, rows, px_r, py_r):
        r_c2 = fq2_cols(rows[:, 0])
        r_c3 = fq2_cols(rows[:, 1])
        r_c5 = fq2_cols(rows[:, 2])
        dxc = _fq2_sub(B_x, A_x)
        dyc = _fq2_sub(A_y, B_y)
        _identity(where + ".c2.c0", report, [(dxc[0], py_r, 1)], [(r_c2[0], -1, L)])
        _identity(where + ".c2.c1", report, [(dxc[1], py_r, 1)], [(r_c2[1], -1, L)])
        _identity(where + ".c3.c0", report, [(dyc[0], px_r, 1)], [(r_c3[0], -1, L)])
        _identity(where + ".c3.c1", report, [(dyc[1], px_r, 1)], [(r_c3[1], -1, L)])
        _fq2_mul_check(
            where + ".c5", report, A_x, B_y,
            extra_products0=[(B_x[0], A_y[0], -1), (B_x[1], A_y[1], 1)],
            extra_products1=[(B_x[0], A_y[1], -1), (B_x[1], A_y[0], -1)],
            out=r_c5,
        )

    for sgn in (1, -1):
        jts = [(j, t) for j, t in enumerate(add_steps) if digits[t] == sgn]
        if not jts:
            continue
        js = [j for j, _ in jts]
        ts = [t for _, t in jts]
        rows = data["ch_lines"][:, :, sel][js].reshape(-1, 3, 2, L)
        A_x, A_y = pick(dbls_x, ts), pick(dbls_y, ts)
        reps = len(ts)
        B_x = (np.tile(qx[0], (reps, 1)), np.tile(qx[1], (reps, 1)))
        B_ys = qy if sgn > 0 else _fq2_neg(qy)
        B_y = (np.tile(B_ys[0], (reps, 1)), np.tile(B_ys[1], (reps, 1)))
        chord_checks(
            f"ch_line.{sgn}", A_x, A_y, B_x, B_y, rows,
            np.tile(px, (reps, 1)), np.tile(py, (reps, 1)),
        )
    ep = data["ep_lines"][:, :, sel]  # [2, K, n, 3, 2, L]
    chord_checks(
        "ep_line.0", end_x, end_y, q1x, q1y, ep[0].reshape(-1, 3, 2, L), px, py
    )
    chord_checks(
        "ep_line.1", s91_x, s91_y, nq2x, nq2y, ep[1].reshape(-1, 3, 2, L), px, py
    )

    # ============ 3-6. Fq12 product constraints (one big batch) ==========
    # Every operand below is a COMMITTED column; intermediates of the
    # multi-factor chains are the schema-v2 aux entries (witness/aux.py).
    mb = MulBatch()
    f_steps = data["f_steps"][:, sel].astype(np.int64)  # [64, n, 12, L]
    m_out = data["miller_out"][sel].astype(np.int64)  # [n, 12, L]
    easy_out = data["easy_out"][sel].astype(np.int64)
    exp_rows = data["exp_rows"][:, :, sel].astype(np.int64)  # [3, 64, n, 12, L]
    exp_outs = data["exp_outs"][:, sel].astype(np.int64)  # [3, n, 12, L]
    final_out = data["final_out"][sel].astype(np.int64)

    one12 = _sparse12({0: (_ONE_M, _ZERO)}, 1)
    one_b = np.broadcast_to(one12, (n_lane, 12, L))

    tg_kn = data["tg_lines"][:, :, sel].astype(np.int64)  # [64, K, n, 3, 2, L]
    ch_kn = data["ch_lines"][:, :, sel].astype(np.int64)
    ep_kn = data["ep_lines"][:, :, sel].astype(np.int64)

    def line12_034(rows: np.ndarray) -> np.ndarray:
        n = rows.shape[0]
        return _sparse12(
            {
                0: (rows[:, 0, 0], rows[:, 0, 1]),
                3: (rows[:, 1, 0], rows[:, 1, 1]),
                4: (rows[:, 2, 0], rows[:, 2, 1]),
            },
            n,
        )

    def line12_235(rows: np.ndarray) -> np.ndarray:
        n = rows.shape[0]
        return _sparse12(
            {
                2: (rows[:, 0, 0], rows[:, 0, 1]),
                3: (rows[:, 1, 0], rows[:, 1, 1]),
                5: (rows[:, 2, 0], rows[:, 2, 1]),
            },
            n,
        )

    # --- 3. Miller f-recurrence over committed chain columns:
    #   f_sq[t] == f_{t-1}^2 (one vectorized stack; f_{-1} = 1), then
    #   factor-by-factor products through the committed f_mid wires with
    #   the last factor landing on f_steps[t].
    f_sq = data["f_sq"][:, sel].astype(np.int64)  # [64, n, 12, L]
    f_mid = data["f_mid"][:, sel].astype(np.int64)  # [n_mid, n, 12, L]
    prev_stack = np.concatenate([one_b[None], f_steps[:-1]])  # [64, n, ...]
    mb.add(
        prev_stack.reshape(-1, 12, L),
        prev_stack.reshape(-1, 12, L),
        f_sq.reshape(-1, 12, L),
    )

    mid_index: Dict[Tuple[int, int], int] = {}
    ctr = 0
    for t in range(n_steps):
        n_factors = K * (2 if digits[t] != 0 else 1)
        for fi in range(n_factors - 1):
            mid_index[(t, fi)] = ctr
            ctr += 1
    if ctr != data["f_mid"].shape[0]:
        raise ConstraintError(
            f"f_mid has {data['f_mid'].shape[0]} rows, schema requires {ctr}"
        )

    def chain_target(t: int, fi: int) -> np.ndarray:
        n_factors = K * (2 if digits[t] != 0 else 1)
        if fi == n_factors - 1:
            return f_steps[t]
        return f_mid[mid_index[(t, fi)]]

    cur = f_sq
    for k in range(K):
        fac = line12_034(tg_kn[:, k].reshape(-1, 3, 2, L)).reshape(
            n_steps, n_lane, 12, L
        )
        nxt = np.stack([chain_target(t, k) for t in range(n_steps)])
        mb.add(
            cur.reshape(-1, 12, L),
            fac.reshape(-1, 12, L),
            nxt.reshape(-1, 12, L),
        )
        cur = nxt
    n_adds = len(add_steps)
    cur_a = cur[add_steps]
    for k in range(K):
        fac = line12_235(ch_kn[:, k].reshape(-1, 3, 2, L)).reshape(
            n_adds, n_lane, 12, L
        )
        nxt = np.stack([chain_target(t, K + k) for t in add_steps])
        mb.add(
            cur_a.reshape(-1, 12, L),
            fac.reshape(-1, 12, L),
            nxt.reshape(-1, 12, L),
        )
        cur_a = nxt

    # epilogue: miller_out = f_63 * ep0_k * ep1_k ... through ep_mid wires
    ep_mid = data["ep_mid"][:, sel].astype(np.int64)
    if data["ep_mid"].shape[0] != 2 * K - 1:
        raise ConstraintError(
            f"ep_mid has {data['ep_mid'].shape[0]} rows, schema requires {2*K-1}"
        )
    cur_e = f_steps[n_steps - 1]
    idx = 0
    for k in range(K):
        for j in (0, 1):
            fac = line12_235(ep_kn[j, k])
            last = idx == 2 * K - 1
            nxt = m_out if last else ep_mid[idx]
            mb.add(cur_e, fac, nxt)
            cur_e = nxt
            idx += 1

    # --- 4. easy part over committed wires: inv_m (m*inv_m == 1),
    # easy_mid = conj(m)*inv_m, easy_frob = frob^2(easy_mid),
    # easy_out = easy_frob * easy_mid  (final_exp_native.rs:195-206).
    inv_m = data["inv_m"][sel].astype(np.int64)
    e2 = data["easy_mid"][sel].astype(np.int64)
    fe2 = data["easy_frob"][sel].astype(np.int64)
    mb.add(m_out, inv_m, one_b)
    mb.add(_fq12_conj_cols(m_out), inv_m, e2)
    _frob_check("easy_frob2", report, e2, fe2, 2)
    mb.add(fe2, e2, easy_out)

    # --- 5. exp-offload ladders (the C12 AIR, final_exp_target.rs:89-147)
    # over committed square wires: g_s == row_{s-1}^2 (uniform, row_{-1}=1),
    # then row_s == g_s * x when b_s == 1, row_s == g_s otherwise.
    exp_sq = data["exp_sq"][:, :, sel].astype(np.int64)  # [3, 64, n, 12, L]
    bits_msb = list(reversed(bits_lsb))
    n_bits = len(bits_msb)
    bases = [easy_out, exp_outs[0], exp_outs[1]]
    prev_rows = np.concatenate(
        [np.broadcast_to(one_b, (3, 1, n_lane, 12, L)), exp_rows[:, :-1]],
        axis=1,
    )
    mb.add(
        prev_rows.reshape(-1, 12, L),
        prev_rows.reshape(-1, 12, L),
        exp_sq.reshape(-1, 12, L),
    )
    ones_idx = [s for s in range(n_bits) if bits_msb[s]]
    zeros_idx = [s for s in range(n_bits) if not bits_msb[s]]
    for r in range(3):
        if ones_idx:
            g = exp_sq[r, ones_idx].reshape(-1, 12, L)
            x = np.broadcast_to(
                bases[r], (len(ones_idx), n_lane, 12, L)
            ).reshape(-1, 12, L)
            rr = exp_rows[r, ones_idx].reshape(-1, 12, L)
            mb.add(g, x, rr)
        if zeros_idx:
            _ident_rows(
                report, f"exp_copy.{r}",
                exp_sq[r, zeros_idx].reshape(-1, 12, L),
                exp_rows[r, zeros_idx].reshape(-1, 12, L),
            )
        # splice: exp_outs[r] = offset * row_63, offset = 1
        _ident_rows(report, f"exp_splice.{r}", exp_rows[r, -1], exp_outs[r])

    # --- 6. hard part (final_exp_native.rs:130-169) over committed
    # frobenius wires + chain intermediates; conjugations are sign folds.
    hf = data["hard_frob"][:, sel].astype(np.int64)  # [7, n, 12, L]
    hm = data["hard_mid"][:, sel].astype(np.int64)  # [16, n, 12, L]
    frob_srcs = (
        ("m1", easy_out, 1), ("m2", easy_out, 2), ("m3", easy_out, 3),
        ("mx1", exp_outs[0], 1), ("mx21", exp_outs[1], 1),
        ("mx22", exp_outs[1], 2), ("mx31", exp_outs[2], 1),
    )
    for i, (name, src, pw) in enumerate(frob_srcs):
        _frob_check(f"hard_frob.{name}", report, src, hf[i], pw)
    m1f, m2f, m3f, mx1f, mx21f, mx22f, mx31f = hf
    (h0, y0, y4p, y6p, sq6, t0a, t0, t1a,
     t1, t0b, t1b, t1c, t1d, ta, tb, ta2) = hm
    Cj = _fq12_conj_cols
    y1, y2, y3 = Cj(easy_out), mx22f, Cj(mx1f)
    y4, y5, y6 = Cj(y4p), Cj(exp_outs[1]), Cj(y6p)
    mb.add(m2f, m3f, h0)
    mb.add(m1f, h0, y0)
    mb.add(exp_outs[0], mx21f, y4p)
    mb.add(exp_outs[2], mx31f, y6p)
    mb.add(y6, y6, sq6)
    mb.add(sq6, y4, t0a)
    mb.add(t0a, y5, t0)
    mb.add(y3, y5, t1a)
    mb.add(t1a, t0, t1)
    mb.add(y2, t0, t0b)
    mb.add(t1, t1, t1b)
    mb.add(t1b, t0b, t1c)
    mb.add(t1c, t1c, t1d)
    mb.add(t1d, y1, ta)
    mb.add(t1d, y0, tb)
    mb.add(ta, ta, ta2)
    mb.add(ta2, tb, final_out)

    mb.check("fq12_mul", report)
    return report


def _ident_rows(report, where, a_cols: np.ndarray, b_cols: np.ndarray):
    """Committed Fq12 value equality a == b (degree-1, per coefficient)."""
    for i in range(12):
        _identity(
            f"{where}.k{i}", report, [],
            [(a_cols[:, i, :], 1, 0), (b_cols[:, i, :], -1, 0)],
        )
