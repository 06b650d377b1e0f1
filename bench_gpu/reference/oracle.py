"""Pure-Python BN254 optimal-ate pairing oracle: the benchmark's frozen copy.

A copy of ``pairing_tpu_torch/oracle/native.py`` kept beside the benchmark,
so that the plain reference imports nothing of the program under test. It
differs from the original in this paragraph and in importing its constants
from the copy beside it (``bn254.py``) instead of the program's.

Fq12 convention — the halo2-lib *coefficient basis* used throughout the
reference (see SURVEY.md §2.2 and miller_loop_native.rs:46-96): an element is
a list ``c`` of 12 ints with

    a = sum_{i=0..5} (c[i] + c[i+6] * u) * w^i,   w^6 = xi = 9 + u,  u^2 = -1.

Reference parity map (file:line refers to qope/plonky2-bn254-pairing src/):
  - sparse_line_function_unequal  <-> miller_loop_native.rs:10-28
  - sparse_line_function_equal    <-> miller_loop_native.rs:30-44
  - sparse_fp12_multiply          <-> miller_loop_native.rs:46-96
  - miller_loop                   <-> miller_loop_native.rs:112-190,320-322
  - multi_miller_loop             <-> miller_loop_native.rs:192-282,324-326
  - frobenius_map                 <-> final_exp_native.rs:17-54
  - pow_fq12 (NAF ladder)         <-> final_exp_native.rs:56-84
  - final_exp / easy/hard part    <-> final_exp_native.rs:130-213
  - pairing                       <-> pairing.rs:20-22
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .bn254 import (
    BN_X,
    BN_X_NAF,
    P,
    R_SCALAR,
    SIX_U_PLUS_2_NAF,
    TWIST_C2,
    TWIST_C3,
    XI,
    Fq2Int,
    fq2_inv,
    fq2_mul,
    frob_coeff_pow,
)

Fq12 = List[int]  # 12 coefficients, coefficient basis
G1Point = Tuple[int, int]  # affine (x, y)
G2Point = Tuple[Fq2Int, Fq2Int]  # affine (x, y) over Fq2

# ---------------------------------------------------------------------------
# Fq / Fq2 helpers
# ---------------------------------------------------------------------------


def fq2_add(a: Fq2Int, b: Fq2Int) -> Fq2Int:
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a: Fq2Int, b: Fq2Int) -> Fq2Int:
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a: Fq2Int) -> Fq2Int:
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_scale(a: Fq2Int, k: int) -> Fq2Int:
    return ((a[0] * k) % P, (a[1] * k) % P)


def fq2_conj(a: Fq2Int) -> Fq2Int:
    """conjugate_fp2 (miller_loop_native.rs:284-289): c0 + c1*u -> c0 - c1*u."""
    return (a[0], (-a[1]) % P)


def fq2_neg_conj(a: Fq2Int) -> Fq2Int:
    """neg_conjugate_fp2 (miller_loop_native.rs:291-296): -> -c0 + c1*u."""
    return ((-a[0]) % P, a[1])


# ---------------------------------------------------------------------------
# Fq12 (coefficient basis)
# ---------------------------------------------------------------------------


def fq12_one() -> Fq12:
    return [1] + [0] * 11


def fq12_from_fq2_slots(slots: Sequence[Optional[Fq2Int]]) -> Fq12:
    """Embed 6 optional Fq2 slots into the 12-coefficient layout."""
    assert len(slots) == 6
    out = [0] * 12
    for i, s in enumerate(slots):
        if s is not None:
            out[i] = s[0]
            out[i + 6] = s[1]
    return out


def fq12_to_fq2_slots(a: Fq12) -> List[Fq2Int]:
    return [(a[i], a[i + 6]) for i in range(6)]


def sparse_fp12_multiply(a: Fq12, b: Sequence[Optional[Fq2Int]]) -> Fq12:
    """Schoolbook product in Fq2[w] followed by the w^6 = xi fold.

    Mirrors miller_loop_native.rs:46-96 exactly, including the slot-presence
    bookkeeping (so it also serves as a dense mul when all slots are Some).
    """
    a2 = fq12_to_fq2_slots(a)
    prod: List[Optional[Fq2Int]] = [None] * 11
    for i in range(6):
        for j in range(6):
            bj = b[j]
            if bj is None:
                continue
            t = fq2_mul(a2[i], bj)
            prod[i + j] = t if prod[i + j] is None else fq2_add(prod[i + j], t)
    out: List[Fq2Int] = []
    for i in range(6):
        if i != 5:
            hi = prod[i + 6]
            lo = prod[i]
            if hi is not None:
                hi = fq2_mul(hi, XI)
            if lo is None:
                out.append(hi if hi is not None else (0, 0))
            elif hi is None:
                out.append(lo)
            else:
                out.append(fq2_add(lo, hi))
        else:
            out.append(prod[5] if prod[5] is not None else (0, 0))
    return [c[0] for c in out] + [c[1] for c in out]


def fq12_mul(a: Fq12, b: Fq12) -> Fq12:
    return sparse_fp12_multiply(a, fq12_to_fq2_slots(b))


def fq12_conj(a: Fq12) -> Fq12:
    """conjugate_fp12 (final_exp_native.rs:171-181): negate odd-index coeffs."""
    return [c if i % 2 == 0 else (-c) % P for i, c in enumerate(a)]


def fq12_inv(a: Fq12) -> Fq12:
    """General Fq12 inverse via the internal tower Fq12 = Fq6[w]/(w^2 - v).

    The coefficient basis a = sum a_i w^i regroups as A + B*w with
    A = (a0, a2, a4), B = (a1, a3, a5) in Fq6 = Fq2[v]/(v^3 - xi), v = w^2.
    The inverse is unique, so this matches the reference's arkworks division
    (final_exp_native.rs:72-75,195-206) value-for-value.
    """
    s = fq12_to_fq2_slots(a)
    A = (s[0], s[2], s[4])
    B = (s[1], s[3], s[5])

    def fq6_mul(x, y):
        c0 = fq2_add(
            fq2_mul(x[0], y[0]),
            fq2_mul(XI, fq2_add(fq2_mul(x[1], y[2]), fq2_mul(x[2], y[1]))),
        )
        c1 = fq2_add(
            fq2_add(fq2_mul(x[0], y[1]), fq2_mul(x[1], y[0])),
            fq2_mul(XI, fq2_mul(x[2], y[2])),
        )
        c2 = fq2_add(
            fq2_add(fq2_mul(x[0], y[2]), fq2_mul(x[2], y[0])), fq2_mul(x[1], y[1])
        )
        return (c0, c1, c2)

    def fq6_mul_by_v(x):
        return (fq2_mul(XI, x[2]), x[0], x[1])

    def fq6_sub(x, y):
        return tuple(fq2_sub(xi_, yi) for xi_, yi in zip(x, y))

    def fq6_inv(x):
        c0, c1, c2 = x
        t0 = fq2_sub(fq2_mul(c0, c0), fq2_mul(XI, fq2_mul(c1, c2)))
        t1 = fq2_sub(fq2_mul(XI, fq2_mul(c2, c2)), fq2_mul(c0, c1))
        t2 = fq2_sub(fq2_mul(c1, c1), fq2_mul(c0, c2))
        norm = fq2_add(
            fq2_mul(c0, t0),
            fq2_mul(XI, fq2_add(fq2_mul(c1, t2), fq2_mul(c2, t1))),
        )
        ninv = fq2_inv(norm)
        return (fq2_mul(t0, ninv), fq2_mul(t1, ninv), fq2_mul(t2, ninv))

    # (A + Bw)^-1 = (A - Bw) / (A^2 - B^2 v)
    denom = fq6_sub(fq6_mul(A, A), fq6_mul_by_v(fq6_mul(B, B)))
    dinv = fq6_inv(denom)
    out_a = fq6_mul(A, dinv)
    out_b = fq6_mul(tuple(fq2_neg(x) for x in B), dinv)
    slots = [out_a[0], out_b[0], out_a[1], out_b[1], out_a[2], out_b[2]]
    return fq12_from_fq2_slots(slots)


def fq12_div(a: Fq12, b: Fq12) -> Fq12:
    return fq12_mul(a, fq12_inv(b))


def to_tower_basis(a: Fq12):
    """Coefficient basis -> arkworks tower basis (the `MyFq12 <-> Fq12`
    conversion of plonky2-bn254, SURVEY.md §2.2).

    Tower: Fq12 = Fq6[w]/(w^2 - v), Fq6 = Fq2[v]/(v^3 - xi), with w the
    same sextic root (w^6 = xi) and v = w^2 — so the basis change is the
    slot regrouping c0 = (s0, s2, s4), c1 = (s1, s3, s5).
    Returns ((c00, c01, c02), (c10, c11, c12)) of Fq2 pairs.
    """
    s = fq12_to_fq2_slots(a)
    return ((s[0], s[2], s[4]), (s[1], s[3], s[5]))


def from_tower_basis(tower) -> Fq12:
    """Inverse of :func:`to_tower_basis`."""
    (c00, c01, c02), (c10, c11, c12) = tower
    return fq12_from_fq2_slots([c00, c10, c01, c11, c02, c12])


def cyclotomic_square(z: Fq12) -> Fq12:
    """Granger-Scott squaring for unit-norm (cyclotomic) elements.

    Uses the Fq4 decomposition g_i = slot_i + slot_{i+3} * w^3 of the
    coefficient basis ((w^3)^2 = xi); valid exactly on the cyclotomic
    subgroup (post easy-part), where it equals fq12_mul(z, z).
    """
    s = fq12_to_fq2_slots(z)

    def fq4_sq(a, b):
        a2 = fq2_mul(a, a)
        b2 = fq2_mul(b, b)
        ab = fq2_sub(fq2_mul(fq2_add(a, b), fq2_add(a, b)), fq2_add(a2, b2))
        return fq2_add(a2, fq2_mul(XI, b2)), ab

    A0, A1 = fq4_sq(s[0], s[3])
    B0, B1 = fq4_sq(s[1], s[4])
    C0, C1 = fq4_sq(s[2], s[5])
    out: List[Fq2Int] = [None] * 6  # type: ignore[list-item]
    out[0] = fq2_sub(fq2_scale(A0, 3), fq2_scale(s[0], 2))
    out[2] = fq2_sub(fq2_scale(B0, 3), fq2_scale(s[2], 2))
    out[4] = fq2_sub(fq2_scale(C0, 3), fq2_scale(s[4], 2))
    out[1] = fq2_add(fq2_scale(fq2_mul(XI, C1), 3), fq2_scale(s[1], 2))
    out[3] = fq2_add(fq2_scale(A1, 3), fq2_scale(s[3], 2))
    out[5] = fq2_add(fq2_scale(B1, 3), fq2_scale(s[5], 2))
    return fq12_from_fq2_slots(out)


def frobenius_map(a: Fq12, power: int) -> Fq12:
    """final_exp_native.rs:17-54: per-slot multiply by frob_coeffs(pow)^i."""
    pw = power % 12
    out: List[Fq2Int] = []
    for i in range(6):
        c = (a[i], a[i + 6])
        if pw % 2 != 0:
            c = fq2_conj(c)
        out.append(fq2_mul(c, frob_coeff_pow(pw, i)))
    return fq12_from_fq2_slots(out)


def pow_fq12(a: Fq12, exp: int) -> Fq12:
    """NAF square-and-multiply ladder (final_exp_native.rs:56-84).

    -1 digits use the exact inverse (the reference divides; values agree).
    """
    res = list(a)
    started = False
    a_inv: Optional[Fq12] = None
    for z in reversed(list(_naf(exp))):
        if started:
            res = fq12_mul(res, res)
        if z != 0:
            if started:
                if z == 1:
                    res = fq12_mul(res, a)
                else:
                    if a_inv is None:
                        a_inv = fq12_inv(a)
                    res = fq12_mul(res, a_inv)
            else:
                assert z == 1
                started = True
    return res


def _naf(exp: int):
    if exp == BN_X:
        return BN_X_NAF
    from .bn254 import get_naf

    return get_naf(exp)


# ---------------------------------------------------------------------------
# G1 / G2 affine arithmetic
# ---------------------------------------------------------------------------


def g1_neg(p: G1Point) -> G1Point:
    return (p[0], (-p[1]) % P)


def g1_add(p, q):
    """Complete affine addition; ``None`` is the point at infinity
    (arkworks complete-add semantics inherited at
    miller_loop_native.rs:157)."""
    if p is None:
        return q
    if q is None:
        return p
    if p[0] == q[0] and (p[1] + q[1]) % P == 0:
        return None  # q == -p (covers doubling a 2-torsion point)
    if p == q:
        lam = (3 * p[0] * p[0] * pow(2 * p[1], P - 2, P)) % P
    else:
        lam = ((q[1] - p[1]) * pow(q[0] - p[0], P - 2, P)) % P
    x3 = (lam * lam - p[0] - q[0]) % P
    y3 = (lam * (p[0] - x3) - p[1]) % P
    return (x3, y3)


def g1_mul(p, k: int):
    result = None
    addend = p
    while k > 0:
        if k & 1:
            result = g1_add(result, addend)
        addend = g1_add(addend, addend)
        k >>= 1
    return result


def g2_neg(q: G2Point) -> G2Point:
    return (q[0], fq2_neg(q[1]))


def g2_double(q: G2Point) -> G2Point:
    x, y = q
    lam = fq2_mul(fq2_scale(fq2_mul(x, x), 3), fq2_inv(fq2_scale(y, 2)))
    x3 = fq2_sub(fq2_mul(lam, lam), fq2_scale(x, 2))
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x, x3)), y)
    return (x3, y3)


def g2_add(q1, q2):
    """Complete affine addition on the twist; ``None`` is infinity."""
    if q1 is None:
        return q2
    if q2 is None:
        return q1
    if q1[0] == q2[0] and fq2_add(q1[1], q2[1]) == (0, 0):
        return None
    if q1 == q2:
        return g2_double(q1)
    x1, y1 = q1
    x2, y2 = q2
    lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_mul(lam, lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(q, k: int):
    result = None
    addend = q
    while k > 0:
        if k & 1:
            result = g2_add(result, addend)
        addend = g2_add(addend, addend)
        k >>= 1
    return result


def g2_in_subgroup(q) -> bool:
    """Exact r-torsion membership test: [r]Q == O (complete adds make the
    ladder total). ``None`` (infinity) is a member."""
    if q is None:
        return True
    return g2_mul(q, R_SCALAR) is None


# ---------------------------------------------------------------------------
# Square roots (test-vector construction for validation suites)
# ---------------------------------------------------------------------------


def fp_sqrt(a: int):
    """sqrt in Fp (p = 3 mod 4), or None if a is a non-residue."""
    a %= P
    r = pow(a, (P + 1) // 4, P)
    return r if r * r % P == a else None


def fq2_sqrt(a: Fq2Int):
    """sqrt in Fq2 = Fp[u]/(u^2+1) via the norm method, or None."""
    a0, a1 = a[0] % P, a[1] % P
    if a1 == 0:
        r = fp_sqrt(a0)
        if r is not None:
            return (r, 0)
        r = fp_sqrt((-a0) % P)
        return None if r is None else (0, r)  # (ru)^2 = -r^2 = a0
    n = fp_sqrt((a0 * a0 + a1 * a1) % P)
    if n is None:
        return None
    inv2 = pow(2, P - 2, P)
    for nn in (n, (-n) % P):
        x0 = fp_sqrt((a0 + nn) * inv2 % P)
        if x0 in (None, 0):
            continue
        x1 = a1 * pow(2 * x0, P - 2, P) % P
        if fq2_mul((x0, x1), (x0, x1)) == (a0, a1):
            return (x0, x1)
    return None


def g2_point_from_x(x: Fq2Int):
    """Some affine point on the twist with the given x, or None. Used to
    build adversarial on-curve-but-non-subgroup vectors (a random twist
    point lies in the r-torsion with probability ~1/h, h ~ p)."""
    from .bn254 import TWIST_B

    rhs = fq2_add(fq2_mul(fq2_mul(x, x), x), TWIST_B)
    y = fq2_sqrt(rhs)
    return None if y is None else (tuple(v % P for v in x), y)


def twisted_frobenius(q: G2Point) -> G2Point:
    """miller_loop_native.rs:298-304: (c2*conj(x), c3*conj(y))."""
    return (fq2_mul(TWIST_C2, fq2_conj(q[0])), fq2_mul(TWIST_C3, fq2_conj(q[1])))


def neg_twisted_frobenius(q: G2Point) -> G2Point:
    """miller_loop_native.rs:306-312: (c2*conj(x), c3*neg_conj(y))."""
    return (fq2_mul(TWIST_C2, fq2_conj(q[0])), fq2_mul(TWIST_C3, fq2_neg_conj(q[1])))


# ---------------------------------------------------------------------------
# Line functions
# ---------------------------------------------------------------------------


def sparse_line_function_unequal(
    q0: G2Point, q1: G2Point, p: G1Point
) -> List[Optional[Fq2Int]]:
    """Chord line through q0, q1 evaluated at p; slots {2,3,5} populated.

    miller_loop_native.rs:10-28: out3=(y1-y2)*Px, out2=(x2-x1)*Py,
    out5=x1*y2-x2*y1.
    """
    (x1, y1), (x2, y2) = q0, q1
    px, py = p
    out3 = fq2_scale(fq2_sub(y1, y2), px)
    out2 = fq2_scale(fq2_sub(x2, x1), py)
    out5 = fq2_sub(fq2_mul(x1, y2), fq2_mul(x2, y1))
    return [None, None, out2, out3, None, out5]


def sparse_line_function_equal(q: G2Point, p: G1Point) -> List[Optional[Fq2Int]]:
    """Tangent line at q evaluated at p; slots {0,3,4} populated.

    miller_loop_native.rs:30-44: out0=(3x^3-2y^2)*xi, out4=-3x^2*Px,
    out3=2y*Py.
    """
    x, y = q
    px, py = p
    x_sq = fq2_mul(x, x)
    three_x_cu = fq2_scale(fq2_mul(x_sq, x), 3)
    two_y_sq = fq2_scale(fq2_mul(y, y), 2)
    out0 = fq2_mul(fq2_sub(three_x_cu, two_y_sq), XI)
    out4 = fq2_scale(fq2_scale(x_sq, px), P - 3)
    out3 = fq2_scale(fq2_scale(y, py), 2)
    return [out0, None, None, out3, out4, None]


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------


def miller_loop(q: G2Point, p: G1Point) -> Fq12:
    """Optimal-ate Miller loop; mirrors miller_loop_BN_native
    (miller_loop_native.rs:112-190) step by step."""
    naf = SIX_U_PLUS_2_NAF
    i = len(naf) - 1
    while naf[i] == 0:
        i -= 1
    last_index = i
    assert naf[i] in (1, -1)
    r = q if naf[i] == 1 else g2_neg(q)
    i -= 1

    f = fq12_from_fq2_slots(sparse_line_function_equal(r, p))

    while True:
        if i != last_index - 1:
            f = fq12_mul(f, f)
            f = sparse_fp12_multiply(f, sparse_line_function_equal(r, p))
        r = g2_double(r)
        if naf[i] != 0:
            sign_q = q if naf[i] == 1 else g2_neg(q)
            f = sparse_fp12_multiply(f, sparse_line_function_unequal(r, sign_q, p))
            r = g2_add(r, sign_q)
        if i == 0:
            break
        i -= 1

    q1 = twisted_frobenius(q)
    neg_q2 = neg_twisted_frobenius(q1)
    f = sparse_fp12_multiply(f, sparse_line_function_unequal(r, q1, p))
    r = g2_add(r, q1)
    f = sparse_fp12_multiply(f, sparse_line_function_unequal(r, neg_q2, p))
    return f


def multi_miller_loop(pairs: Sequence[Tuple[G1Point, G2Point]]) -> Fq12:
    """Shared-squaring multi-Miller loop (miller_loop_native.rs:192-282)."""
    naf = SIX_U_PLUS_2_NAF
    i = len(naf) - 1
    while naf[i] == 0:
        i -= 1
    last_index = i
    assert naf[last_index] == 1

    neg_b = [g2_neg(q) for (_, q) in pairs]

    f = fq12_from_fq2_slots(sparse_line_function_equal(pairs[0][1], pairs[0][0]))
    for a, b in pairs[1:]:
        f = sparse_fp12_multiply(f, sparse_line_function_equal(b, a))

    i -= 1
    r = [q for (_, q) in pairs]
    while True:
        if i != last_index - 1:
            f = fq12_mul(f, f)
            for rj, (a, _) in zip(r, pairs):
                f = sparse_fp12_multiply(f, sparse_line_function_equal(rj, a))
        r = [g2_double(rj) for rj in r]
        if naf[i] != 0:
            for j, (a, b) in enumerate(pairs):
                sign_b = b if naf[i] == 1 else neg_b[j]
                f = sparse_fp12_multiply(
                    f, sparse_line_function_unequal(r[j], sign_b, a)
                )
                r[j] = g2_add(r[j], sign_b)
        if i == 0:
            break
        i -= 1

    for j, (a, b) in enumerate(pairs):
        b1 = twisted_frobenius(b)
        neg_b2 = neg_twisted_frobenius(b1)
        f = sparse_fp12_multiply(f, sparse_line_function_unequal(r[j], b1, a))
        r[j] = g2_add(r[j], b1)
        f = sparse_fp12_multiply(f, sparse_line_function_unequal(r[j], neg_b2, a))
    return f


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------


def easy_part(a: Fq12) -> Fq12:
    """a -> a^((q^6-1)(q^2+1)) (final_exp_native.rs:195-206)."""
    f1 = fq12_conj(a)
    f2 = fq12_div(f1, a)
    f3 = frobenius_map(f2, 2)
    return fq12_mul(f3, f2)


def hard_part(m: Fq12) -> Fq12:
    """halo2-lib addition chain (final_exp_native.rs:130-169)."""
    mp = frobenius_map(m, 1)
    mp2 = frobenius_map(m, 2)
    mp3 = frobenius_map(m, 3)

    y0 = fq12_mul(mp, fq12_mul(mp2, mp3))
    y1 = fq12_conj(m)
    mx = pow_fq12(m, BN_X)
    mxp = frobenius_map(mx, 1)
    mx2 = pow_fq12(mx, BN_X)
    mx2p = frobenius_map(mx2, 1)
    y2 = frobenius_map(mx2, 2)
    y5 = fq12_conj(mx2)
    mx3 = pow_fq12(mx2, BN_X)
    mx3p = frobenius_map(mx3, 1)

    y3 = fq12_conj(mxp)
    y4 = fq12_conj(fq12_mul(mx, mx2p))
    y6 = fq12_conj(fq12_mul(mx3, mx3p))

    t0 = fq12_mul(y6, y6)
    t0 = fq12_mul(t0, y4)
    t0 = fq12_mul(t0, y5)
    t1 = fq12_mul(y3, y5)
    t1 = fq12_mul(t1, t0)
    t0 = fq12_mul(y2, t0)
    t1 = fq12_mul(t1, t1)
    t1 = fq12_mul(t1, t0)
    t1 = fq12_mul(t1, t1)
    t0 = fq12_mul(t1, y1)
    t1 = fq12_mul(t1, y0)
    t0 = fq12_mul(t0, t0)
    t0 = fq12_mul(t0, t1)
    return t0


def final_exp(a: Fq12) -> Fq12:
    """a -> a^((q^12-1)/r) (final_exp_native.rs:209-213)."""
    return hard_part(easy_part(a))


def pairing(p: G1Point, q: G2Point) -> Fq12:
    """Full optimal-ate pairing e(P, Q) (pairing.rs:20-22)."""
    return final_exp(miller_loop(q, p))
