"""BN254 integer constants and host-side helpers: the benchmark's frozen copy.

A copy of ``pairing_tpu_torch/utils/bn254.py`` kept beside the benchmark's
plain reference, so that the reference imports nothing of the program under
test. It differs from the original in this docstring only.

Reference parity (qope/plonky2-bn254-pairing):
  - BN_X                    <-> src/final_exp_native.rs:15
  - SIX_U_PLUS_2_NAF        <-> src/miller_loop_native.rs:314-318
  - XI_0 (xi = 9 + u)       <-> src/miller_loop_target.rs:15
  - frob_coeffs(k)          <-> src/final_exp_native.rs:183-192
  - twisted-Frobenius c2/c3 <-> src/miller_loop_native.rs:176-181
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

# ---------------------------------------------------------------------------
# Curve parameters
# ---------------------------------------------------------------------------

#: BN254 base field modulus p.
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583

#: BN254 scalar field modulus r (group order of G1/G2/GT).
R_SCALAR = 21888242871839275222246405745257275088548364400416034343698204186575808495617

#: BN parameter x: p and r are degree-4/degree-4 polynomials in x.
#: Reference: src/final_exp_native.rs:15.
BN_X = 4965661367192848881

#: Sextic-twist / Fq2 nonresidue xi = XI_0 + u = 9 + u.
XI_0 = 9

# Sanity guards mirrored from the reference (final_exp_native.rs:20-21).
assert P % 4 == 3
assert P % 6 == 1
assert 6 * BN_X + 2 == 0x19D797039BE763BA8

# ---------------------------------------------------------------------------
# NAF encodings
# ---------------------------------------------------------------------------


def get_naf(exp: int) -> List[int]:
    """Non-adjacent-form digits of ``exp``, least-significant first.

    Mirrors the digit convention of the reference (final_exp_native.rs:86-128):
    for every odd intermediate value the digit is ``2 - (e % 4)`` (i.e. +1 or
    -1) and the value is corrected upward on -1.
    """
    assert exp >= 0
    naf: List[int] = []
    e = exp
    while e > 0:
        if e & 1:
            z = 2 - (e % 4)
            naf.append(z)
            e -= z
        else:
            naf.append(0)
        e >>= 1
    return naf


def get_wnaf(exp: int, w: int) -> List[int]:
    """Width-``w`` NAF digits of ``exp``, least-significant first.

    Digits are odd with |d| < 2^(w-1); at most one nonzero digit in any
    ``w`` consecutive positions (~len/(w+1) nonzero vs len/3 for plain
    NAF). Generalizes :func:`get_naf` (w=2); used by the windowed
    cyclotomic pow ladder to cut ladder multiplies."""
    assert exp >= 0 and w >= 2
    digits: List[int] = []
    e = exp
    half = 1 << (w - 1)
    full = 1 << w
    while e > 0:
        if e & 1:
            d = e % full
            if d >= half:
                d -= full
            digits.append(d)
            e -= d
        else:
            digits.append(0)
        e >>= 1
    return digits


#: NAF of 6x+2 driving the optimal-ate Miller loop, least-significant first.
#: Value-checked against the hardcoded table in miller_loop_native.rs:314-318.
SIX_U_PLUS_2_NAF: Tuple[int, ...] = tuple(
    [0, 0, 0, 1, 0, 1, 0, -1, 0, 0, 1, -1, 0, 0, 1, 0, 0, 1, 1, 0, -1, 0, 0,
     1, 0, -1, 0, 0, 0, 0, 1, 1, 1, 0, 0, -1, 0, 0, 1, 0, 0, 0, 0, 0, -1, 0,
     0, 1, 1, 0, 0, -1, 0, 0, 0, 1, 1, 0, -1, 0, 0, 1, 0, 1, 1]
)
assert sum(d * (1 << i) for i, d in enumerate(SIX_U_PLUS_2_NAF)) == 6 * BN_X + 2

#: NAF of BN_X used by pow ladders (final_exp_native.rs:56-84 semantics).
BN_X_NAF: Tuple[int, ...] = tuple(get_naf(BN_X))
assert sum(d * (1 << i) for i, d in enumerate(BN_X_NAF)) == BN_X

# ---------------------------------------------------------------------------
# Fq2 host arithmetic (plain ints) — used to precompute constants
# ---------------------------------------------------------------------------

Fq2Int = Tuple[int, int]  # (c0, c1) meaning c0 + c1*u with u^2 = -1


def fq2_mul(a: Fq2Int, b: Fq2Int) -> Fq2Int:
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def fq2_pow(a: Fq2Int, e: int) -> Fq2Int:
    result: Fq2Int = (1, 0)
    base = a
    while e > 0:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_mul(base, base)
        e >>= 1
    return result


def fq2_inv(a: Fq2Int) -> Fq2Int:
    a0, a1 = a
    norm = (a0 * a0 + a1 * a1) % P
    inv_norm = pow(norm, P - 2, P)
    return ((a0 * inv_norm) % P, (-a1 * inv_norm) % P)


XI: Fq2Int = (XI_0, 1)

# ---------------------------------------------------------------------------
# Frobenius constants
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def frob_coeff(power: int) -> Fq2Int:
    """xi^((p^power - 1) / 6); reference final_exp_native.rs:183-192."""
    k = (P**power - 1) // 6
    return fq2_pow(XI, k)


@lru_cache(maxsize=None)
def frob_coeff_pow(power: int, i: int) -> Fq2Int:
    """frob_coeff(power)^i for slot i in 0..6 (final_exp_native.rs:27)."""
    c: Fq2Int = (1, 0)
    base = frob_coeff(power)
    for _ in range(i):
        c = fq2_mul(c, base)
    return c


#: Twisted-Frobenius coefficients (miller_loop_native.rs:176-181):
#: c = xi^((p-1)/6); TWIST_C2 = c^2, TWIST_C3 = c^3.
_TWIST_C = fq2_pow(XI, (P - 1) // 6)
TWIST_C2: Fq2Int = fq2_mul(_TWIST_C, _TWIST_C)
TWIST_C3: Fq2Int = fq2_mul(TWIST_C2, _TWIST_C)

# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

#: G1 generator (y^2 = x^3 + 3).
G1_GEN = (1, 2)
assert (G1_GEN[1] ** 2 - G1_GEN[0] ** 3 - 3) % P == 0

#: G2 generator on the sextic twist y^2 = x^3 + 3/xi (standard BN254 values).
G2_GEN_X: Fq2Int = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y: Fq2Int = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

#: Twist curve coefficient b2 = 3 / xi as Fq2.
TWIST_B: Fq2Int = fq2_mul((3, 0), fq2_inv(XI))


def _on_twist(x: Fq2Int, y: Fq2Int) -> bool:
    x3 = fq2_mul(fq2_mul(x, x), x)
    y2 = fq2_mul(y, y)
    return ((y2[0] - x3[0] - TWIST_B[0]) % P, (y2[1] - x3[1] - TWIST_B[1]) % P) == (0, 0)


assert _on_twist(G2_GEN_X, G2_GEN_Y)

#: Exponent of the final exponentiation: (p^12 - 1) / r.
FINAL_EXP_POWER = (P**12 - 1) // R_SCALAR
assert (P**12 - 1) % R_SCALAR == 0
