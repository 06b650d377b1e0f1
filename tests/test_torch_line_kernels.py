"""Kernel K's plain version (Phase C: tangent and chord lines with the
affine fold-in) against the JAX package.

Random Jacobian states, inverses and P/Q coordinates go through
``ops.line_kernels.lines`` on CPU tensors (its plain version) over a short
digit schedule. Each tangent row, and the chord row of each step with a
nonzero digit, must equal the JAX package's ``pairing.lines.line_equal`` /
``line_unequal`` on the affine points (X zi^2, Y zi^3) computed by its own
field ops, exactly (canonical values). The file also holds numpy models of
the 32-bit column sums of kernels H, K (Fq2 products) and A (Fq12
products, folded between terms).
"""

import numpy as np
import pytest
import torch

from pairing_tpu.fields import fp as JF
from pairing_tpu.fields import fp2 as JF2
from pairing_tpu.pairing import lines as JL
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields import fp2 as TF2
from pairing_tpu_torch.ops import fq12_kernels as FK
from pairing_tpu_torch.ops import line_kernels as LK
from pairing_tpu_torch.utils import bn254 as c

torch.set_num_threads(2)

B = 3
DIGITS = [1, 0, -1, 1]
CH_ROWS = [2, -1, 0, 1]  # chord rows out of step order on purpose
N_CH = 3
RINV = pow(TF.R_MONT, -1, c.P)


def rows_ints(arr: torch.Tensor) -> np.ndarray:
    """Rows [..., 21, B] -> ints mod p (out of Montgomery form), [..., B]."""
    can = FK.kf12_canonical(arr).transpose(-1, -2).contiguous()
    vals = [TF.limbs_to_int(r) * RINV % c.P for r in can.reshape(-1, TF.NLIMBS).numpy()]
    return np.asarray(vals, dtype=object).reshape(tuple(can.shape[:-1]))


def rand_limbs(rng, lead):
    """Montgomery limbs [*lead, B, 21] of random Fq values."""
    n = int(np.prod(lead, dtype=np.int64)) * B
    vals = [int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(n)]
    return np.asarray(JF.fp_from_ints_mont(vals).limbs).reshape(tuple(lead) + (B, TF.NLIMBS))


def port_rows(limbs):
    """[..., B, 21] -> [..., 21, B]."""
    return torch.as_tensor(np.ascontiguousarray(np.swapaxes(limbs, -1, -2)))


def jfp2(limbs, k):
    return JF2.from_limbs((limbs[..., 2 * k, :, :], limbs[..., 2 * k + 1, :, :]))


def j_affine(state, zi):
    """JAX (X zi^2, Y zi^3) from limbs [6, B, 21] and [2, B, 21]."""
    z = JF2.from_limbs((zi[0], zi[1]))
    z2 = JF2.square(z)
    z3 = JF2.mul(z2, z)
    return JF2.mul(jfp2(state, 0), z2), JF2.mul(jfp2(state, 1), z3)


def j_rows(line3) -> np.ndarray:
    """3 JAX Fp2 of batch [B] -> ints [6, B]."""
    out = []
    for v in line3:
        for comp in (v.c0, v.c1):
            rows = np.asarray(comp.limbs).reshape(-1, TF.NLIMBS)
            out.append([TF.limbs_to_int(r) * RINV % c.P for r in rows])
    return np.asarray(out, dtype=object)


def test_lines_plain_matches_jax():
    rng = np.random.default_rng(601)
    n = len(DIGITS)
    tops, dbls = rand_limbs(rng, (n, 6)), rand_limbs(rng, (n, 6))
    zinv = rand_limbs(rng, (2 * n, 2))
    pq = rand_limbs(rng, (6,))

    tg, ch = LK.lines(port_rows(tops), port_rows(dbls), port_rows(zinv), port_rows(pq),
                      DIGITS, CH_ROWS, N_CH)  # CPU tensors: plain version
    assert tuple(tg.shape) == (n, 6, TF.NLIMBS, B) and tuple(ch.shape) == (N_CH, 6, TF.NLIMBS, B)
    assert FK.kf12_in_envelope(tg) and FK.kf12_in_envelope(ch)
    tg_i, ch_i = rows_ints(tg), rows_ints(ch)

    px = JF.Fp(pq[0], 2 * c.P, JF.SETTLED)
    py = JF.Fp(pq[1], 2 * c.P, JF.SETTLED)
    qx, qy = JF2.from_limbs((pq[2], pq[3])), JF2.from_limbs((pq[4], pq[5]))
    for t, d in enumerate(DIGITS):
        x, y = j_affine(tops[t], zinv[t])
        assert (tg_i[t] == j_rows(JL.line_equal(x, y, px, py))).all()
        if d == 0:
            continue
        cx, cy = j_affine(dbls[t], zinv[n + t])
        sy = qy if d > 0 else JF2.neg(qy)
        assert (ch_i[CH_ROWS[t]] == j_rows(JL.line_unequal(cx, cy, qx, sy, px, py))).all()


def test_line_schedule():
    assert LK.line_schedule(DIGITS, CH_ROWS, N_CH).tolist() == [[1, 2], [0, 0], [-1, 0], [1, 1]]
    # the kernel's chord table: (step, digit, row) of each step with a chord
    table = LK.chord_table(tuple(DIGITS), tuple(CH_ROWS), N_CH, torch.device("cpu"))
    assert table.dtype == torch.int32 and table.tolist() == [[0, 1, 2], [2, -1, 0], [3, 1, 1]]
    with pytest.raises(ValueError):
        LK.line_schedule([1, 0], [3, -1], 3)  # chord row outside the chord stream
    with pytest.raises(ValueError):
        LK.line_schedule([-1], [-1], 1)  # nonzero digit without a chord row
    z = torch.zeros((2, 6, TF.NLIMBS, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        LK.lines(z, z, z[:, :2], z[0], [1, 1], [0, 1], 2)  # fewer inverses than 2n


# ---------------------------------------------------------------------------
# The 32-bit column sums of kernels H and K (csrc/field32.cuh), modelled in
# numpy. A component of an Fq2 product sums two Fq products' limb products
# into 42 columns and reduces word by word (w32_mac, w32_reduce); a square's
# component, or a product by an Fq element, sums one. The kernels keep each
# column in 32 bits, which is exact only while every column stays below
# 2^32: here the columns are uint64 and each is checked against 2^32 after
# every addition. Operands are carried as load_fp carries them, so each
# digit is below 2^13 (asserted); the result must be the field library's,
# digit for digit after an exact carry.
# ---------------------------------------------------------------------------

NL = TF.NLIMBS
NP0 = (-pow(c.P, -1, 1 << TF.RADIX_BITS)) % (1 << TF.RADIX_BITS)
P_DIGITS = np.asarray(TF.int_to_limbs(c.P), np.uint64)
COLUMN_LIMIT = np.uint64(1 << 32)


def digits(vals) -> np.ndarray:
    """Ints in [0, 2^273) -> carried digits [B, NL] (what fp_carry leaves)."""
    return np.stack([TF.int_to_limbs(int(v)) for v in vals]).astype(np.uint64)


def value(d) -> list:
    return [TF.limbs_to_int(row) for row in np.asarray(d, dtype=object)]


def w32_mac(w, a, b) -> None:
    """w += a b for carried digits [B, NL], one limb row at a time."""
    assert (a < TF.RADIX).all() and (b < TF.RADIX).all()  # the columns' precondition
    for i in range(NL):
        w[:, i:i + NL] += a[:, i:i + 1] * b
        assert (w < COLUMN_LIMIT).all()


def w32_reduce(w) -> np.ndarray:
    """w32_reduce: r = (t + m p) / R from the columns w [B, 2 NL], digits [B, NL]."""
    mask = np.uint64(TF.MASK)
    for i in range(NL):
        m = (w[:, i] * np.uint64(NP0)) & mask
        w[:, i:i + NL] += m[:, None] * P_DIGITS
        assert (w < COLUMN_LIMIT).all()
        w[:, i + 1] += w[:, i] >> np.uint64(TF.RADIX_BITS)
        assert (w[:, i + 1] < COLUMN_LIMIT).all()
    r = np.zeros((w.shape[0], NL), np.uint64)
    carry = np.zeros(w.shape[0], np.uint64)
    for k in range(NL):
        s = w[:, NL + k] + carry
        assert (s < COLUMN_LIMIT).all()
        r[:, k] = s & mask
        carry = s >> np.uint64(TF.RADIX_BITS)
    assert (carry == 0).all()
    return r


def w32_mont(pairs) -> np.ndarray:
    """sum a_k b_k over ``pairs`` of carried digits [B, NL], reduced as
    w32_mac / w32_reduce do: r = (t + m p) / R, digits [B, NL]."""
    w = np.zeros((pairs[0][0].shape[0], 2 * NL), np.uint64)
    for a, b in pairs:
        w32_mac(w, a, b)
    return w32_reduce(w)


def model_neg(b) -> np.ndarray:
    """fp_neg: 2p - b, less 2p where that is 2p."""
    return digits([(2 * c.P - v) % (2 * c.P) for v in value(b)])


def model_fp2_mul(a0, a1, b0, b1):
    return (w32_mont([(a0, b0), (a1, model_neg(b1))]), w32_mont([(a0, b1), (a1, b0)]))


def model_fp2_sq(a0, a1):
    va0, va1 = value(a0), value(a1)
    s = digits([x + y for x, y in zip(va0, va1)])
    d = digits([x + 2 * c.P - y for x, y in zip(va0, va1)])
    return (w32_mont([(s, d)]), w32_mont([(digits([2 * x for x in va0]), a1)]))


def model_fp2_mul_fp(a0, a1, k):
    return (w32_mont([(a0, k)]), w32_mont([(a1, k)]))


def operand_limbs(rng, kind: str, n: int) -> np.ndarray:
    """Raw limbs [n, NL] of values below 2p: random; all 2p - 1; or random
    values below p with one limb settled at 2^13 + 1 (a carry moved down)."""
    if kind == "two_p_minus_1":
        return digits([2 * c.P - 1] * n).astype(np.int64)
    top = c.P if kind == "settled" else 2 * c.P
    vals = [int.from_bytes(rng.bytes(40), "little") % top for _ in range(n)]
    limbs = digits(vals).astype(np.int64)
    if kind == "settled":
        for row in limbs:  # the value moves by at most 1 and stays below 2p
            i = int(rng.choice(np.flatnonzero(row[1:]) + 1))
            row[i] -= 1
            row[i - 1] = TF.RADIX + 1
    return limbs


@pytest.mark.parametrize("kind", ["random", "two_p_minus_1", "settled"])
def test_w32_columns_match_field_library(kind):
    """The 32-bit Montgomery sums of kernels H and K, one Fq2 component at a
    time, against F2.mul, F2.square and F2.mul_fp: columns below 2^32, the
    same digits."""
    rng = np.random.default_rng({"random": 801, "two_p_minus_1": 802, "settled": 803}[kind])
    n = 48
    raw = [operand_limbs(rng, kind, n) for _ in range(5)]
    if kind == "settled":
        assert max(int(r.max()) for r in raw) == TF.RADIX + 1
    # load_fp's carry: the same values, digits below 2^13
    a0, a1, b0, b1, k = (digits(value(r)) for r in raw)
    fa0, fa1, fb0, fb1, fk = (TF.Fp(torch.as_tensor(r, dtype=torch.int32), 2 * c.P, TF.SETTLED)
                              for r in raw)
    A, Bv = TF2.Fp2(fa0, fa1), TF2.Fp2(fb0, fb1)

    def lib(fp2):
        return [TF._ripple_carry(x.limbs)[0].numpy().astype(np.uint64) for x in (fp2.c0, fp2.c1)]

    for got, want in ((model_fp2_mul(a0, a1, b0, b1), lib(TF2.mul(A, Bv))),
                      (model_fp2_sq(a0, a1), lib(TF2.square(A))),
                      (model_fp2_mul_fp(a0, a1, k), lib(TF2.mul_fp(A, fk)))):
        for g, w in zip(got, want, strict=True):
            assert np.array_equal(g, w)


# ---------------------------------------------------------------------------
# Kernel A (csrc/fq12_mul.cu): one thread per output component k = 2s + comp
# sums the Fq2 terms a_i b_j over the present slots j of b (i = s - j mod
# 6, xi * a_i when i > s), each as two Fq products into 32-bit columns, with
# a carry-save fold (w32_fold) between terms, and reduces once.
# ---------------------------------------------------------------------------

R_MONT = 1 << (NL * TF.RADIX_BITS)


def a_terms(k: int, mask: int):
    """The (i, j, fold) of component k's Fq2 terms, in the kernel's order."""
    s = k >> 1
    for i in range(6):
        fold = i > s
        j = s - i + 6 if fold else s - i
        if mask >> j & 1:
            yield i, j, fold


def w32_fold(w) -> None:
    """Each column keeps its low 13 bits and passes the rest up, at once."""
    carry = w[:, :-1] >> np.uint64(TF.RADIX_BITS)
    w[:, :-1] &= np.uint64(TF.MASK)
    w[:, 1:] += carry
    assert (w < COLUMN_LIMIT).all()


def model_fq12_mul(a, b, mask: int):
    """One thread of kernel A per component: a, b are 12 carried digit
    arrays [B, NL] (load_fp's carry). Returns the 12 output digit arrays and
    the 12 integer sums the kernel reduces."""
    out, sums = [], []
    for k in range(12):
        comp = k & 1
        w = np.zeros((a[0].shape[0], 2 * NL), np.uint64)
        total = [0] * a[0].shape[0]
        for n, (i, j, fold) in enumerate(a_terms(k, mask)):
            if n:
                w32_fold(w)
            x0, x1 = a[2 * i], a[2 * i + 1]
            if fold:  # fp2_mul_xi_wide: (9 a0 + 2p - a1, a0 + 9 a1), carried
                v0, v1 = value(x0), value(x1)
                x0 = digits([9 * u + 2 * c.P - v for u, v in zip(v0, v1)])
                x1 = digits([u + 9 * v for u, v in zip(v0, v1)])
            y0 = b[2 * j + comp]
            y1 = model_neg(b[2 * j + 1]) if comp == 0 else b[2 * j]
            for x, y in ((x0, y0), (x1, y1)):
                w32_mac(w, x, y)
                total = [t + u * v for t, u, v in zip(total, value(x), value(y))]
        out.append(w32_reduce(w))
        sums.append(total)
    return out, sums


def exact_mont(t: int) -> int:
    """(t + m p) / R with m = -t p^-1 mod R: what any exact Montgomery
    reduction of the integer t gives."""
    m = (-t * pow(c.P, -1, R_MONT)) % R_MONT
    return (t + m * c.P) // R_MONT


@pytest.mark.parametrize("mask", [0x3F, 0x19, 0x2C, 0x01])
@pytest.mark.parametrize("kind", ["random", "two_p_minus_1", "settled"])
def test_fq12_mul_folded_columns_match_field_library(kind, mask):
    """Kernel A's 32-bit folded column sums for every component, dense, both
    line shapes and a one-slot mask: columns below 2^32 at every step; the
    digits those of the exact Montgomery reduction of the same integer sum
    (so of field.cuh's fq12_mul, which reduces that sum in 64-bit columns)
    and of F12.fq12_mul / fq12_mul_sparse after an exact carry."""
    from pairing_tpu_torch.fields import fp12 as TF12

    rng = np.random.default_rng({"random": 901, "two_p_minus_1": 902, "settled": 903}[kind] + mask)
    n = 8
    raw_a = [operand_limbs(rng, kind, n) for _ in range(12)]
    raw_b = [operand_limbs(rng, kind, n) for _ in range(12)]
    a = [digits(value(r)) for r in raw_a]
    b = [digits(value(r)) for r in raw_b]
    got, sums = model_fq12_mul(a, b, mask)
    for k in range(12):
        assert np.array_equal(got[k], digits([exact_mont(t) for t in sums[k]]))

    def fq12(raw):
        comps = [TF.Fp(torch.as_tensor(r, dtype=torch.int32), 2 * c.P, TF.SETTLED) for r in raw]
        return TF12.Fq12(tuple(TF2.Fp2(comps[2 * i], comps[2 * i + 1]) for i in range(6)))

    A, Bv = fq12(raw_a), fq12(raw_b)
    present = [j for j in range(6) if mask >> j & 1]
    want = (TF12.fq12_mul(A, Bv) if mask == 0x3F
            else TF12.fq12_mul_sparse(A, {j: Bv.s[j] for j in present}))
    for k in range(12):
        comp = want.s[k >> 1].c1 if k & 1 else want.s[k >> 1].c0
        assert np.array_equal(got[k], TF._ripple_carry(comp.limbs)[0].numpy().astype(np.uint64))
