"""Kernel G's arithmetic (``csrc/fq12_inv.cu``, ``csrc/field32.cuh``),
modelled in numpy and held against the field library and the oracle.

* The chain's Fq square (``w32_sq``): each cross product once against the
  doubled digit. Its 32-bit columns must equal the full product's, and stay
  below 2^32 through the reduction, also at all-maximal digits with every
  reduction multiplier at its largest.
* The Fermat schedule: the words the kernel compiles in (read from
  ``field32.cuh``) must be ``fp_kernels.inverse_schedule()``'s, and the
  chain over them (``fp32_inv``, 4-bit windows; also a bit at a time, as
  ``tools/ig_variants.cu`` runs it), run with the field library's
  Montgomery product, must equal ``fields.fp.fp_pow_bits(x, P - 2)`` on
  canonical values, x = 0 included.
* ``k_fq2_inv`` (``csrc/fq2_inv.cu``): the norm's two squares in one set of
  columns with one reduction stay below 2^32, also at all-maximal digits
  with every reduction multiplier at its largest; the whole kernel (norm,
  the window chain, the two products, the second negated) must give
  ``fp_kernels.fp2_inv_plain`` and the oracle's inverse on canonical
  values, every output below 2p, zero for a zero lane and one for a one
  lane; on CPU tensors ``fp2_inv`` is its plain version, limb for limb.
* Kernel F's chain (``fp32_pow_w4``, the same window over any exponent's
  words, one word read a 32 bits), in exact Montgomery steps, must equal
  ``fp_kernels.fp_pow_bits_plain`` and the oracle for exponents from 1 to
  one longer than p, every output below 2p; e = 1 gives x itself.
* The tower's split into one thread per output component: the level and
  term tables of ``fq12_inv.cu`` (read from the source) run on 32-bit
  column sums, with a carry-save fold between terms and the window chain
  in exact Montgomery steps, must give ``fields.fp12.fq12_inv`` and the oracle's
  inverse on canonical values, every column below 2^32, every output in
  the kernel envelope; a zero lane gives zero and a one lane one.

Nothing here compiles a JAX graph.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields import fp12 as TF12
from pairing_tpu_torch.ops import fp_kernels as FPK
from pairing_tpu_torch.ops import fq12_kernels as FK
from pairing_tpu_torch.ops import klayout as KL
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.utils import bn254 as c

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parents[1] / "pairing_tpu_torch" / "csrc"
NL = TF.NLIMBS
RB = TF.RADIX_BITS
MASK = np.uint64(TF.MASK)
R_MONT = 1 << (NL * RB)
NP0 = (-pow(c.P, -1, 1 << RB)) % (1 << RB)
P_DIGITS = np.asarray(TF.int_to_limbs(c.P), np.uint64)
COLUMN_LIMIT = np.uint64(1 << 32)


def digits(vals) -> np.ndarray:
    """Ints in [0, 2^273) -> carried digits [B, NL] (what fp_carry leaves)."""
    return np.stack([TF.int_to_limbs(int(v)) for v in vals]).astype(np.uint64)


def value(d) -> list:
    return [TF.limbs_to_int(row) for row in np.asarray(d, dtype=object)]


def w32_mac(w, a, b) -> None:
    """w += a b for carried digits [B, NL], one limb row at a time."""
    assert (a < TF.RADIX).all() and (b < TF.RADIX).all()
    for i in range(NL):
        w[:, i:i + NL] += a[:, i:i + 1] * b
        assert (w < COLUMN_LIMIT).all()


def w32_sq_mac(w, a) -> None:
    """field32.cuh's w32_sq_mac: w += a^2, cross products against 2 a_i."""
    assert (a < TF.RADIX).all()
    for i in range(NL):
        d = a[:, i:i + 1] << np.uint64(1)
        w[:, 2 * i + 1:i + NL] += d * a[:, i + 1:]
        w[:, 2 * i] += a[:, i] * a[:, i]
        assert (w < COLUMN_LIMIT).all()


def w32_sq(a) -> np.ndarray:
    """field32.cuh's w32_sq: fresh columns of a^2."""
    w = np.zeros((a.shape[0], 2 * NL), np.uint64)
    w32_sq_mac(w, a)
    return w


def w32_fold(w) -> None:
    """Each column keeps its low 13 bits and passes the rest up, at once."""
    carry = w[:, :-1] >> np.uint64(RB)
    w[:, :-1] &= MASK
    w[:, 1:] += carry
    assert (w < COLUMN_LIMIT).all()


def w32_reduce(w, m_max: bool = False) -> np.ndarray:
    """w32_reduce(_imm): r = (t + m p) / R, digits [B, NL]. ``m_max`` takes
    every multiplier m at 2^13 - 1, a column bound above any real run."""
    for i in range(NL):
        m = np.full(w.shape[0], MASK) if m_max else (w[:, i] * np.uint64(NP0)) & MASK
        w[:, i:i + NL] += m[:, None] * P_DIGITS
        assert (w < COLUMN_LIMIT).all()
        w[:, i + 1] += w[:, i] >> np.uint64(RB)
        assert (w[:, i + 1] < COLUMN_LIMIT).all()
    r = np.zeros((w.shape[0], NL), np.uint64)
    carry = np.zeros(w.shape[0], np.uint64)
    for k in range(NL):
        s = w[:, NL + k] + carry
        assert (s < COLUMN_LIMIT).all()
        r[:, k] = s & MASK
        carry = s >> np.uint64(RB)
    return r


def exact_mont(t: int) -> int:
    """(t + m p) / R with m = -t p^-1 mod R: any exact Montgomery reduction."""
    m = (-t * pow(c.P, -1, R_MONT)) % R_MONT
    return (t + m * c.P) // R_MONT


def model_neg(b) -> np.ndarray:
    """fp_neg: 2p - b, less 2p where that is 2p."""
    return digits([(2 * c.P - v) % (2 * c.P) for v in value(b)])


def operand_digits(rng, kind: str, n: int) -> np.ndarray:
    """Carried digits [n, NL] of values below 2p: random, 2p - 1, or all 2^13 - 1
    (above 2p: the columns' worst case, not a field value)."""
    if kind == "all_max":
        return np.full((n, NL), TF.MASK, np.uint64)
    if kind == "two_p_minus_1":
        return digits([2 * c.P - 1] * n)
    return digits([int.from_bytes(rng.bytes(40), "little") % (2 * c.P) for _ in range(n)])


@pytest.mark.parametrize("kind", ["random", "two_p_minus_1", "all_max"])
def test_w32_sq_columns_match_product_and_fit(kind):
    rng = np.random.default_rng({"random": 1101, "two_p_minus_1": 1102, "all_max": 1103}[kind])
    a = operand_digits(rng, kind, 16)
    sq = w32_sq(a)
    full = np.zeros_like(sq)
    w32_mac(full, a, a)
    assert np.array_equal(sq, full)
    assert np.array_equal(sq[:, -1], np.zeros(16, np.uint64))  # column 41 takes nothing
    worst = w32_reduce(sq.copy(), m_max=True)  # every column below 2^32, asserted inside
    assert worst.shape == (16, NL)
    if kind != "all_max":  # a field value: the reduction is the exact Montgomery one
        got = w32_reduce(sq)
        assert value(got) == [exact_mont(v * v) for v in value(a)]
        assert all(v < 2 * c.P for v in value(got))


# ---------------------------------------------------------------------------
# The Fermat schedule of p - 2
# ---------------------------------------------------------------------------


def source_schedule() -> tuple:
    src = (CSRC / "field32.cuh").read_text()
    body = re.search(r"PM2_WORDS\[8\] = \{([^}]*)\}", src).group(1)
    words = tuple(int(w.strip().rstrip("u"), 16) for w in body.split(","))
    top = int(re.search(r"constexpr int PM2_TOP = (\d+);", src).group(1))
    return words, top


def bit(words, i: int) -> int:
    return (words[i >> 5] >> (i & 31)) & 1


def chain_bits(x, words, top, mul):
    """A square per bit below the leading one, a product by x per set bit."""
    r = x
    for i in range(top - 1, -1, -1):
        r = mul(r, r)
        if bit(words, i):
            r = mul(r, x)
    return r


def chain_w4(x, words, top, mul):
    """fp32_pow_w4's steps: a table of x^1..x^15, the entry of the top digit
    (at bit top & ~3), then four squares and a product by the digit's entry
    per lower digit; the word in hand is replaced when the chain crosses
    into the next word down."""
    tab = [None, x, mul(x, x)]
    for _ in range(3, 16):
        tab.append(mul(tab[-1], x))
    lead = top & ~3
    word = words[top >> 5]
    r = tab[(word >> (lead & 31)) & 15]
    for i in range(lead - 1, -1, -1):
        r = mul(r, r)
        if i & 31 == 31:
            word = words[i >> 5]
        if i & 3 == 0:
            d = (word >> (i & 31)) & 15
            if d:
                r = mul(r, tab[d])
    return r


def test_inverse_schedule_matches_source_and_fp_pow_bits():
    words, top = FPK.inverse_schedule()
    assert (words, top) == source_schedule()
    assert sum(w << (32 * k) for k, w in enumerate(words)) == c.P - 2 and top == 253
    assert sum(bit(words, i) for i in range(top)) == 109
    # the window chain starts at the top digit, bits 253-252 of p - 2
    assert top % 4 == 1 and (c.P - 2) >> (top - 1) == 3
    rng = np.random.default_rng(1111)
    vals = [0, 1, c.P - 1] + [int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(3)]
    x = TF.fp_from_ints_mont(vals, "cpu")
    want = TF.canonical(TF.fp_pow_bits(x, c.P - 2)).limbs
    mul = lambda u, v: TF._cap_2p(TF.mont_mul(u, v))  # noqa: E731
    for chain in (chain_bits, chain_w4):
        got = chain(x, words, top, mul)
        assert torch.equal(TF.canonical(got).limbs, want)
    rinv = pow(R_MONT, -1, c.P)
    assert [TF.limbs_to_int(r) * rinv % c.P for r in want.numpy()] == [
        pow(v, c.P - 2, c.P) for v in vals]


def long_exponent(bits: int, seed: int) -> int:
    """A seeded exponent whose leading one is bit ``bits`` - 1."""
    rng = np.random.default_rng(seed)
    return int.from_bytes(rng.bytes(bits // 8 + 1), "little") % (1 << (bits - 1)) | (
        1 << (bits - 1))


#: Kernel F's exponents: the short ones (e = 1 and e < 16 are the top digit
#: alone), one digit and the next, a 7-bit one, p - 2, one longer than p, and
#: one longer than the kernel's parameter holds (from device memory).
F_EXPONENTS = {"1": 1, "2": 2, "15": 15, "16": 16, "17": 17, "0b1011001": 0b1011001,
               "p-2": c.P - 2, "300-bit": long_exponent(300, 1130),
               "600-bit": long_exponent(600, 1140)}


@pytest.mark.parametrize("name", list(F_EXPONENTS))
def test_kernel_f_window_chain_matches_plain_and_oracle(name):
    e = F_EXPONENTS[name]
    words, top = FPK.words_of(e)
    assert sum(w << (32 * k) for k, w in enumerate(words)) == e and top == e.bit_length() - 1
    rng = np.random.default_rng(1131)
    one = R_MONT % c.P  # Montgomery one
    xs = [0, one, c.P - 1, 2 * c.P - 1] + [int.from_bytes(rng.bytes(40), "little") % (2 * c.P)
                                           for _ in range(4)]
    got = [chain_w4(x, words, top, lambda u, v: exact_mont(u * v)) for x in xs]
    assert all(g < 2 * c.P for g in got)
    if e == 1:
        assert got == xs
    assert got[0] == 0 and got[1] % c.P == one
    arr = torch.as_tensor(np.ascontiguousarray(digits(xs).T.astype(np.int32)))  # [21, B]
    want = FPK.fp_pow_bits_plain(arr, e)
    assert FK.kf12_in_envelope(want)
    assert [g % c.P for g in got] == value(FK.kf12_canonical(want).T.numpy().astype(np.uint64))
    rinv = pow(R_MONT, -1, c.P)
    assert [g * rinv % c.P for g in got] == [pow(x * rinv % c.P, e, c.P) for x in xs]


# ---------------------------------------------------------------------------
# k_fq2_inv: Phase N's Fq2 inverse, one thread a lane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "two_p_minus_1", "all_max"])
def test_fq2_inv_norm_columns_fit(kind):
    """Two squares in one Wide32 (w32_sq_mac twice) and w32_reduce_imm's
    terms: every column below 2^32, the reduction the exact Montgomery one
    of c0^2 + c1^2 on field values."""
    rng = np.random.default_rng({"random": 1151, "two_p_minus_1": 1152, "all_max": 1153}[kind])
    c0, c1 = operand_digits(rng, kind, 16), operand_digits(rng, kind, 16)
    w = np.zeros((16, 2 * NL), np.uint64)
    w32_sq_mac(w, c0)
    w32_sq_mac(w, c1)  # each column checked against 2^32 inside
    assert np.array_equal(w, w32_sq(c0) + w32_sq(c1))
    w32_reduce(w.copy(), m_max=True)  # every column below 2^32, asserted inside
    if kind != "all_max":
        got = w32_reduce(w)
        assert value(got) == [exact_mont(u * u + v * v) for u, v in zip(value(c0), value(c1))]
        assert all(v < 2 * c.P for v in value(got))


def model_fq2_inv(c0: list, c1: list) -> tuple:
    """k_fq2_inv on values below 2p in exact Montgomery steps: the norm, the
    window chain over p - 2's words, c0 ninv and 2p - c1 ninv reduced below 2p."""
    words, top = source_schedule()
    mul = lambda u, v: exact_mont(u * v)  # noqa: E731
    ninv = [chain_w4(exact_mont(u * u + v * v), words, top, mul) for u, v in zip(c0, c1)]
    return ([mul(u, n) for u, n in zip(c0, ninv)],
            [(2 * c.P - mul(v, n)) % (2 * c.P) for v, n in zip(c1, ninv)])


def fq2_edge_total(lanes: int, seed: int) -> torch.Tensor:
    """Fq2 rows [2, NL, lanes] in the (2p, settled) envelope: lane 0 zero,
    lane 1 one (Montgomery R, 0), lane 2 values 2p - 1, the rest random."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    t = FK.random_kf12((2,), lanes, gen)
    edges = [(0, 0), (R_MONT % c.P, 0), (2 * c.P - 1, 2 * c.P - 1)]
    for lane, vals in enumerate(edges[:lanes]):
        for k, v in enumerate(vals):
            t[k, :, lane] = torch.as_tensor(TF.int_to_limbs(v))
    return t


def test_fq2_inv_kernel_model_matches_plain_and_oracle():
    t = fq2_edge_total(7, 1161)
    c0, c1 = (value(t[k].T.numpy().astype(np.int64)) for k in range(2))
    g0, g1 = model_fq2_inv(c0, c1)
    assert all(v < 2 * c.P for v in g0 + g1)
    want = FK.kf12_canonical(FPK.fp2_inv_plain(t))  # [2, NL, lanes]
    assert [[g % c.P for g in gs] for gs in (g0, g1)] == [
        value(want[k].T.numpy().astype(np.uint64)) for k in range(2)]
    rinv = pow(R_MONT, -1, c.P)
    for lane, (u, v, x, y) in enumerate(zip(c0, c1, g0, g1)):
        a = (u * rinv % c.P, v * rinv % c.P)
        got = (x * rinv % c.P, y * rinv % c.P)
        if lane == 0:
            assert got == (0, 0)
        else:
            assert got == o.fq2_inv(a)
    assert (g0[1] % c.P, g1[1] % c.P) == (R_MONT % c.P, 0)  # one stays one


@pytest.mark.parametrize("lanes", [1, 33])
def test_fp2_inv_on_cpu_is_the_field_library_inverse(lanes):
    from pairing_tpu_torch.fields import fp2 as TF2
    from pairing_tpu_torch.ops.fq12_kernels import kfp2_view, kstack

    t = fq2_edge_total(lanes, 1170 + lanes)
    inv = TF2.inv(kfp2_view(t), FPK.fp_inv)
    assert torch.equal(FPK.fp2_inv(t), kstack([inv.c0, inv.c1]))


# ---------------------------------------------------------------------------
# Kernel G's split, one thread per output component
# ---------------------------------------------------------------------------

FLAGS = {"FOLD": 1, "DBL": 2, "NEG0": 4, "NEG1": 8, "NEG": 12}


def g_tables():
    """G_TERMS and G_LEVELS of fq12_inv.cu, with its enum names evaluated."""
    src = (CSRC / "fq12_inv.cu").read_text()
    names = dict(FLAGS)
    for enum in re.findall(r"enum : uint8_t \{([^}]*)\}", src):
        for item in enum.split(","):
            key, val = (t.strip() for t in item.split("="))
            names[key] = eval(val, {}, dict(names))
    names["NONE"] = 0xFF

    def entries(name):
        body = re.search(name + r"\[[^\]]*\] = \{(.*?)\n\};", src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body).replace("{", "(").replace("}", ",)")
        return eval("[" + body + "]", {}, names)

    terms = entries("G_TERMS")
    levels = [(w, [tuple(s) for s in slots]) for w, slots in entries("G_LEVELS")]
    return terms, levels, names


def model_level(rows, terms, level, names, out) -> None:
    """One level: each component k < width sums its slot's terms as the
    kernel's mac_term / run_level do and reduces; rows [row] -> digits."""
    width, slots = level
    results = {}
    for k in range(width):
        first, count, srow, grow = slots[k >> 1]
        comp = k & 1
        w = np.zeros((rows[0].shape[0], 2 * NL), np.uint64)
        for i in range(count):
            if i:
                w32_fold(w)
            tx, ty, flags = terms[first + i]
            x0, x1 = rows[2 * tx], rows[2 * tx + 1]
            if flags & FLAGS["FOLD"]:
                v0, v1 = value(x0), value(x1)
                x0 = digits([9 * u + 2 * c.P - v for u, v in zip(v0, v1)])
                x1 = digits([u + 9 * v for u, v in zip(v0, v1)])
            if flags & FLAGS["DBL"]:
                x0, x1 = digits([2 * v for v in value(x0)]), digits([2 * v for v in value(x1)])
            neg_a = flags & (FLAGS["NEG1"] if comp else FLAGS["NEG0"])
            neg_b = (flags & FLAGS["NEG0"]) if comp else not flags & FLAGS["NEG1"]
            ya, yb = rows[2 * ty + comp], rows[2 * ty + 1 - comp]
            w32_mac(w, x0, model_neg(ya) if neg_a else ya)
            w32_mac(w, x1, model_neg(yb) if neg_b else yb)
        r = w32_reduce(w)
        assert all(v < 2 * c.P for v in value(r))
        results[k] = (r, srow, grow)
    for k, (r, srow, grow) in results.items():
        if srow != names["NONE"]:
            rows[srow + (k & 1)] = r
        if grow != names["NONE"]:
            out[grow + (k & 1)] = r


def model_fq12_inv(a: np.ndarray) -> np.ndarray:
    """Kernel G's three stages on carried digits a [12, B, NL]."""
    terms, levels, names = g_tables()
    n_norm = 4
    rows = {r: a[r] for r in range(12)}
    rows[names["R_ZERO"]] = np.zeros_like(a[0])
    scratch = {}
    for level in levels[:n_norm]:
        model_level(rows, terms, level, names, scratch)
    assert sorted(scratch) == list(range(9))  # t, n, N
    assert all(np.array_equal(rows[2 * names["S_T"] + i], scratch[names["SC_T"] + i])
               for i in range(6))
    words, top = source_schedule()
    mul = lambda u, v: exact_mont(u * v)  # noqa: E731  (the chain's digits exactly)
    rows[names["R_NN"]] = digits([chain_w4(x, words, top, mul)
                                  for x in value(scratch[names["SC_NN"]])])
    out = {}
    for level in levels[n_norm:]:
        model_level(rows, terms, level, names, out)
    assert sorted(out) == list(range(12))
    return np.stack([out[k] for k in range(12)])


def test_fq12_inv_split_matches_field_library_and_oracle():
    gen = torch.Generator()
    gen.manual_seed(1121)
    lanes = 6
    arr = FK.random_kf12((12,), lanes, gen)  # settled limbs and values in [p, 2p)
    arr[..., 0] = 0  # a zero lane
    arr[..., 1] = 0  # a one lane
    arr[0, :, 1] = torch.as_tensor(TF.int_to_limbs(R_MONT % c.P))
    arr[:, :, 2] = torch.as_tensor(TF.int_to_limbs(2 * c.P - 1))  # every value 2p - 1
    a = np.stack([digits(value(arr[k].T.numpy().astype(np.int64))) for k in range(12)])
    got = torch.as_tensor(np.ascontiguousarray(model_fq12_inv(a).transpose(0, 2, 1))
                          .astype(np.int32))  # [12, NL, B]
    assert FK.kf12_in_envelope(got)
    assert torch.equal(FK.kf12_canonical(got), FK.kf12_canonical(KL.kinv_plain(arr)))
    ints = lambda t: TF12.fq12_to_int_coeffs(FK.from_kernel_layout(t, (lanes,)))  # noqa: E731
    coeffs, inv = ints(arr), ints(got)
    assert inv[0] == [0] * 12 and inv[1] == coeffs[1] == [1] + [0] * 11
    assert inv[1:] == [o.fq12_inv(x) for x in coeffs[1:]]
