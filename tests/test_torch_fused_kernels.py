"""Kernels C, D and K12's plain versions against the JAX package and the oracle.

* Phase D: ``ops.fused_kernels.miller_f`` on CPU tensors (its plain
  version) over a short schedule (4 loop steps, 2 of them with a chord,
  then the 2 fused epilogue steps) with seeded random lines, against the
  JAX package's ``miller_loop._phase_d_scan`` followed by two
  ``fq12_mul_sparse`` calls (its XLA path).
* Phase D with K = 2 pairs per product and per-step collection: every
  collected row against the oracle's shared-square recurrence.
* The x-power ladder: ``pow_x_streamed`` on CPU tensors (kernels A, B and
  D all take their plain versions) against ``final_exp.pow_x_cyclotomic``
  through ``tests/data/torch_final_exp_fixture.npz``.
* The witness bit ladder (K12): a 5-bit exponent row by row, and the full
  ``BN_X_BITS_MSB`` on one lane, against the oracle.
* The plain-NAF ladder (K16) and the w4 ladder with its table in the kernel
  (K17) over short digit vectors with negative digits, against the oracle;
  their digit checks; the ladder digits and the hard-chain program (K15)
  against the JAX package's constants.
* The six-thread split of kernels C, D, K12, K16 and K17
  (``csrc/field_group.cuh``), modelled below: each rank's products and
  reductions apart, assembled as the kernel does, against ``fq12_mul`` / ``fq12_sq`` / ``fq12_mul_sparse``
  / ``fq12_cyclotomic_sq`` and the oracle; K12's steps on that model, row
  by row, limb for limb against its plain version; K16's and K17's
  schedules on that model (K17's table built by the split square and
  product, the conjugated row as odd-rank negation) limb for limb against
  their plain versions. K12's device bits, and K16's and K17's digits, are
  built once per (bits, device); K17's scratch spans whole blocks.
Exact (canonical) comparison; every output in the kernel envelope.
"""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from pairing_tpu.fields import fp as JF
from pairing_tpu.fields import fp2 as JF2
from pairing_tpu.fields import fp12 as JF12
from pairing_tpu.ops import fused_kernels as JFU
from pairing_tpu.pairing import miller_loop as JML
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields import fp2 as TF2
from pairing_tpu_torch.fields import fp12 as TF12
from pairing_tpu_torch.fields.fp2 import Fp2
from pairing_tpu_torch.fields.fp12 import Fq12
from pairing_tpu_torch.ops import fq12_kernels as FK
from pairing_tpu_torch.ops import fused_kernels as FU
from pairing_tpu_torch.ops import klayout as KL
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.utils import bn254 as c

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"
B = 3
RINV = pow(1 << 273, -1, c.P)


def j12_ints(a) -> list:
    """JAX Fq12 -> 12-int coefficient lists, converted on the host."""
    def vals(limbs):
        rows = np.asarray(limbs).reshape(-1, 21)
        return [int(sum(int(v) << (13 * i) for i, v in enumerate(r))) * RINV % c.P for r in rows]

    comps = [vals(s.c0.limbs) for s in a.s] + [vals(s.c1.limbs) for s in a.s]
    return [list(row) for row in zip(*comps)]


def port_ints(arr):
    assert FK.kf12_in_envelope(arr)
    return TF12.fq12_to_int_coeffs(FK.from_kernel_layout(arr, (arr.shape[-1],)))


def rand_line_limbs(rng, lead):
    """Montgomery limbs [*lead, 6, B, 21] of random Fq values (c0/c1 of 3 slots)."""
    n = int(np.prod(lead, dtype=np.int64)) * 6 * B
    vals = [int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(n)]
    arr = np.asarray(JF.fp_from_ints_mont(vals).limbs)
    return arr.reshape(tuple(lead) + (6, B, 21))


def jax_line(limbs):
    """[..., 6, B, 21] -> 3 JAX Fp2 with the (2p, settled) envelope."""
    return tuple(
        JF2.from_limbs((limbs[..., 2 * jj, :, :], limbs[..., 2 * jj + 1, :, :]))
        for jj in range(3)
    )


def port_line(limbs):
    """[..., 6, B, 21] -> port line block [..., 6, 21, B]."""
    return torch.as_tensor(np.ascontiguousarray(np.swapaxes(limbs, -1, -2)))


def test_phase_d_plain_matches_jax_scan():
    rng = np.random.default_rng(301)
    flags = [0, 1, 1, 0]
    tg = rand_line_limbs(rng, (4,))
    ch = rand_line_limbs(rng, (4,))  # JAX reads the steps with flag 1 only
    ep = rand_line_limbs(rng, (2,))

    tg_j = tuple(JF2.from_limbs((x.c0.limbs[:, None], x.c1.limbs[:, None])) for x in jax_line(tg))
    ch_j = tuple(JF2.from_limbs((x.c0.limbs[:, None], x.c1.limbs[:, None])) for x in jax_line(ch))
    f, _ = JML._phase_d_scan(tg_j, ch_j, np.asarray(flags, np.int32), 1, (B,), False)
    for e in (ep[0], ep[1]):
        f = JF12.fq12_mul_sparse(f, dict(zip((2, 3, 5), jax_line(e))))

    ch_rows = [-1, 0, 1, -1, -1, -1]
    got = FU.miller_f(port_line(tg), port_line(ch[[1, 2]]), port_line(ep),
                      flags + [2, 2], ch_rows)
    assert port_ints(got) == j12_ints(f)


def test_pow_x_streamed_plain_matches_jax():
    """Against the JAX package's pow_x_cyclotomic on two easy-part outputs,
    as ``tests/data/make_torch_final_exp_fixtures.py`` recorded it (no JAX
    compile here)."""
    data = np.load(DATA / "torch_final_exp_fixture.npz")
    coeffs = TF12.fq12_limbs_to_int_coeffs(data["easy_part"][2:])
    arr, _ = FK.to_kernel_layout(TF12.fq12_from_int_coeffs(coeffs, "cpu"))
    got = port_ints(FU.pow_x_streamed(arr))
    assert got == TF12.fq12_limbs_to_int_coeffs(data["pow_x_cyclotomic"][2:])
    assert got == [o.pow_fq12(x, c.BN_X) for x in coeffs]


def test_w4_digits_match_jax():
    assert FU.BN_X_W4_DIGITS.tolist() == JFU.BN_X_W4_DIGITS.tolist()
    value = 0
    for d in FU.BN_X_W4_DIGITS.tolist():
        value = 2 * value + d
    assert value == c.BN_X


@pytest.mark.parametrize("flags, rows", [
    ([0, 2, 1], [-1, -1, 0]),  # a flag-2 step before a loop step
    ([0, 3], [-1, -1]),  # unknown flag
    ([1, 2], [-1, -1]),  # chord flag without a chord row
])
def test_miller_schedule_rejects_bad_flags(flags, rows):
    with pytest.raises(ValueError):
        FU.miller_schedule(flags, rows)


def test_miller_schedule_rows():
    sched = FU.miller_schedule([0, 1, 0, 1, 2, 2], [-1, 3, -1, 7, -1, -1])
    assert sched.tolist() == [[0, 0], [1, 3], [0, 0], [1, 7], [2, 0], [2, 1]]


def _mont_rows(vals):
    """Python ints (values mod p) -> Montgomery limb rows [len, 21]."""
    return np.stack([TF.int_to_limbs(v * TF.R_MONT % c.P) for v in vals])


def test_miller_f_plain_k2_collect_matches_oracle_recurrence():
    """K = 2 pairs per product, per-step collection: every row of fs is the
    oracle's shared-square recurrence, and fs[-1] is the returned f."""
    rng = np.random.default_rng(303)
    K, lanes = 2, 2
    flags = [0, 1, 1, 0, 2, 2]
    ch_rows = [-1, 0, 1, -1, -1, -1]

    def lines(n):  # ints [n, K * lanes, 3 slots, 2] and kernel rows [n, 6, 21, K * lanes]
        vals = [[[[int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(2)]
                  for _ in range(3)] for _ in range(K * lanes)] for _ in range(n)]
        flat = [v for step in vals for col in step for slot in col for v in slot]
        limbs = _mont_rows(flat).reshape(n, K * lanes, 6, 21)
        return vals, torch.as_tensor(np.ascontiguousarray(limbs.transpose(0, 2, 3, 1)))

    tg_v, tg = lines(4)
    ch_v, ch = lines(2)
    ep_v, ep = lines(2)
    f, fs = FU.miller_f(tg, ch, ep, flags, ch_rows, n_pairs=K, collect=True)
    assert fs.shape == (len(flags), 12, 21, lanes)
    assert torch.equal(fs[-1], f)

    def sparse(slots, v):
        b = [None] * 6
        for s, x in zip(slots, v):
            b[s] = tuple(x)
        return b

    for b in range(lanes):
        want = o.fq12_one()
        for t, flag in enumerate(flags):
            if flag != 2:
                want = o.fq12_mul(want, want)
            for k in range(K):
                col = k * lanes + b
                if flag != 2:
                    want = o.sparse_fp12_multiply(want, sparse((0, 3, 4), tg_v[t][col]))
                if flag == 1:
                    want = o.sparse_fp12_multiply(want, sparse((2, 3, 5), ch_v[ch_rows[t]][col]))
                if flag == 2:
                    want = o.sparse_fp12_multiply(want, sparse((2, 3, 5), ep_v[t - 4][col]))
            assert port_ints(fs[t])[b] == want, (t, b)


def test_exp_bits_ladder_plain_rows_match_oracle():
    rng = np.random.default_rng(304)
    coeffs = [o.easy_part([int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)])
              for _ in range(2)]
    arr, _ = FK.to_kernel_layout(TF12.fq12_from_int_coeffs(coeffs, "cpu"))
    bits = [1, 0, 1, 1, 0]
    out, rows = FU.exp_bits_ladder(arr, bits)
    assert rows.shape == (5, 12, 21, 2) and torch.equal(out, rows[-1])
    e = 0
    for s, bit in enumerate(bits):
        e = 2 * e + bit
        assert port_ints(rows[s]) == [o.pow_fq12(x, e) for x in coeffs], s


def test_exp_bits_ladder_plain_full_bn_x_matches_oracle():
    assert FU.BN_X_BITS_MSB.tolist() == JFU.BN_X_BITS_MSB.tolist()
    rng = np.random.default_rng(305)
    x = o.easy_part([int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)])
    arr, _ = FK.to_kernel_layout(TF12.fq12_from_int_coeffs([x], "cpu"))
    out, rows = FU.exp_bits_ladder(arr, FU.BN_X_BITS_MSB)
    assert rows.shape[0] == 64
    assert port_ints(out) == [o.pow_fq12(x, c.BN_X)]


@pytest.mark.parametrize("bits", [[], [0, 2], [[1, 0]]])
def test_exp_bits_ladder_rejects_bad_bits(bits):
    with pytest.raises(ValueError):
        FU.exp_bits_ladder(torch.zeros((12, 21, 1), dtype=torch.int32), bits)


def test_ladder_and_chain_constants_match_jax():
    assert FU.BN_X_LADDER_DIGITS.tolist() == JFU.BN_X_LADDER_DIGITS.tolist()
    assert FU.HARD_CHAIN_PROG == JFU.HARD_CHAIN_PROG
    assert (FU.HARD_CHAIN_NREG, FU.HARD_CHAIN_OUT) == (JFU.HARD_CHAIN_NREG, JFU.HARD_CHAIN_OUT)
    assert (FU.OPC_MUL, FU.OPC_CYC, FU.OPC_CONJ, FU.OPC_F1, FU.OPC_F2, FU.OPC_F3) == (
        JFU.OPC_MUL, JFU.OPC_CYC, JFU.OPC_CONJ, JFU.OPC_F1, JFU.OPC_F2, JFU.OPC_F3)


def _digits_value(digits, start=0):
    e = start
    for d in digits:
        e = 2 * e + int(d)
    return e


@pytest.mark.parametrize("ladder", ["naf", "w4"])
def test_short_ladders_plain_match_oracle(ladder):
    """K16 and K17 over short digit vectors with negative digits, on
    cyclotomic-subgroup inputs (where conj(m) = m^-1)."""
    rng = np.random.default_rng(306)
    coeffs = [o.easy_part([int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)])
              for _ in range(2)]
    m, _ = FK.to_kernel_layout(TF12.fq12_from_int_coeffs(coeffs, "cpu"))
    if ladder == "naf":
        digits = [0, -1, 1, 0, -1]
        got, e = FU.pow_ladder(m, KL.kconj(m), digits), _digits_value(digits, 1)
    else:
        digits = [3, 0, -5, 0, 7, -1, 0, 1]
        got, e = FU.pow_ladder_w4(m, digits), _digits_value(digits)
    assert port_ints(got) == [o.pow_fq12(x, e) for x in coeffs]


@pytest.mark.parametrize("ladder, digits", [
    ("naf", [1, 2]), ("naf", [[1]]),
    ("w4", []), ("w4", [0, 1]), ("w4", [-1, 1]), ("w4", [1, 2]), ("w4", [1, 9]),
])
def test_ladders_reject_bad_digits(ladder, digits):
    m = torch.zeros((12, 21, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        if ladder == "naf":
            FU.pow_ladder(m, m, digits)
        else:
            FU.pow_ladder_w4(m, digits)


# ---------------------------------------------------------------------------
# The six-thread split of an Fq12 operation in kernels C and D
# (csrc/field_group.cuh), modelled with the field library: the kernels give
# each lane six threads, ranks s = 0..5; each rank's Fq products and
# Montgomery reductions are computed here on their own, then assembled the
# way the kernel assembles them. This checks the algebra of the partition
# only, not the kernels' schedule (their packed c0, lazy-sum selects,
# in-place scratch and barriers): the card tests hold the kernels themselves
# against miller_f_plain and pow_ladder_stream_plain.
#
# * dense product: rank s reduces the twelve-product sums of output slot s,
#   components c0 and c1;
# * dense square: rank s reduces the sums of output slot s over the
#   unordered slot pairs {i, j}, i + j = s mod 6, a cross pair doubled;
# * product by a line: rank s reduces the sums of output slot s over the
#   line's three present slots;
# * cyclotomic square: rank s = 2j + h squares component h of the Fq4 pair
#   (j, j + 3)'s x^2, y^2 and (x + y)^2, forms component h of the pair's two
#   Fq2 results after an exchange, then output slot s from one of those
#   results and input slot s.
# ---------------------------------------------------------------------------

GROUP = 6  # threads (ranks) per lane


def _term(x: Fp2, y: Fp2, comp: int) -> list:
    """The two Fq products of x * y's component ``comp``, unreduced: c0 =
    x0 y0 + x1 (-y1), c1 = x0 y1 + x1 y0."""
    ys = (y.c0, TF.fp_neg(y.c1)) if comp == 0 else (y.c1, y.c0)
    return [TF.mul_wide(x.c0, ys[0]), TF.mul_wide(x.c1, ys[1])]


def mul_rank(a: Fq12, b: Fq12, s: int, comp: int):
    """Rank s's component ``comp`` of slot s of a * b: over i, a_i (xi * a_i
    where i + j >= 6) times b_j for j = s - i mod 6, summed unreduced and
    reduced once."""
    terms = []
    for i in range(6):
        fold = i > s
        j = s - i + 6 if fold else s - i
        terms += _term(TF2.mul_w6(a.s[i]) if fold else a.s[i], b.s[j], comp)
    return TF.mont_reduce(functools.reduce(TF.wide_add, terms))


def fq12_mul_by_ranks(a: Fq12, b: Fq12) -> Fq12:
    """a * b assembled from the six ranks' reductions: rank s writes slot s."""
    return Fq12(tuple(Fp2(mul_rank(a, b, s, 0), mul_rank(a, b, s, 1)) for s in range(GROUP)))


def sq_rank(a: Fq12, s: int, comp: int):
    """Rank s's component ``comp`` of slot s of a^2: over the unordered
    pairs {i, j}, i <= j, i + j = s (mod 6) (four for even s, three for odd
    s), a_i (xi * a_i where i + j >= 6) doubled when i != j, times a_j;
    summed unreduced and reduced once."""
    pairs = [(i, (s - i) % 6) for i in range(6) if (s - i) % 6 >= i]
    assert len(pairs) == (3 if s & 1 else 4)
    terms = []
    for i, j in pairs:
        ai = TF2.mul_w6(a.s[i]) if i + j >= 6 else a.s[i]
        if i != j:
            ai = TF2.add(ai, ai)
        terms += _term(ai, a.s[j], comp)
    return TF.mont_reduce(functools.reduce(TF.wide_add, terms))


def fq12_sq_by_ranks(a: Fq12) -> Fq12:
    """a^2 assembled from the six ranks' reductions: rank s writes slot s."""
    return Fq12(tuple(Fp2(sq_rank(a, s, 0), sq_rank(a, s, 1)) for s in range(GROUP)))


def sparse_rank(a: Fq12, line: dict, s: int, comp: int):
    """Rank s's component ``comp`` of slot s of a * line ({slot j: Fp2},
    three slots): over the present j, a_i (xi * a_i where i + j >= 6) times
    line_j for i = s - j mod 6; summed unreduced and reduced once."""
    terms = []
    for j, lj in line.items():
        i = (s - j) % 6
        terms += _term(TF2.mul_w6(a.s[i]) if i + j >= 6 else a.s[i], lj, comp)
    return TF.mont_reduce(functools.reduce(TF.wide_add, terms))


def fq12_mul_sparse_by_ranks(a: Fq12, line: dict) -> Fq12:
    """a * line assembled from the six ranks' reductions."""
    return Fq12(tuple(Fp2(sparse_rank(a, line, s, 0), sparse_rank(a, line, s, 1))
                      for s in range(GROUP)))


def fp2_sq_part(x: Fp2, h: int):
    """Component h of x^2: (x0 + x1)(x0 - x1) for h = 0, (2 x0) x1 for h = 1."""
    if h == 0:
        return TF.mont_mul(TF.fp_add(x.c0, x.c1), TF.fp_sub(x.c0, x.c1))
    return TF.mont_mul(TF.fp_scale(x.c0, 2), x.c1)


def cyc_sq_pairs(a: Fq12) -> dict:
    """The first phase of the split square: {(j, which, h): Fp} for pair j,
    which 0 = x^2 + xi y^2 and 1 = (x + y)^2 - x^2 - y^2, component h; rank
    2j + h computes its three squares, and needs its partner's y^2 only."""
    out = {}
    for j in range(3):
        x, y = a.s[j], a.s[j + 3]
        y2 = Fp2(*(fp2_sq_part(y, h) for h in (0, 1)))
        x2 = [fp2_sq_part(x, h) for h in (0, 1)]
        sq3 = [fp2_sq_part(TF2.add(x, y), h) for h in (0, 1)]
        xy2 = TF2.mul_w6(y2)
        for h in (0, 1):
            y2h, xy2h = (y2.c0, xy2.c0) if h == 0 else (y2.c1, xy2.c1)
            out[j, 0, h] = TF.fp_add(x2[h], xy2h)
            out[j, 1, h] = TF.fp_sub(sq3[h], TF.fp_add(x2[h], y2h))
    return out


def cyc_sq_by_ranks(a: Fq12) -> Fq12:
    """The Granger-Scott square assembled as the kernel does: rank s forms
    slot s as 3 r - 2 a_s (s even, r = pair s/2's first result) or 3 r + 2
    a_s (s odd, r = the second result of pair 2, 0, 1 for s = 1, 3, 5; xi r
    for s = 1)."""
    res = cyc_sq_pairs(a)
    out = []
    for s in range(GROUP):
        odd = s & 1
        pair = ((s >> 1) + 2) % 3 if odd else s >> 1
        src = Fp2(res[pair, odd, 0], res[pair, odd, 1])
        if s == 1:
            src = TF2.mul_w6(src)
        t3, t2 = TF2.scale(src, 3), TF2.scale(a.s[s], 2)
        out.append(TF2.cap(TF2.add(t3, t2) if odd else TF2.sub(t3, t2)))
    return Fq12(tuple(out))


@pytest.mark.parametrize("op", ["mul", "cyc_sq", "sq", "sparse034", "sparse235"])
def test_six_rank_split_matches_field_library(op):
    """The kernels' partition of an Fq12 product, cyclotomic square, dense
    square and product by a line of either shape over six ranks per lane,
    on four seeded lanes (cyclotomic-subgroup inputs for the cyclotomic
    square), exactly against the field library and the oracle."""
    rng = np.random.default_rng(307)

    def coeffs():
        return [[int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)]
                for _ in range(4)]

    if op == "mul":
        xs, ys = coeffs(), coeffs()
        a, b = (TF12.fq12_from_int_coeffs(v, "cpu") for v in (xs, ys))
        got, want = fq12_mul_by_ranks(a, b), TF12.fq12_mul(a, b)
        oracle = [o.fq12_mul(x, y) for x, y in zip(xs, ys)]
    elif op == "cyc_sq":
        xs = [o.easy_part(x) for x in coeffs()]
        a = TF12.fq12_from_int_coeffs(xs, "cpu")
        got, want = cyc_sq_by_ranks(a), TF12.fq12_cyclotomic_sq(a)
        oracle = [o.fq12_mul(x, x) for x in xs]
    elif op == "sq":
        xs = coeffs()
        a = TF12.fq12_from_int_coeffs(xs, "cpu")
        got, want = fq12_sq_by_ranks(a), TF12.fq12_sq(a)
        oracle = [o.fq12_mul(x, x) for x in xs]
    else:
        slots = (0, 3, 4) if op == "sparse034" else (2, 3, 5)
        xs, ys = coeffs(), coeffs()
        ys = [[v if k % 6 in slots else 0 for k, v in enumerate(y)] for y in ys]  # c0s, c1s
        a, b = (TF12.fq12_from_int_coeffs(v, "cpu") for v in (xs, ys))
        line = {j: b.s[j] for j in slots}
        got, want = fq12_mul_sparse_by_ranks(a, line), TF12.fq12_mul_sparse(a, line)
        oracle = [o.fq12_mul(x, y) for x, y in zip(xs, ys)]
    assert TF12.fq12_to_int_coeffs(got) == TF12.fq12_to_int_coeffs(want) == oracle


def test_exp_bits_steps_by_ranks_match_plain():
    """Kernel K12's step sequence on the six-rank model: from one, each bit
    takes a split cyclotomic square and, on a set bit, a split dense product
    by x, and the row is taken after every step. Held limb for limb to
    ``exp_bits_ladder_plain`` on three easy-part outputs and a bit string
    with leading zeros, and the last row to the oracle."""
    rng = np.random.default_rng(309)
    xs = [o.easy_part([int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)])
          for _ in range(3)]
    x, _ = FK.to_kernel_layout(TF12.fq12_from_int_coeffs(xs, "cpu"))
    bits = [0, 0, 1, 1, 0, 1, 1, 1, 0, 0, 1]
    xv = FK.kf12_view(x)
    f = TF12.fq12_cap(TF12.fq12_one((len(xs),), "cpu"))
    rows = []
    for b in bits:
        f = cyc_sq_by_ranks(f)
        if b:
            f = fq12_mul_by_ranks(f, xv)
        rows.append(FK.kf12_from(f))
    got = torch.stack(rows)
    assert torch.equal(got, FU.exp_bits_ladder_plain(x, bits))
    e = int("".join(map(str, bits)), 2)
    assert port_ints(got[-1]) == [o.pow_fq12(v, e) for v in xs]


def test_exp_bits_table_built_once():
    """The wrapper's device bits are built once per (bits, device)."""
    cpu = torch.device("cpu")
    bits = tuple(int(b) for b in FU.BN_X_BITS_MSB)
    table = FU.device_table(bits, cpu)
    assert table.dtype == torch.int32 and table.tolist() == list(bits)
    assert FU.device_table(bits, cpu) is table
    assert FU.device_table((1, 0, 1), cpu) is not table


def test_miller_f_and_stream_ladder_take_cached_schedules(monkeypatch):
    """On the card path kernel C's and kernel D's (flag, row) schedules come
    from ``device_table``, built once per (schedule, device): every launch
    with one schedule gets the same tensor, equal to ``torch.as_tensor`` of
    the schedule. The launches are recorded here in place of the kernels,
    on CPU operands."""
    from pairing_tpu_torch.pairing.miller_loop import CHORD_ROWS, MILLER_FLAGS, N_ADDS, N_STEPS

    calls = []
    monkeypatch.setattr(FU.dispatch, "on_cuda", lambda *ts: True)
    for name in ("MILLER_F", "MILLER_F_MULTI", "MILLER_F_COLLECT", "POW_LADDER_STREAM"):
        monkeypatch.setattr(FU, name, lambda *args, name=name: calls.append((name, args)))
    stream = torch.zeros((4, 12, 21, 5), dtype=torch.int32)
    digits = FU.BN_X_W4_DIGITS
    rows = np.where(digits != 0, np.abs(digits) // 2, 0).astype(np.int32)
    for lanes, n_pairs, collect in ((3, 1, False), (5, 2, False), (5, 1, True)):
        cols = lanes * n_pairs
        tg, ch, ep = (torch.zeros((n, 6, 21, cols), dtype=torch.int32)
                      for n in (N_STEPS, N_ADDS, 2))
        FU.miller_f(tg, ch, ep, MILLER_FLAGS, CHORD_ROWS, n_pairs, collect)
        FU.pow_ladder_stream(stream, digits, rows)
    cpu = torch.device("cpu")
    sched_c = FU.miller_schedule(MILLER_FLAGS, CHORD_ROWS)
    sched_d = np.stack([(digits != 0).astype(np.int32), rows], axis=1)
    table_c = FU.device_table(tuple(map(tuple, sched_c.tolist())), cpu)
    table_d = FU.device_table(tuple(map(tuple, sched_d.tolist())), cpu)
    assert table_c.dtype == table_d.dtype == torch.int32
    assert torch.equal(table_c, torch.as_tensor(sched_c))
    assert torch.equal(table_d, torch.as_tensor(sched_d))
    assert [name for name, _ in calls] == ["MILLER_F", "POW_LADDER_STREAM", "MILLER_F_MULTI",
                                           "POW_LADDER_STREAM", "MILLER_F_COLLECT",
                                           "POW_LADDER_STREAM"]
    for name, args in calls:
        if name == "POW_LADDER_STREAM":
            assert args[1] is table_d and args[2] == len(digits)
        else:
            assert args[3] is table_c and args[4] == len(sched_c)


def test_device_table_is_one_tensor_per_key():
    """``dispatch.device_table``: the same tensor for a repeated key, another
    for another key or device; int32 of the key's shape."""
    from pairing_tpu_torch.ops import dispatch

    cpu = torch.device("cpu")
    key = ((0, 0), (1, 3), (2, 1))
    table = dispatch.device_table(key, cpu)
    assert table.dtype == torch.int32 and table.tolist() == [list(r) for r in key]
    assert dispatch.device_table(((0, 0), (1, 3), (2, 1)), cpu) is table
    assert dispatch.device_table(((0, 0), (1, 3), (2, 2)), cpu) is not table
    assert dispatch.device_table((-1, 0, 1), cpu).tolist() == [-1, 0, 1]


def _conj_by_ranks(a: Fq12) -> Fq12:
    """The conjugate as kernel K17 stages it: ranks 1, 3 and 5 negate their
    slot on load, ranks 0, 2 and 4 copy theirs."""
    return Fq12(tuple(TF2.cap(TF2.neg(x)) if s & 1 else x for s, x in enumerate(a.s)))


@pytest.mark.parametrize("ladder, digits", [
    ("naf", [0, -1, 1, 0, -1]), ("naf", [-1, 0, 0, 1, 1, 0, -1]),
    ("w4", [3, 0, -5, 0, 7, -1, 0, 1]), ("w4", [7, -7, 0, -3, 5, 0, -1, 3]),
])
def test_pow_ladder_steps_by_ranks_match_plain(ladder, digits):
    """Kernels K16 and K17's schedules on the six-rank model, limb for limb
    against ``pow_ladder_plain`` / ``pow_ladder_w4_plain`` on three
    easy-part outputs, and against the oracle. K16: f starts at m; per digit
    a split cyclotomic square and, on d = +1 or -1, a split dense product by
    the row m or mc. K17: m2 = m^2 by the split cyclotomic square, rows m^3,
    m^5, m^7 as m2 times the row before (rank s writes slot s of each), f
    starts at the top digit's entry with no square; per later digit a split
    square and, on a nonzero one, a split product by row |d| >> 1, its odd
    slots negated by their ranks for d < 0."""
    rng = np.random.default_rng(310)
    xs = [o.easy_part([int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)])
          for _ in range(3)]
    m, _ = FK.to_kernel_layout(TF12.fq12_from_int_coeffs(xs, "cpu"))
    mv = FK.kf12_view(m)
    if ladder == "naf":
        mc = KL.kconj(m)
        rows = {1: mv, -1: FK.kf12_view(mc)}
        f, e = mv, _digits_value(digits, 1)
        for d in digits:
            f = cyc_sq_by_ranks(f)
            if d:
                f = fq12_mul_by_ranks(f, rows[d])
        want = FU.pow_ladder_plain(m, mc, digits)
    else:
        m2 = cyc_sq_by_ranks(mv)
        rows = [mv]
        for _ in range(3):
            rows.append(fq12_mul_by_ranks(m2, rows[-1]))

        def entry(d):
            row = rows[abs(d) >> 1]
            return _conj_by_ranks(row) if d < 0 else row

        f, e = entry(digits[0]), _digits_value(digits)
        for d in digits[1:]:
            f = cyc_sq_by_ranks(f)
            if d:
                f = fq12_mul_by_ranks(f, entry(d))
        want = FU.pow_ladder_w4_plain(m, digits)
    got = FK.kf12_from(f)
    assert torch.equal(got, want)
    assert port_ints(got) == [o.pow_fq12(x, e) for x in xs]


def test_ladder_wrappers_take_cached_digits_and_size_k17_scratch(monkeypatch):
    """On the card path K16's and K17's digits, and kernel H's in both its
    modes, come from ``device_table``, built once per (digits, device), and
    K17's scratch table spans whole blocks of K17_BLOCK_LANES: the launches
    are recorded here in place of the kernels, on CPU operands."""
    from pairing_tpu_torch.curves.g2 import SUBGROUP_DIGITS
    from pairing_tpu_torch.ops import curve_kernels as CK
    from pairing_tpu_torch.pairing.miller_loop import STEP_DIGITS

    calls, h_calls = [], []
    monkeypatch.setattr(FU.dispatch, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(FU, "POW_LADDER", lambda *args: calls.append(("naf", args)))
    monkeypatch.setattr(FU, "POW_LADDER_W4", lambda *args: calls.append(("w4", args)))
    monkeypatch.setattr(CK, "TRAJECTORY", lambda *args: h_calls.append(("full", args)))
    monkeypatch.setattr(CK, "TRAJECTORY_END", lambda *args: h_calls.append(("end", args)))
    for lanes in (3, 41):
        m = torch.zeros((12, 21, lanes), dtype=torch.int32)
        FU.pow_ladder(m, m, FU.BN_X_LADDER_DIGITS)
        FU.pow_ladder_w4(m, FU.BN_X_W4_DIGITS)
        q = torch.zeros((4, 21, lanes), dtype=torch.int32)
        CK.trajectory(q, STEP_DIGITS)
        CK.trajectory_end(q, SUBGROUP_DIGITS)
    cpu = torch.device("cpu")
    miller_table = FU.device_table(tuple(STEP_DIGITS), cpu)
    sub_table = FU.device_table(tuple(SUBGROUP_DIGITS), cpu)
    assert miller_table.tolist() == list(STEP_DIGITS)
    assert sub_table.tolist() == list(SUBGROUP_DIGITS)
    assert [kind for kind, _ in h_calls] == ["full", "end"] * 2
    for (_, full), (_, end), lanes in zip(h_calls[::2], h_calls[1::2], (3, 41)):
        _, digits, n, tops, dbls, out, n_lanes = full
        assert digits is miller_table and n == len(STEP_DIGITS) and n_lanes == lanes
        assert tuple(tops.shape) == tuple(dbls.shape) == (n, 6, 21, lanes)
        assert tuple(out.shape) == (6, 21, lanes)
        _, digits, n, tops, dbls, out, n_lanes = end
        assert digits is sub_table and n == len(SUBGROUP_DIGITS) and n_lanes == lanes
        assert tops is None and dbls is None and tuple(out.shape) == (6, 21, lanes)
    naf_table = FU.device_table(tuple(FU.BN_X_LADDER_DIGITS.tolist()), cpu)
    w4_table = FU.device_table(tuple(FU.BN_X_W4_DIGITS.tolist()), cpu)
    assert naf_table.tolist() == FU.BN_X_LADDER_DIGITS.tolist() and naf_table.min() == -1
    assert w4_table.tolist() == FU.BN_X_W4_DIGITS.tolist() and w4_table.min() == -7
    assert [kind for kind, _ in calls] == ["naf", "w4"] * 2
    for (_, naf), (_, w4), lanes in zip(calls[::2], calls[1::2], (3, 41)):
        assert naf[2] is naf_table and naf[3] == len(naf_table) and naf[5] == lanes
        digits, n_digits, tab, cols, _, n = w4[1:]
        assert digits is w4_table and n_digits == len(w4_table) and n == lanes
        assert cols % FU.K17_BLOCK_LANES == 0 and cols - FU.K17_BLOCK_LANES < lanes <= cols
        assert tab.shape == (3, 12, 21, cols)


def test_pow_ladder_stream_plain_other_digits_matches_oracle():
    """Kernel D over the w = 4 digits of 0b101101110101 (a negative one
    among them), its table built by ``pow_x_table`` for those digits."""
    rng = np.random.default_rng(308)
    coeffs = [o.easy_part([int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)])
              for _ in range(2)]
    m, _ = FK.to_kernel_layout(TF12.fq12_from_int_coeffs(coeffs, "cpu"))
    e = 0b101101110101
    digits = FU.wnaf_msb(e, 4)
    assert (digits < 0).any()
    stream, rows = FU.pow_x_table(m, digits)
    got = FU.pow_ladder_stream(stream, digits, rows)
    assert port_ints(got) == [o.pow_fq12(x, e) for x in coeffs]
