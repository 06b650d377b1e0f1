"""Kernels E (``csrc/slotwise.cu``) and K13 (``csrc/affine_export.cu``):
their arithmetic modelled in numpy and held against the plain versions and
the oracle.

* E: the host fold of a slot program (``fold_program``, with the term table
  ``E_TERMS`` and the mode flags read from the source) into one table of
  per-component modes and constants below p, then one thread's columns: a
  copy or a negation of the row, or the flagged terms a[2i + j] K[k][j]
  summed into 32-bit columns and reduced once. For the conjugate and the
  powers 1, 2, 3, 6 and 11 the model must give ``klayout.slotwise_plain``
  (which ``tests/test_torch_klayout.py`` holds against the JAX package) and
  the oracle's ``frobenius_map`` value for value; every column stays below
  2^32, also at all-maximal digits.
* K13: zi^2 by complex squaring, then the three Karatsuba products on
  32-bit columns with the offset N p of ``kc_column`` (read from the
  source and derived again here): the model must give
  ``fq2_vm.affine_export_plain`` and the oracle's affine points; every
  column stays in [0, 2^32), at all-maximal digits above and at the
  envelope's largest a1 b1 below.
* The wrapper's segment form on CPU tensors equals the single tensor.

Nothing here compiles a JAX graph.
"""

import re

import numpy as np
import pytest
import torch

from pairing_tpu_torch.fields import fp12 as TF12
from pairing_tpu_torch.ops import fq12_kernels as FK
from pairing_tpu_torch.ops import fq2_vm as VM
from pairing_tpu_torch.ops import klayout as KL
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.utils import bn254 as c
from test_torch_cyc_kernels import as_kf12, kernel_rows, settled_operand
from test_torch_inv_kernels import (CSRC, NL, R_MONT, digits, exact_mont, model_neg, value,
                                    w32_mac, w32_reduce)

torch.set_num_threads(2)

ALL_MAX = (1 << 13) - 1
COLUMN_LIMIT = 1 << 32
RINV = pow(R_MONT, -1, c.P)


# ---------------------------------------------------------------------------
# E
# ---------------------------------------------------------------------------


def e_source():
    """E_TERMS [c][j] = (g, neg) and the mode flags of slot_table.cuh (kernel
    E's table and its folding, shared with K15)."""
    src = (CSRC / "slot_table.cuh").read_text()
    flags = {}
    for item in re.search(r"enum : uint32_t \{([^}]*)\}", src).group(1).split(","):
        key, val = (t.strip() for t in item.split("="))
        flags[key] = int(val)
    body = re.search(r"E_TERMS\[2\]\[2\] = (\{.*?\});", src, re.S).group(1)
    terms = eval(body.replace("{", "(").replace("}", ")"))
    return terms, flags


def fold(power):
    """fold_program on the wrapper's program: per component (mode, [K0, K1])."""
    terms, flags = e_source()
    ops, consts = KL._slot_prog(power)
    gs = [[int(sum(int(d) << (13 * l) for l, d in enumerate(consts[i, k]))) for k in range(2)]
          for i in range(6)]
    table = []
    for k in range(12):
        i, comp = k >> 1, k & 1
        op = int(ops[i])
        if not op & KL.MUL_CONST:
            table.append((flags["E_NEG"] if (op >> comp) & 1 else 0, [0, 0]))
            continue
        mode, ks = flags["E_MUL"], [0, 0]
        for j in range(2):
            g, neg = terms[comp][j]
            const = gs[i][g]
            assert const < c.P
            if const == 0:
                continue
            mode |= flags["E_T0"] << j
            ks[j] = c.P - const if neg != (op >> j) & 1 else const
        table.append((mode, ks))
    return table, flags


def model_slotwise(rows, power, worst: bool = False):
    """Kernel E on carried digits rows[12] of [B, NL]: the 12 output digit
    arrays. ``worst``: every operand and constant digit 2^13 - 1 and every
    reduction multiplier at its largest (columns only)."""
    table, flags = fold(power)
    out = []
    for k, (mode, ks) in enumerate(table):
        if not mode & flags["E_MUL"]:
            out.append(model_neg(rows[k]) if mode & flags["E_NEG"] else rows[k])
            continue
        lanes = rows[0].shape[0]
        w = np.zeros((lanes, 2 * NL), np.uint64)
        total = [0] * lanes
        for j in range(2):
            if not mode & (flags["E_T0"] << j):
                continue
            x = rows[2 * (k >> 1) + j]
            g = digits([ks[j]] * lanes)
            if worst:
                x = g = np.full_like(x, ALL_MAX)
            w32_mac(w, x, g)  # every column below 2^32, asserted inside
            total = [t + u * ks[j] for t, u in zip(total, value(x))]
        r = w32_reduce(w, m_max=worst)
        if not worst:
            assert value(r) == [exact_mont(t) for t in total]
            assert all(v < 2 * c.P for v in value(r))
        out.append(r)
    return out


@pytest.mark.parametrize("power", [None, 1, 2, 3, 6, 11])
def test_slotwise_thread_model_matches_plain_and_oracle(power):
    rng = np.random.default_rng(1300 + (power or 0))
    lanes = 4
    a = settled_operand(rng, lanes)
    got = as_kf12(model_slotwise(kernel_rows(a), power))
    assert FK.kf12_in_envelope(got)
    assert torch.equal(FK.kf12_canonical(got), FK.kf12_canonical(KL.slotwise_plain(a, power)))
    ints = lambda t: TF12.fq12_to_int_coeffs(FK.from_kernel_layout(t, (lanes,)))  # noqa: E731
    want = [o.fq12_conj(x) if power is None else o.frobenius_map(x, power) for x in ints(a)]
    assert ints(got) == want


def test_slotwise_fold_and_columns():
    terms, flags = e_source()
    # c0 = x0 g0 + x1 (-g1), c1 = x0 g1 + x1 g0 (pairing_tpu/ops/klayout.py:_slot_kernel)
    assert terms == (((0, 0), (1, 1)), ((1, 0), (0, 0)))
    table, _ = fold(2)  # p^2's constants are real: one term a component
    assert all(bin(mode).count("1") == 2 for mode, _ in table[2:])
    table, _ = fold(None)  # the conjugate: copies and negations only
    assert [mode for mode, _ in table] == [0, 0, 1, 1] * 3
    rows = [np.zeros((2, NL), np.uint64) for _ in range(12)]
    for power in (1, 2, 3):
        model_slotwise(rows, power, worst=True)  # every column below 2^32, asserted inside


# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------


def envelope_max():
    """Largest digits of a value below 2^255 (any value below 2p)."""
    return [ALL_MAX] * 19 + [255, 0]


def kc_derived():
    """kc_column's rule: columns of N p, each at least the largest column of
    a product of two values below 2^255, N the least such multiple of p."""
    m = envelope_max()
    low = [0] * (2 * NL)
    for i in range(NL):
        for j in range(NL):
            low[i + j] += m[i] * m[j]
    v = sum(x << (13 * i) for i, x in enumerate(low))
    d = -(-v // c.P) * c.P - v
    return [x + ((d >> (13 * i)) & ALL_MAX if i < NL else 0) for i, x in enumerate(low)]


def kc_source():
    src = (CSRC / "affine_export.cu").read_text()
    body = re.search(r"kc_column\(int i\) \{.*?= \{(.*?)\};", src, re.S).group(1)
    return [int(t.strip().rstrip("u")) for t in body.split(",")]


def columns(a, b):
    """Exact columns of a b for digits [B, NL] (int64)."""
    w = np.zeros((a.shape[0], 2 * NL), np.int64)
    for i in range(NL):
        w[:, i:i + NL] += a[:, i:i + 1].astype(np.int64) * b.astype(np.int64)
    return w


def reduce_checked(cols, m_max=False):
    cols = np.asarray(cols)
    assert (cols >= 0).all() and (cols < COLUMN_LIMIT).all()
    return w32_reduce(cols.astype(np.uint64), m_max=m_max)


def model_kara(a0, a1, b0, b1, kc, m_max=False):
    """fp2_mul_kara: c0 from u - v + N p, c1 from (a0 + a1)(b0 + b1) - u - v,
    the latter summed modulo 2^32 from -(u + v) as the kernel sums it."""
    u, v = columns(a0, b0), columns(a1, b1)
    c0 = u - v + np.asarray(kc, np.int64)
    wrapped = (-(u + v)) % COLUMN_LIMIT
    s, t = a0 + a1, b0 + b1
    for i in range(NL):
        wrapped[:, i:i + NL] = (wrapped[:, i:i + NL]
                                + s[:, i:i + 1].astype(np.int64) * t.astype(np.int64)
                                ) % COLUMN_LIMIT
    c1 = columns(a0, b1) + columns(a1, b0)
    assert np.array_equal(wrapped, c1)
    return reduce_checked(c0, m_max), reduce_checked(c1, m_max)


def model_sq(a0, a1):
    """fp2_sq32: (a0 + a1)(a0 - a1 + 2p), (2 a0) a1, each carried."""
    s = digits([x + y for x, y in zip(value(a0), value(a1))])
    d = digits([x + 2 * c.P - y for x, y in zip(value(a0), value(a1))])
    t = digits([2 * x for x in value(a0)])
    return reduce_checked(columns(s, d)), reduce_checked(columns(t, a1))


def model_affine_export(xy, zinv, kc):
    """Kernel K13 on [S, 4, 21, B] and [S, 2, 21, B]: the output [S, 4, 21, B]."""
    out = []
    for st in range(xy.shape[0]):
        rows = [digits(value(r.T.numpy().astype(np.int64))) for r in xy[st]]
        zi = [digits(value(r.T.numpy().astype(np.int64))) for r in zinv[st]]
        z2 = model_sq(*zi)
        x = model_kara(rows[0], rows[1], *z2, kc)
        z3 = model_kara(zi[0], zi[1], *z2, kc)
        y = model_kara(rows[2], rows[3], *z3, kc)
        for r in (*z2, *x, *z3, *y):
            assert all(v < 2 * c.P for v in value(r))
        out.append(np.stack([d.T for d in (*x, *y)]))
    return torch.as_tensor(np.stack(out).astype(np.int32))


def mont_rows(fq2s):
    """[S][B] Fq2 ints -> Montgomery component rows [S, 2, 21, B]."""
    limbs = [[[digits([v * R_MONT % c.P])[0] for v in x] for x in row] for row in fq2s]
    return torch.as_tensor(np.asarray(limbs, np.int32).transpose(0, 2, 3, 1).copy())


def test_affine_export_thread_model_matches_plain_and_oracle():
    rng = np.random.default_rng(1310)
    S, B = 3, 2

    def scalar():
        return int.from_bytes(rng.bytes(32), "little") % (c.R_SCALAR - 1) + 1

    pts = [[o.g2_mul((c.G2_GEN_X, c.G2_GEN_Y), scalar()) for _ in range(B)] for _ in range(S)]
    zs = [[(scalar(), scalar()) for _ in range(B)] for _ in range(S)]
    X = [[c.fq2_mul(pt[0], c.fq2_mul(z, z)) for pt, z in zip(r, zr)] for r, zr in zip(pts, zs)]
    Y = [[c.fq2_mul(pt[1], c.fq2_mul(z, c.fq2_mul(z, z))) for pt, z in zip(r, zr)]
         for r, zr in zip(pts, zs)]
    xy = torch.cat([mont_rows(X), mont_rows(Y)], dim=1)
    zinv = mont_rows([[c.fq2_inv(z) for z in zr] for zr in zs])
    got = model_affine_export(xy, zinv, kc_source())
    assert FK.kf12_in_envelope(got)
    assert torch.equal(FK.kf12_canonical(got), FK.kf12_canonical(VM.affine_export_plain(xy, zinv)))
    vals = got.permute(0, 3, 1, 2).numpy()
    for s in range(S):
        for b in range(B):
            ints = [int(sum(int(d) << (13 * l) for l, d in enumerate(comp))) * RINV % c.P
                    for comp in vals[s, b]]
            (x0, x1), (y0, y1) = pts[s][b]
            assert ints == [x0, x1, y0, y1]


def test_affine_export_thread_model_on_edge_operands():
    """Random operands in the envelope, lane 0 of 2p - 1 and lane 1 of settled
    limbs in every row: equal to the plain version."""
    gen = torch.Generator()
    gen.manual_seed(1311)
    xy, zinv = FK.random_kf12((2, 4), 3, gen), FK.random_kf12((2, 2), 3, gen)
    edge = settled_operand(np.random.default_rng(1312), 2)[:, :, :2]
    xy[:, :, :, :2] = edge[:4]
    zinv[:, :, :, :2] = edge[4:6]
    got = model_affine_export(xy, zinv, kc_source())
    assert FK.kf12_in_envelope(got)
    assert torch.equal(FK.kf12_canonical(got), FK.kf12_canonical(VM.affine_export_plain(xy, zinv)))


def test_affine_export_offset_and_columns_at_extreme_digits():
    kc = kc_source()
    assert kc == kc_derived()
    n_p = sum(x << (13 * i) for i, x in enumerate(kc))
    assert n_p % c.P == 0 and n_p < 1 << 510  # u - v + N p < 4 p^2 + N p < R p
    full = np.full((1, NL), ALL_MAX, np.uint64)
    zero = np.zeros((1, NL), np.uint64)
    env = np.asarray([envelope_max()], np.uint64)
    # above: u at all-maximal digits, v = 0; c1's a0 b1 + a1 b0 at all-maximal digits
    model_kara(full, zero, full, zero, kc, m_max=True)
    model_kara(full, full, full, full, kc, m_max=True)
    # below: u = 0, v at the envelope's largest digits: every column of c0 stays >= 0
    model_kara(zero, env, zero, env, kc, m_max=True)
    # the square's columns: one product of carried sums below 2^13 a digit
    reduce_checked(columns(full, full), m_max=True)


def test_affine_export_segments_match_single_tensor():
    gen = torch.Generator()
    gen.manual_seed(1313)
    tops, dbls = FK.random_kf12((3, 6), 2, gen), FK.random_kf12((2, 6), 2, gen)
    end, st91 = FK.random_kf12((6,), 2, gen), FK.random_kf12((6,), 2, gen)
    zinv = FK.random_kf12((7, 2), 2, gen)
    segs = (tops[:, 0:4], dbls[:, 0:4], end[None, 0:4], st91[None, 0:4])
    want = VM.affine_export(torch.cat(segs), zinv)
    assert torch.equal(VM.affine_export(segs, zinv), want)
    assert torch.equal(VM.affine_export(list(segs), zinv), want)
    with pytest.raises(ValueError):
        VM.affine_export(segs[:3], zinv)
    src = (CSRC / "affine_export.cu").read_text()
    assert f"K13_MAX_SEGS = {VM.MAX_SEGMENTS};" in src
