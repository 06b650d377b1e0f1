"""Kernel B's arithmetic (``csrc/cyc_sq.cu``), modelled in numpy and held
against the field library and the oracle.

One thread per output component k = 2i + comp: the Fq2 terms of slot i's
sum T_i, read with their flags from ``B_TERMS`` / ``B_SLOTS`` in
``csrc/fq12_terms.cuh`` (shared with K18 and K15), summed into 32-bit
columns (a square term's x0^2 with ``w32_sq``), a carry-save fold between
terms, one reduction, then the linear tail 3T - 2s
(slots 0, 2, 4) or 3T + 2s (slots 1, 3, 5). The model must give
``fields.fp12.fq12_cyclotomic_sq`` (the kernel's plain version) value for
value on random and on cyclotomic inputs, and on cyclotomic ones the
oracle's square; every column stays below 2^32 at every step, also with
every operand digit at 2^13 - 1 and every reduction multiplier at its
largest. Nothing here compiles a JAX graph.
"""

import re

import numpy as np
import pytest
import torch

from pairing_tpu_torch.fields import fp12 as TF12
from pairing_tpu_torch.ops import fq12_kernels as FK
from pairing_tpu_torch.ops import klayout as KL
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.pairing.final_exp import easy_part_k
from pairing_tpu_torch.utils import bn254 as c
from test_torch_inv_kernels import (CSRC, NL, digits, exact_mont, model_neg, value,
                                    w32_fold, w32_mac, w32_reduce, w32_sq)

torch.set_num_threads(2)

ALL_MAX = np.uint64((1 << 13) - 1)


def b_tables(source: str = "fq12_terms.cuh", terms: str = "B_TERMS", slots: str = "B_SLOTS"):
    """A term table and its slots (kernel B's B_TERMS and B_SLOTS in
    fq12_terms.cuh by default), with the flag names of fq12_terms.cuh
    evaluated."""
    names = {}
    flags = (CSRC / "fq12_terms.cuh").read_text()
    for item in re.search(r"enum : uint8_t \{([^}]*)\}", flags).group(1).split(","):
        key, val = (t.strip() for t in item.split("="))
        names[key] = int(val)
    src = (CSRC / source).read_text()

    def entries(name):
        body = re.search(name + r"\[[^\]]*\] = \{(.*?)\};", src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body).replace("{", "(").replace("}", ",)")
        return eval("[" + body + "]", {}, names)

    return entries(terms), entries(slots), names


def flagged(x0, x1, flags, names):
    """x <- xi x (fp2_mul_xi_wide), then x <- 2 x, as flagged; carried."""
    if flags & names["B_FOLD"]:
        v0, v1 = value(x0), value(x1)
        x0 = digits([9 * u + 2 * c.P - v for u, v in zip(v0, v1)])
        x1 = digits([u + 9 * v for u, v in zip(v0, v1)])
    if flags & names["B_DBL"]:
        x0, x1 = digits([2 * v for v in value(x0)]), digits([2 * v for v in value(x1)])
    return x0, x1


def term_products(rows, t, comp, names, worst: bool):
    """The (x, y) digit pairs of component ``comp`` of term t; y is None
    where the kernel squares x (w32_sq_mac). ``worst``: every digit 2^13 - 1."""
    tx, ty, flags = t
    x0, x1 = rows[2 * tx], rows[2 * tx + 1]
    if flags & names["B_SQ"]:
        assert tx == ty and flags == names["B_SQ"]
        if worst:
            full = np.full_like(x0, ALL_MAX)
            return ([(full, None), (full, full)] if comp == 0 else [(full, full)])
        if comp == 0:  # x0^2 + x1 (2p - x1)
            return [(x0, None), (x1, model_neg(x1))]
        return [(digits([2 * v for v in value(x0)]), x1)]  # 2 x0 x1
    if worst:
        full = np.full_like(x0, ALL_MAX)
        return [(full, full), (full, full)]
    x0, x1 = flagged(x0, x1, flags, names)
    y0 = rows[2 * ty + comp]
    y1 = model_neg(rows[2 * ty + 1]) if comp == 0 else rows[2 * ty]
    return [(x0, y0), (x1, y1)]


def model_terms(rows, tables, worst: bool = False) -> list:
    """The threads of a term table (b_tables' triple) on carried digits
    rows[12] of [B, NL]: per component k = 2s + comp, slot s's terms summed
    into 32-bit columns with a fold between terms, then one reduction; the
    reduced digits and the integer sum the thread reduced."""
    terms, slots, names = tables
    res = []
    for k in range(12):
        first, count = slots[k >> 1]
        w = np.zeros((rows[0].shape[0], 2 * NL), np.uint64)
        total = [0] * rows[0].shape[0]
        for j in range(count):
            if j:
                w32_fold(w)
            for x, y in term_products(rows, terms[first + j], k & 1, names, worst):
                if y is None:
                    w += w32_sq(x)
                    assert (w < np.uint64(1 << 32)).all()
                    total = [t + u * u for t, u in zip(total, value(x))]
                else:
                    w32_mac(w, x, y)
                    total = [t + u * v for t, u, v in zip(total, value(x), value(y))]
        res.append((w32_reduce(w, m_max=worst), total))
    return res


def model_cyc_sq(rows, worst: bool = False):
    """Kernel B on carried digits rows[12] of [B, NL]: the 12 output digit
    arrays, and per component the integer sum its thread reduces."""
    out, sums = [], []
    for k, (r, total) in enumerate(model_terms(rows, b_tables(), worst)):
        if worst:
            continue
        i = k >> 1
        assert all(v < 2 * c.P for v in value(r))
        t3 = [3 * v for v in value(r)]  # small<3>: less 4p, then less 2p, where they fit
        t3 = [v - 4 * c.P if v >= 4 * c.P else v for v in t3]
        t3 = [v - 2 * c.P if v >= 2 * c.P else v for v in t3]
        s2 = [2 * v - 2 * c.P if 2 * v >= 2 * c.P else 2 * v for v in value(rows[k])]
        res = ([a + b for a, b in zip(t3, s2)] if i & 1
               else [a + 2 * c.P - b for a, b in zip(t3, s2)])
        out.append(digits([v - 2 * c.P if v >= 2 * c.P else v for v in res]))
        sums.append((total, r))
    return out, sums


def settled_operand(rng, lanes: int) -> torch.Tensor:
    """KF12 operands [12, 21, lanes] in the kernel envelope: random values
    below 2p with settled limbs, one lane of 2p - 1 in every component, one
    with limbs of 2^13 and 2^13 + 1."""
    gen = torch.Generator()
    gen.manual_seed(int(rng.integers(1 << 31)))
    a = FK.random_kf12((12,), lanes, gen)
    a[:, :, 0] = torch.as_tensor(digits([2 * c.P - 1] * 12).astype(np.int32))
    settled = rng.integers(0, 4000, (12, 21))
    settled[:, 0:19:2] = 8192 + rng.integers(0, 2, (12, 10))
    settled[:, 19], settled[:, 20] = rng.integers(0, 100, 12), 0  # the value stays below 2p
    a[:, :, 1] = torch.as_tensor(settled, dtype=torch.int32)
    assert FK.kf12_in_envelope(a)
    return a


def kernel_rows(a: torch.Tensor) -> list:
    """load_fp's carry of each component row [21, B] -> digits [B, NL]."""
    return [digits(value(a[k].T.numpy().astype(np.int64))) for k in range(12)]


def as_kf12(out) -> torch.Tensor:
    return torch.as_tensor(np.stack([d.T for d in out]).astype(np.int32))


@pytest.mark.parametrize("inputs", ["random", "cyclotomic"])
def test_cyc_sq_thread_model_matches_field_library(inputs):
    rng = np.random.default_rng({"random": 1201, "cyclotomic": 1202}[inputs])
    lanes = 5
    a = settled_operand(rng, lanes)
    if inputs == "cyclotomic":
        a = easy_part_k(a)
    got, sums = model_cyc_sq(kernel_rows(a))
    for total, r in sums:  # one exact Montgomery reduction of each sum
        assert value(r) == [exact_mont(t) for t in total]
    got = as_kf12(got)
    assert FK.kf12_in_envelope(got)
    assert torch.equal(FK.kf12_canonical(got), FK.kf12_canonical(KL.kcyc_sq_plain(a)))
    if inputs == "cyclotomic":  # on the subgroup: the square
        ints = lambda t: TF12.fq12_to_int_coeffs(FK.from_kernel_layout(t, (lanes,)))  # noqa: E731
        assert ints(got) == [o.pow_fq12(x, 2) for x in ints(a)]


def test_cyc_sq_columns_fit_at_all_maximal_digits():
    terms, slots, names = b_tables()
    assert [t for t in terms if t[2] & names["B_SQ"]] == [(0, 0, 4), (1, 1, 4), (2, 2, 4)]
    assert sum(count for _, count in slots) == len(terms)
    rows = [np.zeros((2, NL), np.uint64) for _ in range(12)]
    model_cyc_sq(rows, worst=True)  # every column below 2^32, asserted inside
