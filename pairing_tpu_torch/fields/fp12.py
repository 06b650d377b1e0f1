"""Batched Fq12 in the halo2-lib coefficient basis.

PyTorch counterpart of ``pairing_tpu/fields/fp12.py``. An element is
``sum_{i=0..5} (c_i + c_{i+6} u) w^i`` with ``w^6 = xi = 9+u``, stored as
6 :class:`Fp2` slots. Every (sparse or dense) product is ONE gathered limb
product over a stacked term tensor ``[T, ..., NLIMBS]``, a segment sum into
the 12 output coefficients and one stacked Montgomery reduction; the xi-fold
of high powers is absorbed by pre-multiplying the LHS slots with xi, so the
accumulation stays additive. The same static term tables as the reference.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..utils.bn254 import P, frob_coeff_pow
from . import fp as F
from . import fp2 as F2
from .fp import Fp, WideAcc
from .fp2 import Fp2

#: Sparse slot patterns of the two line shapes.
LINE_EQUAL_SLOTS = (0, 3, 4)  # tangent "034"
LINE_UNEQUAL_SLOTS = (2, 3, 5)  # chord "235"


@dataclasses.dataclass
class Fq12:
    """6 Fp2 slots, coefficient basis."""

    s: Tuple[Fp2, ...]

    @property
    def batch_shape(self):
        return self.s[0].batch_shape

    @property
    def device(self):
        return self.s[0].device


# ---------------------------------------------------------------------------
# Construction / conversion
# ---------------------------------------------------------------------------


def fq12_one(batch_shape: Tuple[int, ...], device) -> Fq12:
    slots = [F2.one_mont(batch_shape, device)]
    slots += [F2.zero(batch_shape, device) for _ in range(5)]
    return Fq12(tuple(slots))


def fq12_from_int_coeffs(coeffs_batch: Sequence[Sequence[int]], device) -> Fq12:
    """[[12 ints], ...] (reference MyFq12.coeffs layout) -> Fq12 batch."""
    assert all(len(row) == 12 for row in coeffs_batch)
    slots = []
    for i in range(6):
        slots.append(
            F2.fp2_stack_from_ints(
                [(row[i], row[i + 6]) for row in coeffs_batch], device
            )
        )
    return Fq12(tuple(slots))


def fq12_to_canonical_limbs(a: Fq12) -> torch.Tensor:
    """Canonical export: int32 ``[*batch, 12, NLIMBS]``; row ``i`` (``i+6``)
    is the fully reduced, non-Montgomery limb vector of slot ``i``'s c0
    (c1), the coefficient order of :func:`fq12_to_int_coeffs`."""
    comps = [F.canonical(F.from_mont(a.s[i].c0)).limbs for i in range(6)]
    comps += [F.canonical(F.from_mont(a.s[i].c1)).limbs for i in range(6)]
    return torch.stack(torch.broadcast_tensors(*comps), dim=-2)


def fq12_limbs_to_int_coeffs(arr) -> list:
    """Canonical limb array ``[*batch, 12, NLIMBS]`` -> 12-int lists."""
    a = np.asarray(arr).astype(object)
    weights = np.array(
        [1 << (F.RADIX_BITS * i) for i in range(F.NLIMBS)], dtype=object
    )
    vals = (a * weights).sum(axis=-1) % P
    return [[int(v) for v in row] for row in vals.reshape(-1, 12)]


def fq12_to_int_coeffs(a: Fq12) -> list:
    """Fq12 batch -> list of 12-int coefficient lists (canonical, non-mont)."""
    return fq12_limbs_to_int_coeffs(fq12_to_canonical_limbs(a).cpu().numpy())


def fq12_from_sparse(slots: Dict[int, Fp2], batch_shape, device) -> Fq12:
    """Embed sparse Fq2 slots (e.g. a line function) into a full Fq12."""
    full = []
    for i in range(6):
        full.append(slots[i] if i in slots else F2.zero(batch_shape, device))
    return Fq12(tuple(full))


# ---------------------------------------------------------------------------
# Cheap coefficient-wise ops
# ---------------------------------------------------------------------------


def conjugate(a: Fq12) -> Fq12:
    """Negate odd powers of w; equals the q^6-Frobenius, and the inverse on
    the cyclotomic unit subgroup."""
    return Fq12(tuple(s if i % 2 == 0 else F2.neg(s) for i, s in enumerate(a.s)))


def fq12_select(mask, a: Fq12, b: Fq12) -> Fq12:
    return Fq12(tuple(F2.select(mask, x, y) for x, y in zip(a.s, b.s)))


def fq12_eq(a: Fq12, b: Fq12):
    """Equality mod p of every coefficient: bool [...]; one launch of
    ``k_canonical``'s compare mode (12 pairs) on CUDA tensors."""
    from ..ops.canon_kernels import all_equal

    return all_equal([pair for x, y in zip(a.s, b.s) for pair in ((x.c0, y.c0), (x.c1, y.c1))])


# ---------------------------------------------------------------------------
# The gathered multiply
# ---------------------------------------------------------------------------

# LHS vocabulary rows (per slot i): 4 entries
#   4*i + 0: a.c0[i]      4*i + 1: a.c1[i]
#   4*i + 2: (xi*a).c0[i] 4*i + 3: (xi*a).c1[i]
# RHS vocabulary rows (per present slot j, built densely over the pattern):
#   3*jj + 0: b.c0[j]     3*jj + 1: b.c1[j]    3*jj + 2: -b.c1[j]


@lru_cache(maxsize=None)
def _term_table(present: Tuple[int, ...]):
    """Static term list for multiplying by an operand with ``present`` slots.

    Returns (lhs_idx, rhs_idx, seg, terms_per_seg); seg is
    2*out_slot + component.
    """
    lhs_idx, rhs_idx, seg = [], [], []
    terms_per_seg = np.zeros((12,), dtype=np.int64)
    for i in range(6):
        for jj, j in enumerate(present):
            k = i + j
            hi = k >= 6
            out_slot = k - 6 if hi else k
            base = 4 * i + (2 if hi else 0)
            # c0 component: a.c0*b.c0 + a.c1*(-b.c1)
            lhs_idx += [base + 0, base + 1]
            rhs_idx += [3 * jj + 0, 3 * jj + 2]
            seg += [2 * out_slot + 0] * 2
            # c1 component: a.c0*b.c1 + a.c1*b.c0
            lhs_idx += [base + 0, base + 1]
            rhs_idx += [3 * jj + 1, 3 * jj + 0]
            seg += [2 * out_slot + 1] * 2
            terms_per_seg[2 * out_slot + 0] += 2
            terms_per_seg[2 * out_slot + 1] += 2
    return (
        np.asarray(lhs_idx, dtype=np.int64),
        np.asarray(rhs_idx, dtype=np.int64),
        np.asarray(seg, dtype=np.int64),
        terms_per_seg,
    )


_PREP_BOUND = 1 << 257


def _prep(x: Fp) -> Fp:
    if x.limb_bound > F.SETTLED:
        x = Fp(F.quasi_carry(x.limbs, x.limb_bound), x.bound, F.SETTLED)
    if x.bound > _PREP_BOUND:
        x = F.weak_reduce(x)
    return x


def _stack(limbs: list) -> torch.Tensor:
    return torch.stack(torch.broadcast_tensors(*limbs))


def _mul_gathered(a: Fq12, b_slots: Dict[int, Fp2]) -> Fq12:
    present = tuple(sorted(b_slots.keys()))
    lhs_idx, rhs_idx, seg, terms_per_seg = _term_table(present)

    lhs_vocab: list = []
    for i in range(6):
        axi = F2.mul_w6(a.s[i])
        lhs_vocab += [a.s[i].c0, a.s[i].c1, axi.c0, axi.c1]
    lhs_vocab = [_prep(x) for x in lhs_vocab]

    rhs_vocab: list = []
    for j in present:
        bj = b_slots[j]
        rhs_vocab += [bj.c0, bj.c1, F.fp_neg(bj.c1)]
    rhs_vocab = [_prep(x) for x in rhs_vocab]

    seg_val_bound = [0] * 12
    for li, ri, s in zip(lhs_idx, rhs_idx, seg):
        seg_val_bound[s] += lhs_vocab[li].bound * rhs_vocab[ri].bound
    max_val_bound = max(seg_val_bound)
    assert max_val_bound <= F.R_MONT * P * 16, "fq12 accumulation overflow"

    dev = a.device
    lhs_arr = _stack([x.limbs for x in lhs_vocab])  # [24, ..., L]
    rhs_arr = _stack([x.limbs for x in rhs_vocab])  # [3 * len(present), ..., L]
    lhs = lhs_arr[torch.as_tensor(lhs_idx, device=dev)]  # [T, ..., L]
    rhs = rhs_arr[torch.as_tensor(rhs_idx, device=dev)]

    raw = F._mul_wide_raw(lhs, rhs, F.WIDE_NLIMBS)
    carried = F.quasi_carry(raw, F.NLIMBS * F.SETTLED * F.SETTLED)
    acc = torch.zeros((12,) + carried.shape[1:], dtype=F.DTYPE, device=dev)
    acc.index_add_(0, torch.as_tensor(seg, device=dev), carried)

    wide = WideAcc(acc, val_bound=max_val_bound,
                   limb_bound=int(terms_per_seg.max()) * F.SETTLED)
    out = F.mont_reduce(wide)  # stacked [12, ..., L]

    slots = []
    for i in range(6):
        c0 = Fp(out.limbs[2 * i + 0], out.bound, out.limb_bound)
        c1 = Fp(out.limbs[2 * i + 1], out.bound, out.limb_bound)
        slots.append(Fp2(c0, c1))
    return Fq12(tuple(slots))


def fq12_mul(a: Fq12, b: Fq12) -> Fq12:
    """Dense product; 144 limb-products, 12 Montgomery reductions."""
    return _mul_gathered(a, {i: b.s[i] for i in range(6)})


def fq12_sq(a: Fq12) -> Fq12:
    return fq12_mul(a, a)


def fq12_mul_sparse(a: Fq12, slots: Dict[int, Fp2]) -> Fq12:
    """Multiply by a 034/235-shaped line without materializing the zero
    slots (sparse_fp12_multiply, miller_loop_native.rs:46-96)."""
    return _mul_gathered(a, slots)


def fq12_cyclotomic_sq(a: Fq12) -> Fq12:
    """Granger-Scott squaring for unit-norm elements. Valid exactly on the
    cyclotomic subgroup (post easy-part); value-identical to fq12_sq there.
    Uses the Fq4 decomposition g_i = slot_i + slot_{i+3} w^3, (w^3)^2 = xi."""
    s = a.s

    def fq4_sq(x: Fp2, y: Fp2):
        x2 = F2.square(x)
        y2 = F2.square(y)
        cross = F2.sub(F2.square(F2.add(x, y)), F2.add(x2, y2))
        return F2.add(x2, F2.mul_w6(y2)), cross

    A0, A1 = fq4_sq(s[0], s[3])
    B0, B1 = fq4_sq(s[1], s[4])
    C0, C1 = fq4_sq(s[2], s[5])
    out = [None] * 6
    out[0] = F2.sub(F2.scale(A0, 3), F2.scale(s[0], 2))
    out[2] = F2.sub(F2.scale(B0, 3), F2.scale(s[2], 2))
    out[4] = F2.sub(F2.scale(C0, 3), F2.scale(s[4], 2))
    out[1] = F2.add(F2.scale(F2.mul_w6(C1), 3), F2.scale(s[1], 2))
    out[3] = F2.add(F2.scale(A1, 3), F2.scale(s[3], 2))
    out[5] = F2.add(F2.scale(B1, 3), F2.scale(s[5], 2))
    return Fq12(tuple(F2.cap(x) for x in out))


# ---------------------------------------------------------------------------
# Frobenius
# ---------------------------------------------------------------------------


def frobenius_map(a: Fq12, power: int) -> Fq12:
    """Conjugate slots (odd powers) then multiply slot i by the constant
    frob_coeffs(power)^i (final_exp_native.rs:17-54)."""
    pw = power % 12
    out = []
    for i in range(6):
        s = a.s[i]
        if pw % 2 != 0:
            s = F2.conj(s)
        g0, g1 = frob_coeff_pow(pw, i)
        if (g0, g1) == (1, 0):
            out.append(s)
        else:
            const = F2.fp2_from_ints((g0, g1), (), a.device)
            out.append(F2.mul(s, const))
    return Fq12(tuple(out))


# ---------------------------------------------------------------------------
# Inversion (via the internal tower Fq12 = Fq6[w]/(w^2 - v), v = w^2)
# ---------------------------------------------------------------------------


def _fq6_mul(x, y):
    # Fq6 = Fq2[v]/(v^3 - xi); x, y are 3-tuples of Fp2
    m = F2.mul
    c0 = F2.add(m(x[0], y[0]), F2.mul_w6(F2.add(m(x[1], y[2]), m(x[2], y[1]))))
    c1 = F2.add(F2.add(m(x[0], y[1]), m(x[1], y[0])), F2.mul_w6(m(x[2], y[2])))
    c2 = F2.add(F2.add(m(x[0], y[2]), m(x[2], y[0])), m(x[1], y[1]))
    return (c0, c1, c2)


def _fq6_inv(x):
    m, s = F2.mul, F2.square
    c0, c1, c2 = x
    t0 = F2.sub(s(c0), F2.mul_w6(m(c1, c2)))
    t1 = F2.sub(F2.mul_w6(s(c2)), m(c0, c1))
    t2 = F2.sub(s(c1), m(c0, c2))
    norm = F2.add(m(c0, t0), F2.mul_w6(F2.add(m(c1, t2), m(c2, t1))))
    ninv = F2.inv(norm)
    return (m(t0, ninv), m(t1, ninv), m(t2, ninv))


def fq12_inv(a: Fq12) -> Fq12:
    """(A + Bw)^{-1} = (A - Bw) / (A^2 - B^2 v); unique, so value-identical
    to the reference's division (final_exp_native.rs:72-75)."""
    A = (a.s[0], a.s[2], a.s[4])
    B = (a.s[1], a.s[3], a.s[5])
    b2 = _fq6_mul(B, B)
    b2v = (F2.mul_w6(b2[2]), b2[0], b2[1])  # multiply by v (v^3 = xi)
    denom = tuple(F2.sub(x, y) for x, y in zip(_fq6_mul(A, A), b2v))
    dinv = _fq6_inv(denom)
    out_a = _fq6_mul(A, dinv)
    out_b = _fq6_mul(tuple(F2.neg(x) for x in B), dinv)
    return Fq12((out_a[0], out_b[0], out_a[1], out_b[1], out_a[2], out_b[2]))


def fq12_div(a: Fq12, b: Fq12) -> Fq12:
    """a / b through ``ops.inv_kernels.fq12_inv``: kernel G on CUDA
    tensors, its plain version (this module's ``fq12_inv``) on CPU ones."""
    from ..ops.inv_kernels import fq12_inv as kfq12_inv

    return fq12_mul(a, kfq12_inv(b))


def fq12_cap(a: Fq12) -> Fq12:
    """Normalize every slot to the (2p, settled) envelope."""
    return Fq12(tuple(F2.cap(s) for s in a.s))
