"""Batched Fq2 = Fq[u]/(u^2 + 1) arithmetic.

PyTorch counterpart of ``pairing_tpu/fields/fp2.py``: elements are pairs of
:class:`~pairing_tpu_torch.fields.fp.Fp` batches (Montgomery domain), with
the same lazy wide products (4 limb products, 2 reductions per multiply;
c0 = a0*b0 + a1*(-b1) keeps everything additive).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from ..utils.bn254 import P, XI_0
from . import fp as F
from .fp import Fp


@dataclasses.dataclass
class Fp2:
    """c0 + c1*u over batched Fp."""

    c0: Fp
    c1: Fp

    @property
    def batch_shape(self):
        return self.c0.batch_shape

    @property
    def device(self):
        return self.c0.device


def fp2_from_ints(values, batch_shape: Tuple[int, ...], device, mont: bool = True) -> Fp2:
    """Host (c0, c1) ints -> broadcast Fp2 constant."""
    c0, c1 = values
    make = F.fp_const_mont if mont else F.fp_const
    return Fp2(make(c0, batch_shape, device), make(c1, batch_shape, device))


def fp2_stack_from_ints(pairs, device) -> Fp2:
    """List of (c0, c1) -> Montgomery-domain Fp2 batch of shape [len(pairs)]."""
    return Fp2(
        F.fp_from_ints_mont([x[0] for x in pairs], device),
        F.fp_from_ints_mont([x[1] for x in pairs], device),
    )


def fp2_to_ints(a: Fp2, mont: bool = True):
    """Device -> host list of (c0, c1) ints (undoes Montgomery)."""
    x = Fp2(F.from_mont(a.c0), F.from_mont(a.c1)) if mont else a
    c0 = F.fp_to_ints(F.canonical(x.c0))
    c1 = F.fp_to_ints(F.canonical(x.c1))
    return list(zip(c0.reshape(-1), c1.reshape(-1)))


def add(a: Fp2, b: Fp2) -> Fp2:
    return Fp2(F.fp_add(a.c0, b.c0), F.fp_add(a.c1, b.c1))


def sub(a: Fp2, b: Fp2) -> Fp2:
    return Fp2(F.fp_sub(a.c0, b.c0), F.fp_sub(a.c1, b.c1))


def neg(a: Fp2) -> Fp2:
    return Fp2(F.fp_neg(a.c0), F.fp_neg(a.c1))


def conj(a: Fp2) -> Fp2:
    """conjugate: c0 - c1*u (miller_loop_native.rs:284-289)."""
    return Fp2(a.c0, F.fp_neg(a.c1))


def neg_conj(a: Fp2) -> Fp2:
    """neg_conjugate: -c0 + c1*u (miller_loop_native.rs:291-296)."""
    return Fp2(F.fp_neg(a.c0), a.c1)


def mul(a: Fp2, b: Fp2) -> Fp2:
    """(a0b0 - a1b1) + (a0b1 + a1b0) u; 4 wide muls, 2 reductions."""
    nb1 = F.fp_neg(b.c1)
    w0 = F.wide_add(F.mul_wide(a.c0, b.c0), F.mul_wide(a.c1, nb1))
    w1 = F.wide_add(F.mul_wide(a.c0, b.c1), F.mul_wide(a.c1, b.c0))
    return Fp2(F.mont_reduce(w0), F.mont_reduce(w1))


def square(a: Fp2) -> Fp2:
    """((a0+a1)(a0-a1), 2 a0 a1); 2 wide muls."""
    t0 = F.fp_add(a.c0, a.c1)
    t1 = F.fp_sub(a.c0, a.c1)
    c0 = F.mont_reduce(F.mul_wide(t0, t1))
    c1 = F.mont_reduce(F.mul_wide(F.fp_scale(a.c0, 2), a.c1))
    return Fp2(c0, c1)


def mul_fp(a: Fp2, k: Fp) -> Fp2:
    """Multiply both components by the Fq element k."""
    return Fp2(
        F.mont_reduce(F.mul_wide(a.c0, k)), F.mont_reduce(F.mul_wide(a.c1, k))
    )


def scale(a: Fp2, k: int) -> Fp2:
    """Multiply by a small non-negative int (e.g. 2, 3)."""
    return Fp2(F.fp_scale(a.c0, k), F.fp_scale(a.c1, k))


def mul_w6(a: Fp2) -> Fp2:
    """Multiply by xi = XI_0 + u = 9 + u: (9 c0 - c1) + (c0 + 9 c1) u.
    No limb products needed."""
    c0 = F.fp_sub(F.fp_scale(a.c0, XI_0), a.c1)
    c1 = F.fp_add(a.c0, F.fp_scale(a.c1, XI_0))
    return Fp2(c0, c1)


def inv(a: Fp2, fp_inv=F.fp_inv) -> Fp2:
    """(c0 - c1 u) / (c0^2 + c1^2); one Fp inversion, by ``fp_inv``."""
    norm = F.mont_reduce(
        F.wide_add(F.mul_wide(a.c0, a.c0), F.mul_wide(a.c1, a.c1))
    )
    n_inv = fp_inv(norm)
    return Fp2(
        F.mont_reduce(F.mul_wide(a.c0, n_inv)),
        F.mont_reduce(F.mul_wide(F.fp_neg(a.c1), n_inv)),
    )


def select(mask, a: Fp2, b: Fp2) -> Fp2:
    return Fp2(F.fp_select(mask, a.c0, b.c0), F.fp_select(mask, a.c1, b.c1))


def eq(a: Fp2, b: Fp2):
    """Equality mod p of both components: bool [...]; one launch of
    ``k_canonical``'s compare mode on CUDA tensors."""
    from ..ops.canon_kernels import all_equal

    return all_equal([(a.c0, b.c0), (a.c1, b.c1)])


def zero(batch_shape: Tuple[int, ...], device) -> Fp2:
    return Fp2(F.fp_const(0, batch_shape, device), F.fp_const(0, batch_shape, device))


def one_mont(batch_shape: Tuple[int, ...], device) -> Fp2:
    return Fp2(F.fp_mont_one(batch_shape, device), F.fp_const(0, batch_shape, device))


def cap(a: Fp2) -> Fp2:
    """Normalize both components to the (2p, settled) envelope."""
    return Fp2(F._cap_2p(a.c0), F._cap_2p(a.c1))


def from_limbs(t) -> Fp2:
    """Raw (c0, c1) limb tensors -> Fp2 with the (2p, settled) envelope."""
    return Fp2(F.Fp(t[0], 2 * P, F.SETTLED), F.Fp(t[1], 2 * P, F.SETTLED))
