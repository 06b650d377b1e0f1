"""Batched BN254 G1 (E: y^2 = x^3 + 3 over Fq), affine coordinates.

PyTorch counterpart of ``pairing_tpu/curves/g1.py``. G1 points are pairing
inputs only (the Miller loop never moves them), so only construction,
export, negation and validation are needed.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

from torch.profiler import record_function

from ..fields import fp as F
from ..fields.fp import Fp


@dataclasses.dataclass
class G1:
    """Affine point batch; coordinates in the Montgomery domain."""

    x: Fp
    y: Fp

    @property
    def batch_shape(self):
        return self.x.batch_shape


def g1_from_ints(points: Sequence[Tuple[int, int]], device) -> G1:
    """[(x, y), ...] host ints -> G1 batch."""
    xs = F.fp_from_ints_mont([p[0] for p in points], device)
    ys = F.fp_from_ints_mont([p[1] for p in points], device)
    return G1(xs, ys)


def g1_to_ints(p: G1):
    xs = F.fp_to_ints(F.canonical(F.from_mont(p.x)))
    ys = F.fp_to_ints(F.canonical(F.from_mont(p.y)))
    return [(int(a), int(b)) for a, b in zip(xs.reshape(-1), ys.reshape(-1))]


def g1_neg(p: G1) -> G1:
    return G1(p.x, F.fp_neg(p.y))


def g1_on_curve_plain(p: G1):
    """Plain PyTorch version of ``k_validate``'s G1 mode: y^2 == x^3 + 3,
    bool [batch]."""
    y2 = F.mont_mul(p.y, p.y)
    x3 = F.mont_mul(F.mont_mul(p.x, p.x), p.x)
    rhs = F.fp_add(x3, F.fp_const_mont(3, p.batch_shape, p.x.device))
    return F.fp_eq(y2, rhs)


def g1_on_curve(p: G1):
    """y^2 == x^3 + 3: bool [batch]; a ``validate.g1_on_curve`` range holding
    one launch of ``k_validate``'s G1 mode on CUDA tensors
    (``ops.curve_kernels.g1_on_curve``), :func:`g1_on_curve_plain` on CPU
    ones."""
    from ..ops import curve_kernels as CK

    with record_function("validate.g1_on_curve"):
        return CK.g1_on_curve(p)
