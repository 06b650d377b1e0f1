"""Canonical reduction mod p and the exact equality tests on it, on
``k_canonical`` (``csrc/canonical.cu``).

One C entry, two modes that count apart in ``dispatch.KERNELS``:

  ``canonical``     an Fp batch -> its canonical digits (the value mod p,
                    still in the Montgomery domain), one launch;
  ``canonical_eq``  up to 24 pairs (a, b), b None meaning zero -> bool
                    [batch]: every pair equal mod p, one launch.

The field library's ``canonical``, ``fp_eq``, ``fp_is_zero`` (``fields/fp.py``),
``eq`` (``fields/fp2.py``) and ``fq12_eq`` (``fields/fp12.py``) call these.
CPU tensors take the plain versions (``fields.fp.canonical_plain``,
:func:`all_equal_plain`); CUDA tensors launch the kernel or raise.

Operands are read in place: the kernel takes a base pointer, a row stride
and a limb stride per operand, so an ``expand``ed constant (row stride 0) and
a transposed view of the batch-last kernel layout (row stride 1) cost no
copy. Only an operand whose batch axes do not fold into one stride is made
contiguous first. The operand table travels in the kernel's parameters, so
a launch copies nothing from the host to the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..fields import fp as F
from ..fields.fp import NLIMBS, Fp
from ..utils.bn254 import P
from . import dispatch

CANONICAL = dispatch.KERNELS["canonical"]
CANONICAL_EQ = dispatch.KERNELS["canonical_eq"]

#: Pairs one compare launch takes (``CANON_MAX_PAIRS`` in the source).
MAX_PAIRS = 24
#: Long-division steps the kernel's table of p 2^j covers (j < 20).
MAX_STEPS = 20

Pair = Tuple[Fp, Optional[Fp]]


def subtraction_steps(bound: int) -> int:
    """The kernel's long-division steps for values below ``bound``: the
    least s >= 1 with p 2^s >= bound (s = 1 up to 2p, 20 up to R)."""
    if bound > P << MAX_STEPS:
        raise ValueError(f"value bound {bound:#x} above p 2^{MAX_STEPS}")
    steps = 1
    while P << steps < bound:
        steps += 1
    return steps


def operand_strides(limbs: torch.Tensor, batch_shape) -> Optional[Tuple[int, int]]:
    """(row stride, limb stride) in elements that read ``limbs`` broadcast to
    ``batch_shape`` in place as rows [prod(batch_shape), NLIMBS], or None
    when its batch axes do not fold into one stride."""
    x = limbs.broadcast_to(tuple(batch_shape) + (NLIMBS,))
    row, span = NLIMBS, None  # row: any value while at most one row is read
    for size, stride in reversed(list(zip(x.shape[:-1], x.stride()[:-1]))):
        if size == 1:
            continue
        if span is None:
            row = stride
        elif stride != span:
            return None
        span = stride * size
    return row, x.stride(-1)


def operand_table(operands: Sequence[Optional[Fp]],
                  batch_shape) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """A C entry's host table int64 [n, 4] (``k_canonical``'s, ``k_validate``'s):
    per operand (address, row stride, limb stride, steps), zeros for an
    absent one (None). Also returns the contiguous copies it made, which must
    outlive the launch. Raises ValueError for a bound above p 2^20."""
    rows, keep = [], []
    for x in operands:
        if x is None:
            rows += [0, 0, 0, 0]
            continue
        if x.limbs.dtype != F.DTYPE:
            raise TypeError(f"operand dtype {x.limbs.dtype}, want {F.DTYPE}")
        limbs, strides = x.limbs, operand_strides(x.limbs, batch_shape)
        if strides is None:
            limbs = limbs.broadcast_to(tuple(batch_shape) + (NLIMBS,)).contiguous()
            keep.append(limbs)
            strides = (NLIMBS, 1)
        rows += [limbs.data_ptr(), *strides, subtraction_steps(x.bound)]
    return torch.tensor(rows, dtype=torch.int64), keep


def all_equal_plain(pairs: Sequence[Pair]) -> torch.Tensor:
    """Plain PyTorch version of the compare mode: each pair's canonical
    digits compared (a b of None against zero), the verdicts and-ed."""
    out = None
    for a, b in pairs:
        other = 0 if b is None else F.canonical_plain(b).limbs
        e = (F.canonical_plain(a).limbs == other).all(dim=-1)
        out = e if out is None else out & e
    return out


def canonical(a: Fp) -> Fp:
    """The representative of ``a`` in [0, p) as digits [*batch, NLIMBS]
    (contiguous; bound p, limbs below 2^13)."""
    if not dispatch.on_cuda(a.limbs):
        return F.canonical_plain(a)
    bs = a.batch_shape
    out = torch.empty(bs + (NLIMBS,), dtype=F.DTYPE, device=a.device)
    lanes = out.numel() // NLIMBS
    if lanes:
        table, keep = operand_table([a, None], bs)  # keep: alive through the launch
        CANONICAL(dispatch.Host(table), 1, out, None, lanes)
    return Fp(out, bound=P, limb_bound=F.MASK)


def all_equal(pairs: Sequence[Pair]) -> torch.Tensor:
    """bool [batch]: every pair (a, b) equal mod p, b None meaning zero;
    operands broadcast over the batch."""
    pairs = list(pairs)
    limbs = [x.limbs for pair in pairs for x in pair if x is not None]
    if not dispatch.on_cuda(*limbs):
        return all_equal_plain(pairs)
    if not 1 <= len(pairs) <= MAX_PAIRS:
        raise ValueError(f"{len(pairs)} pairs, want 1 to {MAX_PAIRS}")
    bs = torch.broadcast_shapes(*(t.shape[:-1] for t in limbs))
    out = torch.empty(bs, dtype=torch.bool, device=limbs[0].device)
    if out.numel():
        operands = [x for pair in pairs for x in pair]
        table, keep = operand_table(operands, bs)  # keep: alive through the launch
        CANONICAL_EQ(dispatch.Host(table), len(pairs), None, out, out.numel())
    return out
