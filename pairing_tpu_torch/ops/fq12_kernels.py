"""Kernels A and K18 — Fq12 product (dense or by a line) and dense Fq12
square on the batch-last kernel layout.

    KF12 = int32[12, NLIMBS, B]   (component 2*slot + {c0, c1}, batch last)

The counterparts of ``pairing_tpu/ops/fq12_kernels.py``'s ``_pallas_mul``
(dense and sparse patterns) and ``_pallas_sq``. The TPU layout ``[12, NLIMBS, R, 128]`` padded to 1024
lanes is not inherited: the CUDA kernel runs one thread per lane and masks
the ragged edge itself, so any B works. Values in KF12 are kept in the
standard envelope: limbs settled (<= 2^13 + 1), values < 2p.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..fields import fp as F
from ..fields import fp12 as F12
from ..fields.fp import Fp
from ..fields.fp2 import Fp2
from ..fields.fp12 import Fq12
from ..utils.bn254 import P
from . import dispatch

# ---------------------------------------------------------------------------
# Layout bridges
# ---------------------------------------------------------------------------


def kfp_view(arr: torch.Tensor) -> Fp:
    """One component row block [..., NLIMBS, B] -> Fp of batch [..., B]
    (a transposed view, no copy), envelope (2p, settled)."""
    return Fp(arr.transpose(-1, -2), 2 * P, F.SETTLED)


def kfp2_view(arr: torch.Tensor) -> Fp2:
    """Component rows [..., 2, NLIMBS, B] (c0, c1) -> Fp2 views of batch
    [..., B]."""
    return Fp2(kfp_view(arr.select(-3, 0)), kfp_view(arr.select(-3, 1)))


def kstack(comps) -> torch.Tensor:
    """Fp values of one batch shape [..., B] -> contiguous component rows
    [n, ..., NLIMBS, B] in the (2p, settled) envelope."""
    limbs = torch.broadcast_tensors(*[F._cap_2p(c).limbs for c in comps])
    return torch.stack(limbs).transpose(-1, -2).contiguous()


def kf12_view(arr: torch.Tensor) -> Fq12:
    """KF12 [12, NLIMBS, B] -> Fq12 of batch [B] whose limb tensors are
    transposed views of ``arr`` (no copy), envelope (2p, settled)."""
    comps = [Fp(arr[c].transpose(0, 1), 2 * P, F.SETTLED) for c in range(12)]
    return Fq12(tuple(Fp2(comps[2 * i], comps[2 * i + 1]) for i in range(6)))


def kf12_from(a: Fq12) -> torch.Tensor:
    """Fq12 of batch [B] -> contiguous KF12 [12, NLIMBS, B] in the
    (2p, settled) envelope."""
    comps = []
    for s in F12.fq12_cap(a).s:
        comps += [s.c0.limbs, s.c1.limbs]
    comps = torch.broadcast_tensors(*comps)
    return torch.stack(comps).transpose(1, 2).contiguous()


def to_kernel_layout(a: Fq12) -> Tuple[torch.Tensor, tuple]:
    """Public Fq12 (any batch shape) -> (KF12, batch_shape)."""
    bs = a.batch_shape
    flat = Fq12(tuple(
        Fp2(Fp(s.c0.limbs.reshape(-1, F.NLIMBS), s.c0.bound, s.c0.limb_bound),
            Fp(s.c1.limbs.reshape(-1, F.NLIMBS), s.c1.bound, s.c1.limb_bound))
        for s in a.s
    ))
    return kf12_from(flat), bs


def kf12_canonical(arr: torch.Tensor) -> torch.Tensor:
    """Canonical digits (value mod p, still Montgomery) of KF12 limbs, for
    exact comparison of two representatives. Works on [..., NLIMBS, B].
    Plain PyTorch (``F.canonical_plain``) on every device, so that checks of
    a kernel against its plain version never run through ``k_canonical``."""
    limbs = arr.transpose(-1, -2)
    return F.canonical_plain(Fp(limbs, 2 * P, F.SETTLED)).limbs.transpose(-1, -2)


def kf12_in_envelope(arr: torch.Tensor) -> bool:
    """Every limb in [0, SETTLED] and every value < 2p ([..., NLIMBS, B])."""
    if int(arr.min()) < 0 or int(arr.max()) > F.SETTLED:
        return False
    limbs = arr.transpose(-1, -2)
    two_p = torch.as_tensor(F.int_to_limbs(2 * P), device=arr.device)
    _, borrow = F._ripple_carry(limbs - two_p)
    return bool((borrow < 0).all())


def random_kf12(lead, lanes: int, generator: torch.Generator) -> torch.Tensor:
    """Seeded kernel operands [*lead, NLIMBS, lanes] on the generator's
    device, for checking a kernel against its plain version: values drawn
    nearly uniformly below 2p (so [p, 2p) is covered), and in half of the
    lanes one carry moved down a limb so that settled limbs of 2^13 and
    2^13 + 1 occur. Every value is in the kernel envelope."""
    dev = generator.device
    lead = tuple(lead)
    row = lead + (1, lanes)

    def draw(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=generator, device=dev, dtype=F.DTYPE)

    two_p = torch.as_tensor(F.int_to_limbs(2 * P), device=dev)
    x = draw(0, F.RADIX, lead + (F.NLIMBS, lanes))
    x[..., F.NLIMBS - 2, :] = draw(0, int(two_p[F.NLIMBS - 2]) + 1, lead + (lanes,))
    x[..., F.NLIMBS - 1, :] = 0
    _, borrow = F._ripple_carry(x.transpose(-1, -2) - two_p)
    x[..., F.NLIMBS - 2, :] -= (borrow >= 0).to(F.DTYPE)  # values >= 2p: drop below

    idx = torch.arange(F.NLIMBS, device=dev).view(-1, 1)
    pos = draw(1, F.NLIMBS - 1, row)
    hi, lo = idx == pos, idx == pos - 1
    hi_val = (x * hi).sum(-2, keepdim=True, dtype=F.DTYPE)
    lo_val = (x * lo).sum(-2, keepdim=True, dtype=F.DTYPE)
    move = (draw(0, 2, row) == 1) & (hi_val > 0)
    low = F.RADIX + torch.minimum(lo_val, draw(0, 2, row))  # never raises the value
    x = torch.where(hi & move, x - 1, x)
    x = torch.where(lo & move, low, x)
    return x.contiguous()


def from_kernel_layout(arr: torch.Tensor, batch_shape: tuple) -> Fq12:
    """KF12 -> public Fq12 with limbs [*batch_shape, NLIMBS] (contiguous)."""
    flat = arr.transpose(1, 2).reshape((12,) + tuple(batch_shape) + (F.NLIMBS,))
    comps = [Fp(flat[c].contiguous(), 2 * P, F.SETTLED) for c in range(12)]
    return Fq12(tuple(Fp2(comps[2 * i], comps[2 * i + 1]) for i in range(6)))


# ---------------------------------------------------------------------------
# Kernel A
# ---------------------------------------------------------------------------

FQ12_MUL = dispatch.KERNELS["fq12_mul"]
FQ12_MUL_SPARSE = dispatch.KERNELS["fq12_mul_sparse"]
FQ12_SQ = dispatch.KERNELS["fq12_sq"]
DENSE = 0x3F  # kernel A's slot mask: every slot of b present


def fq12_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel A (the gathered field-library product)."""
    return kf12_from(F12.fq12_mul(kf12_view(a), kf12_view(b)))


def fq12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense Fq12 product, KF12 x KF12 -> KF12."""
    if not dispatch.on_cuda(a, b):
        return fq12_mul_plain(a, b)
    lanes = a.shape[-1]
    dispatch.check_operand(a, "a", (12,), lanes)
    dispatch.check_operand(b, "b", (12,), lanes)
    out = torch.empty_like(a)
    FQ12_MUL(a, b, DENSE, out, lanes)
    return out


def _present_mask(present: Sequence[int]) -> int:
    slots = sorted(set(int(j) for j in present))
    if not slots or len(slots) != len(present) or slots[0] < 0 or slots[-1] > 5:
        raise ValueError(f"present must name distinct slots in 0..5, got {tuple(present)}")
    return sum(1 << j for j in slots)


def fq12_mul_sparse_plain(a: torch.Tensor, present: Sequence[int], b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel A's sparse mode."""
    bv = kf12_view(b)
    return kf12_from(F12.fq12_mul_sparse(kf12_view(a), {int(j): bv.s[int(j)] for j in present}))


def fq12_mul_sparse(a: torch.Tensor, present: Sequence[int], b: torch.Tensor) -> torch.Tensor:
    """a times the sparse b whose nonzero slots are ``present`` (the line
    shapes (0, 3, 4) and (2, 3, 5), or any other); b is KF12 and its other
    slots are never read. KF12 x KF12 -> KF12."""
    mask = _present_mask(present)
    if not dispatch.on_cuda(a, b):
        return fq12_mul_sparse_plain(a, present, b)
    lanes = a.shape[-1]
    dispatch.check_operand(a, "a", (12,), lanes)
    dispatch.check_operand(b, "b", (12,), lanes)
    out = torch.empty_like(a)
    FQ12_MUL_SPARSE(a, b, mask, out, lanes)
    return out


# ---------------------------------------------------------------------------
# Kernel K18: dense square
# ---------------------------------------------------------------------------


def fq12_sq_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel K18."""
    return kf12_from(F12.fq12_sq(kf12_view(a)))


def fq12_sq(a: torch.Tensor) -> torch.Tensor:
    """Dense Fq12 square (any element, not only the cyclotomic subgroup),
    KF12 -> KF12."""
    if not dispatch.on_cuda(a):
        return fq12_sq_plain(a)
    lanes = a.shape[-1]
    dispatch.check_operand(a, "a", (12,), lanes)
    out = torch.empty_like(a)
    FQ12_SQ(a, out, lanes)
    return out
