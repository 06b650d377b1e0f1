"""Kernel F — a^e in Fq for a static exponent, on Fq tensors [NLIMBS, B] —
and ``k_fq2_inv``, Phase N's Fq2 inverse, on Fq2 tensors [2, NLIMBS, B].

Kernel F is the counterpart of ``pairing_tpu/ops/fp_kernels.py``'s
``fp_pow_bits_pallas``: the Fermat inversion a^(p-2) behind
``fields.fp.fp_inv``. The kernel runs kernel G's 4-bit window chain
(``csrc/field32.cuh``, ``fp32_pow_w4``) for any static e >= 1; the exponent
enters as its 32-bit words, least significant first, from a small device
array, and the bit of its leading one.

Kernel G's chain (``fp32_inv``) runs the inverse's fixed schedule with the
words compiled in: ``inverse_schedule`` gives the same words. ``k_fq2_inv``
(``csrc/fq2_inv.cu``) runs that chain between the norm c0^2 + c1^2 and the
two products of the Fq2 inverse, one launch for the one Fq2 inversion
between the two Phase N passes, which the reference leaves to XLA around
kernel F.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..fields import fp as F
from ..fields import fp2 as F2
from ..fields.fp import Fp
from . import dispatch
from .fq12_kernels import kfp2_view, kfp_view, kstack

FP_POW_BITS = dispatch.KERNELS["fp_pow_bits"]
FQ2_INV = dispatch.KERNELS["fq2_inv"]


def words_of(e: int) -> tuple:
    """(32-bit words of e >= 1, least significant first; the bit of its
    leading one). Bit i of e is bit i % 32 of word i // 32; its 4-bit window
    digit at i (a multiple of 4) is (word >> i % 32) & 15."""
    if e < 1:
        raise ValueError("exponent must be >= 1")
    top = e.bit_length() - 1
    return tuple((e >> (32 * k)) & 0xFFFFFFFF for k in range(top // 32 + 1)), top


def exponent_words(e: int, device: torch.device) -> tuple:
    """e's words as int32 (the same 32 bits) on ``device``, from
    ``dispatch.device_table``, and its top bit, as the kernel takes them."""
    words, top = words_of(e)
    return dispatch.device_table(tuple(w - (w >> 31 << 32) for w in words), device), top


@lru_cache(maxsize=None)
def inverse_schedule() -> tuple:
    """The Fermat inverse's exponent p - 2 as kernel G's chain reads it:
    (eight 32-bit words, least significant first; the bit of its leading
    one)."""
    return words_of(F.P - 2)


def fp_pow_bits_plain(a: torch.Tensor, e: int) -> torch.Tensor:
    """Plain PyTorch version of kernel F."""
    return kstack([F.fp_pow_bits(kfp_view(a), e)])[0]


def fp_pow_bits(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e (Montgomery domain in and out) for a [NLIMBS, B] in the
    (2p, settled) envelope."""
    if not dispatch.on_cuda(a):
        return fp_pow_bits_plain(a, e)
    lanes = a.shape[-1]
    dispatch.check_operand(a, "a", (), lanes)
    words, top = exponent_words(e, a.device)
    out = torch.empty_like(a)
    FP_POW_BITS(a, words, words.numel(), top, out, lanes)
    return out


def fp_inv(a: Fp) -> Fp:
    """Fermat inverse of an Fp batch of any shape through kernel F."""
    bs = a.batch_shape
    arr = kstack([Fp(a.limbs.reshape(-1, F.NLIMBS), a.bound, a.limb_bound)])[0]
    out = fp_pow_bits(arr, F.P - 2)
    return Fp(out.transpose(0, 1).reshape(bs + (F.NLIMBS,)), 2 * F.P, F.SETTLED)


def fp2_inv_plain(total: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``k_fq2_inv``: the field library's Fq2
    inverse around ``fp_inv`` (kernel F on CUDA tensors, its plain version
    on CPU tensors)."""
    t = F2.inv(kfp2_view(total), fp_inv)
    return kstack([t.c0, t.c1])


def fp2_inv(total: torch.Tensor) -> torch.Tensor:
    """1 / total (Montgomery domain in and out; zero lanes give zero) for
    Fq2 rows [2, NLIMBS, B] (c0, c1) in the (2p, settled) envelope, the
    output in that envelope."""
    if not dispatch.on_cuda(total):
        return fp2_inv_plain(total)
    lanes = total.shape[-1]
    dispatch.check_operand(total, "total", (2,), lanes)
    out = torch.empty_like(total)
    FQ2_INV(total, out, lanes)
    return out
