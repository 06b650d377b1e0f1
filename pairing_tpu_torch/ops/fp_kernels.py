"""Kernel F — a^e in Fq for a static exponent, on Fq tensors [NLIMBS, B].

The counterpart of ``pairing_tpu/ops/fp_kernels.py``'s
``fp_pow_bits_pallas``: the Fermat inversion a^(p-2) behind
``fields.fp.fp_inv`` (the one Fq2 inversion between the two Phase N
passes). The kernel runs kernel G's 4-bit window chain (``csrc/field32.cuh``,
``fp32_pow_w4``) for any static e >= 1; the exponent enters as its 32-bit
words, least significant first, from a small device array, and the bit of
its leading one.

Kernel G's chain (``fp32_inv``) runs the inverse's fixed schedule with the
words compiled in: ``inverse_schedule`` gives the same words.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields import fp as F
from ..fields.fp import Fp
from . import dispatch
from .fq12_kernels import kfp_view, kstack

FP_POW_BITS = dispatch.KERNELS["fp_pow_bits"]


def words_of(e: int) -> tuple:
    """(32-bit words of e >= 1, least significant first; the bit of its
    leading one). Bit i of e is bit i % 32 of word i // 32; its 4-bit window
    digit at i (a multiple of 4) is (word >> i % 32) & 15."""
    if e < 1:
        raise ValueError("exponent must be >= 1")
    top = e.bit_length() - 1
    return tuple((e >> (32 * k)) & 0xFFFFFFFF for k in range(top // 32 + 1)), top


@lru_cache(maxsize=None)
def exponent_words(e: int, device: torch.device) -> tuple:
    """e's words as int32 (the same 32 bits) on ``device`` and its top bit,
    as the kernel takes them."""
    words, top = words_of(e)
    return torch.as_tensor(np.asarray(words, np.uint32).view(np.int32), device=device), top


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
