"""Batched final exponentiation f -> f^((p^12-1)/r), and the Fq12 powers.

PyTorch counterpart of ``pairing_tpu/pairing/final_exp.py``. The main path
is ``final_exp_k`` (:190): the easy part (:110) and the hard part (:121,
:133) run on KF12 = int32[12, NLIMBS, B]. Every dense product is kernel A,
every cyclotomic square kernel B, and each of the three x-power ladders is
kernel D fed by ``pow_x_streamed``; conjugates and Frobenius maps are kernel
E and the one inverse kernel G (``ops.klayout``). The hard-part chain is
either those 29 launches or, when asked for (``fused=True``, or the
``PAIRING_FUSED_CHAIN`` environment variable on CUDA operands, as the
reference reads it at :153), kernel K15 in one launch. Each part is a
``torch.profiler.record_function`` range named ``final_exp.<part>``.

The Fq12-level functions of the reference are here too, each converting to
the kernel layout once and back: ``easy_part`` (:195; its inverse is kernel
G), ``hard_part`` (:210; its x-powers are kernel K17), ``pow_x_cyclotomic``
(:34, kernel K17) and ``fq12_pow`` (:71; dense squares on K18, products on
A, the inverse on G).

Algorithm parity: final_exp_native.rs (easy part :195-206, hard part
:130-169, pow :56-84). The reference implements NAF digit -1 as a division;
the cyclotomic ladders multiply by the conjugate, the same value on the
cyclotomic subgroup. ``fq12_pow`` takes arbitrary elements and uses the
true inverse.
"""

from __future__ import annotations

import os

import torch
from torch.profiler import record_function

from ..fields.fp12 import Fq12, fq12_cap
from ..ops import dispatch
from ..ops import klayout as KL
from ..ops.fq12_kernels import from_kernel_layout, to_kernel_layout
from ..ops.fused_kernels import BN_X_W4_DIGITS, hard_chain, pow_ladder_w4, pow_x_streamed
from ..utils.bn254 import get_naf


def easy_part_k(a: torch.Tensor) -> torch.Tensor:
    """a -> a^((q^6-1)(q^2+1)) (final_exp_native.rs:195-206)."""
    with record_function("final_exp.easy_part"):
        f1 = KL.kconj(a)
        f2 = KL.kmul(f1, KL.kinv(a))
        f3 = KL.kfrob(f2, 2)
        return KL.kmul(f3, f2)


def hard_part_k(m: torch.Tensor) -> torch.Tensor:
    """halo2-lib addition chain (final_exp_native.rs:130-169)."""
    with record_function("final_exp.pow_x_ladders"):
        mx = pow_x_streamed(m)
        mx2 = pow_x_streamed(mx)
        mx3 = pow_x_streamed(mx2)
    with record_function("final_exp.hard_chain"):
        return hard_part_chain_k(m, mx, mx2, mx3)


def hard_part_chain_k(m, mx, mx2, mx3, fused=None) -> torch.Tensor:
    """The hard-part chain given the three x-powers. Every operand lives in
    the cyclotomic subgroup, so squarings are Granger-Scott.

    ``fused=True`` runs it as one launch of kernel K15 (its plain version on
    CPU operands), ``False`` as 29 launches of A, B and E; ``None`` reads
    ``PAIRING_FUSED_CHAIN`` on CUDA operands and takes the 29 launches on
    CPU operands, as the reference reads it on the TPU only."""
    if fused is None:
        fused = dispatch.on_cuda(m) and bool(os.environ.get("PAIRING_FUSED_CHAIN"))
    if fused:
        return hard_chain(m, mx, mx2, mx3)
    return _hard_chain_launches(m, mx, mx2, mx3)


def _hard_chain_launches(m, mx, mx2, mx3) -> torch.Tensor:
    mul, conj, frob, csq = KL.kmul, KL.kconj, KL.kfrob, KL.kcyc_sq

    mp = frob(m, 1)
    mp2 = frob(m, 2)
    mp3 = frob(m, 3)

    y0 = mul(mp, mul(mp2, mp3))
    y1 = conj(m)
    mxp = frob(mx, 1)
    mx2p = frob(mx2, 1)
    y2 = frob(mx2, 2)
    y5 = conj(mx2)
    mx3p = frob(mx3, 1)

    y3 = conj(mxp)
    y4 = conj(mul(mx, mx2p))
    y6 = conj(mul(mx3, mx3p))

    t0 = mul(mul(csq(y6), y4), y5)
    t1 = mul(y3, y5)
    t1 = mul(t1, t0)
    t0 = mul(y2, t0)
    t1 = csq(t1)
    t1 = mul(t1, t0)
    t1 = csq(t1)
    t0 = mul(t1, y1)
    t1 = mul(t1, y0)
    t0 = csq(t0)
    t0 = mul(t0, t1)
    return t0


def final_exp_k(a: torch.Tensor) -> torch.Tensor:
    """Kernel-layout final exponentiation (final_exp_native.rs:209-213)."""
    return hard_part_k(easy_part_k(a))


def final_exp(a: Fq12) -> Fq12:
    """final_exp_native (final_exp_native.rs:209-213), batched."""
    arr, bs = to_kernel_layout(a)
    return from_kernel_layout(final_exp_k(arr), bs)


def pow_x_cyclotomic(m: Fq12) -> Fq12:
    """m^BN_X for m in the cyclotomic subgroup (kernel K17's w4 ladder)."""
    arr, bs = to_kernel_layout(m)
    return from_kernel_layout(pow_ladder_w4(arr, BN_X_W4_DIGITS), bs)


def easy_part(a: Fq12) -> Fq12:
    """a -> a^((q^6-1)(q^2+1)) (final_exp_native.rs:195-206): conjugate,
    times the inverse (kernel G), Frobenius p^2, product."""
    arr, bs = to_kernel_layout(a)
    return from_kernel_layout(easy_part_k(arr), bs)


def hard_part(m: Fq12) -> Fq12:
    """halo2-lib addition chain (final_exp_native.rs:130-169) of an
    easy-part output: the three x-powers on kernel K17, then
    ``hard_part_chain_k``."""
    arr, bs = to_kernel_layout(m)
    with record_function("final_exp.pow_x_ladders"):
        mx = pow_ladder_w4(arr, BN_X_W4_DIGITS)
        mx2 = pow_ladder_w4(mx, BN_X_W4_DIGITS)
        mx3 = pow_ladder_w4(mx2, BN_X_W4_DIGITS)
    with record_function("final_exp.hard_chain"):
        out = hard_part_chain_k(arr, mx, mx2, mx3)
    return from_kernel_layout(out, bs)


def fq12_pow(a: Fq12, e: int) -> Fq12:
    """a^e for a static e >= 1 and any a (pow_native parity,
    final_exp_native.rs:56-84): square-and-multiply over the MSB-first NAF
    of e with dense squares (kernel K18) and products (kernel A); a -1 digit
    multiplies by a^-1, computed once on kernel G and only when the NAF has
    such a digit. A one-digit NAF returns a capped to the (2p, settled)
    envelope, as the reference does."""
    if e < 1:
        raise ValueError(f"exponent must be >= 1, got {e}")
    naf = list(reversed(get_naf(e)))
    if len(naf) == 1:
        return fq12_cap(a)
    arr, bs = to_kernel_layout(a)
    inv = KL.kinv(arr) if -1 in naf else None
    f = arr
    for d in naf[1:]:
        f = KL.ksq(f)
        if d != 0:
            f = KL.kmul(f, arr if d > 0 else inv)
    return from_kernel_layout(f, bs)
