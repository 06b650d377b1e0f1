"""Fq12 operations on the batch-last kernel layout KF12 = int32[12, NLIMBS, B].

The counterpart of ``pairing_tpu/ops/klayout.py``; the whole final
exponentiation stays in this layout:

  * kmul     — dense product (kernel A, ``fq12_kernels.fq12_mul``)
  * kmul_sparse — product by a sparse operand (kernel A's sparse mode,
               ``fq12_kernels.fq12_mul_sparse``)
  * ksq      — dense square (kernel K18, ``fq12_kernels.fq12_sq``)
  * kcyc_sq  — Granger-Scott cyclotomic square (kernel B)
  * kconj    — conjugate (negate odd w-powers; final_exp_native.rs:171-181)
  * kfrob    — Frobenius p, p^2, p^3 (final_exp_native.rs:17-54)
  * kinv     — tower inversion (fields.fp12.fq12_inv)

kconj and kfrob share one slot-wise kernel (E) driven by a per-slot
program, as the TPU's ``_slotwise`` does; kinv is kernel G.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields import fp as F
from ..fields import fp12 as F12
from ..utils.bn254 import P, frob_coeff_pow
from . import dispatch
from .fq12_kernels import fq12_mul as kmul  # noqa: F401  (re-export)
from .fq12_kernels import fq12_mul_sparse as kmul_sparse  # noqa: F401  (re-export)
from .fq12_kernels import fq12_sq as ksq  # noqa: F401  (re-export)
from .fq12_kernels import kf12_from, kf12_view

FQ12_CYC_SQ = dispatch.KERNELS["fq12_cyc_sq"]
FQ12_SLOTWISE = dispatch.KERNELS["fq12_slotwise"]
FQ12_INV = dispatch.KERNELS["fq12_inv"]

NEG_C0, NEG_C1, MUL_CONST = 1, 2, 4


def kcyc_sq_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B."""
    return kf12_from(F12.fq12_cyclotomic_sq(kf12_view(a)))


def kcyc_sq(a: torch.Tensor) -> torch.Tensor:
    """Granger-Scott squaring (fields.fp12.fq12_cyclotomic_sq); equals the
    square on the cyclotomic subgroup only."""
    if not dispatch.on_cuda(a):
        return kcyc_sq_plain(a)
    lanes = a.shape[-1]
    dispatch.check_operand(a, "a", (12,), lanes)
    out = torch.empty_like(a)
    FQ12_CYC_SQ(a, out, lanes)
    return out


# ---------------------------------------------------------------------------
# Kernel E: slot-wise maps (conjugate, Frobenius)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _slot_prog(power):
    """Per-slot program of kernel E: (ops[6], constants [6, 2, NLIMBS]).

    ``power`` None is the conjugate (negate both components of the odd
    slots); otherwise frobenius_map(power): conjugate every slot for odd
    powers, then multiply slot i by frob_coeffs(power)^i (Montgomery)."""
    ops = np.zeros(6, np.int32)
    consts = np.zeros((6, 2, F.NLIMBS), np.int32)
    for i in range(6):
        if power is None:
            ops[i] = NEG_C0 | NEG_C1 if i % 2 else 0
            continue
        ops[i] = NEG_C1 if power % 2 else 0
        g = tuple(frob_coeff_pow(power, i))
        if g != (1, 0):
            ops[i] |= MUL_CONST
            for k in range(2):
                consts[i, k] = F.int_to_limbs((g[k] % P) * F.R_MONT % P)
    return ops, consts


@lru_cache(maxsize=None)
def _slot_prog_host(power):
    """The program as host tensors: the C entry point folds it into the
    kernel's parameter table before the launch."""
    ops, consts = _slot_prog(power)
    return torch.as_tensor(ops), torch.as_tensor(consts)


def slotwise_plain(a: torch.Tensor, power) -> torch.Tensor:
    """Plain PyTorch version of kernel E."""
    x = kf12_view(a)
    return kf12_from(F12.conjugate(x) if power is None else F12.frobenius_map(x, power))


def slotwise(a: torch.Tensor, power) -> torch.Tensor:
    """Kernel E: the conjugate (``power`` None) or frobenius_map(power)."""
    if not dispatch.on_cuda(a):
        return slotwise_plain(a, power)
    lanes = a.shape[-1]
    dispatch.check_operand(a, "a", (12,), lanes)
    ops, consts = _slot_prog_host(power)
    out = torch.empty_like(a)
    FQ12_SLOTWISE(a, dispatch.Host(ops), dispatch.Host(consts), out, lanes)
    return out


def kconj(a: torch.Tensor) -> torch.Tensor:
    """conjugate_fp12; the inverse on the cyclotomic subgroup."""
    return slotwise(a, None)


def kfrob(a: torch.Tensor, power: int) -> torch.Tensor:
    """frobenius_map(power)."""
    return slotwise(a, power % 12)


# ---------------------------------------------------------------------------
# Kernel G: inversion
# ---------------------------------------------------------------------------


def kinv_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel G."""
    return kf12_from(F12.fq12_inv(kf12_view(a)))


#: Rows [rows, NLIMBS, B] of kernel G's device scratch: t (6), n (2), N, 1/N.
INV_SCRATCH_ROWS = 10


def kinv(a: torch.Tensor) -> torch.Tensor:
    """Tower inversion (fields.fp12.fq12_inv): one Fermat inverse per lane.
    Kernel G's three launches (norm, chain, output) count as one."""
    if not dispatch.on_cuda(a):
        return kinv_plain(a)
    lanes = a.shape[-1]
    dispatch.check_operand(a, "a", (12,), lanes)
    scratch = torch.empty((INV_SCRATCH_ROWS, F.NLIMBS, lanes), dtype=a.dtype, device=a.device)
    out = torch.empty_like(a)
    FQ12_INV(a, scratch, out, lanes)
    return out
