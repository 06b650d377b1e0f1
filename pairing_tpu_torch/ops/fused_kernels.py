"""Kernels C, D and K12 — the fused Miller f-accumulation, the streamed
windowed x-power ladder and the witness bit ladder, on the batch-last kernel
layout.

Counterparts of ``pairing_tpu/ops/fused_kernels.py``'s ``miller_f_pallas``
(any number of pairs per product, optional per-step collection),
``pow_ladder_stream_pallas`` with its host side ``pow_x_streamed``, and
``exp_bits_ladder_pallas``. Each kernel loops over its steps inside one
launch and keeps the Fq12 accumulator in the thread; the plain versions
below run the same schedule with the field library.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..fields import fp as F
from ..fields import fp12 as F12
from ..fields.fp import Fp
from ..fields.fp2 import Fp2
from ..utils.bn254 import BN_X, P, get_wnaf
from . import dispatch
from . import klayout as KL
from .fq12_kernels import kf12_from, kf12_view

MILLER_F = dispatch.KERNELS["miller_f"]
MILLER_F_MULTI = dispatch.KERNELS["miller_f_multi"]
MILLER_F_COLLECT = dispatch.KERNELS["miller_f_collect"]
POW_LADDER_STREAM = dispatch.KERNELS["pow_ladder_stream"]
EXP_BITS = dispatch.KERNELS["exp_bits"]

# ---------------------------------------------------------------------------
# Kernel C: Miller f-accumulation
# ---------------------------------------------------------------------------


def miller_schedule(flags: Sequence[int], ch_rows: Sequence[int]) -> np.ndarray:
    """Per-step (flag, row) pairs, int32 [n_steps, 2].

    flag 0 = square + tangent; 1 = square + tangent + chord ``ch[row]``;
    2 = epilogue chord ``ep[row]`` only (the two Frobenius-line multiplies,
    miller_loop_native.rs:274-280, as trailing steps). Flag-2 steps must
    trail; their rows count 0, 1, ... in order.
    """
    flags = [int(f) for f in flags]
    n_loop = sum(1 for f in flags if f != 2)
    if any(f == 2 for f in flags[:n_loop]) or any(f not in (0, 1, 2) for f in flags):
        raise ValueError("flags must be 0/1 loop steps followed by flag-2 steps")
    sched = np.zeros((len(flags), 2), np.int32)
    for t, f in enumerate(flags):
        sched[t, 0] = f
        if f == 1:
            if int(ch_rows[t]) < 0:
                raise ValueError(f"step {t} has a chord flag but no chord row")
            sched[t, 1] = int(ch_rows[t])
        elif f == 2:
            sched[t, 1] = t - n_loop
    return sched


def _line(arr: torch.Tensor, slots) -> dict:
    """Line block [6, NLIMBS, B] -> {slot: Fp2} views, envelope (2p, settled)."""
    c = [Fp(arr[k].transpose(0, 1), 2 * P, F.SETTLED) for k in range(6)]
    return {s: Fp2(c[2 * jj], c[2 * jj + 1]) for jj, s in enumerate(slots)}


def miller_f_plain(tg, ch, ep, sched: np.ndarray, n_pairs: int = 1, collect: bool = False):
    """Plain PyTorch version of kernel C."""
    lanes = tg.shape[-1] // n_pairs
    f = F12.fq12_cap(F12.fq12_one((lanes,), tg.device))
    rows = []
    for t, (flag, row) in enumerate(sched.tolist()):
        if flag != 2:
            f = F12.fq12_sq(f)
        for k in range(n_pairs):
            cols = slice(k * lanes, (k + 1) * lanes)
            if flag != 2:
                f = F12.fq12_mul_sparse(f, _line(tg[t, ..., cols], F12.LINE_EQUAL_SLOTS))
            if flag != 0:
                src = ch if flag == 1 else ep
                f = F12.fq12_mul_sparse(f, _line(src[row, ..., cols], F12.LINE_UNEQUAL_SLOTS))
        f = F12.fq12_cap(f)
        if collect:
            rows.append(kf12_from(f))
    out = kf12_from(f)
    return (out, torch.stack(rows)) if collect else out


def miller_f(tg: torch.Tensor, ch: torch.Tensor, ep: torch.Tensor,
             flags: Sequence[int], ch_rows: Sequence[int], n_pairs: int = 1,
             collect: bool = False):
    """Phase D for products of ``n_pairs`` pairs; returns f as KF12
    [12, NLIMBS, B], and with ``collect`` also the accumulator after every
    step, fs [n_steps, 12, NLIMBS, B] (fs[-1] equals f).

    Line blocks hold K = n_pairs * B columns, pair-major: pair k of product
    b is column ``k * B + b``. tg: tangent lines [n_loop, 6, NLIMBS, K]
    (slots 0, 3, 4 as c0/c1 rows); ch: chord lines [n_ch, 6, NLIMBS, K]
    (slots 2, 3, 5), step t reads ``ch[ch_rows[t]]`` when ``flags[t] == 1``;
    ep: epilogue lines [n_ep, 6, NLIMBS, K] for the trailing flag-2 steps.
    Each step squares once for all pairs, then multiplies pair k's tangent
    and chord for k = 0..n_pairs-1.
    """
    sched = miller_schedule(flags, ch_rows)
    n_loop = int((sched[:, 0] != 2).sum())
    n_ep = len(sched) - n_loop
    if tg.shape[0] < n_loop or ep.shape[0] < n_ep:
        raise ValueError("fewer line rows than the schedule reads")
    if n_pairs < 1 or tg.shape[-1] % n_pairs:
        raise ValueError(f"{tg.shape[-1]} line columns do not split into {n_pairs} pairs")
    if not dispatch.on_cuda(tg, ch, ep):
        return miller_f_plain(tg, ch, ep, sched, n_pairs, collect)
    cols = tg.shape[-1]
    lanes = cols // n_pairs
    dispatch.check_operand(tg, "tg", (tg.shape[0], 6), cols)
    dispatch.check_operand(ch, "ch", (ch.shape[0], 6), cols)
    dispatch.check_operand(ep, "ep", (ep.shape[0], 6), cols)
    if int(sched[sched[:, 0] == 1, 1].max(initial=0)) >= ch.shape[0]:
        raise ValueError("chord row out of range")
    sched_t = torch.as_tensor(sched, device=tg.device)
    opts = dict(dtype=torch.int32, device=tg.device)
    out = torch.empty((12, F.NLIMBS, lanes), **opts)
    fs = torch.empty((len(sched), 12, F.NLIMBS, lanes), **opts) if collect else None
    kernel = MILLER_F_COLLECT if collect else MILLER_F_MULTI if n_pairs > 1 else MILLER_F
    kernel(tg, ch, ep, sched_t, len(sched), n_pairs, out, 0 if fs is None else fs, lanes)
    return (out, fs) if collect else out


# ---------------------------------------------------------------------------
# Kernel D: streamed windowed cyclotomic ladder
# ---------------------------------------------------------------------------


def _wnaf_msb(e: int, w: int) -> np.ndarray:
    return np.asarray(list(reversed(get_wnaf(e, w))), np.int32)


#: MSB-first BN_X w=4 NAF digits (top digit consumed by ladder init).
BN_X_W4_DIGITS = _wnaf_msb(BN_X, 4)


def pow_ladder_stream_plain(stream: torch.Tensor, digits, rows) -> torch.Tensor:
    """Plain PyTorch version of kernel D."""
    f = kf12_view(stream[int(rows[0])])
    for d, r in zip(list(digits)[1:], list(rows)[1:]):
        f = F12.fq12_cyclotomic_sq(f)
        if int(d) != 0:
            f = F12.fq12_cap(F12.fq12_mul(f, kf12_view(stream[int(r)])))
    return kf12_from(f)


def pow_ladder_stream(stream: torch.Tensor, digits, rows) -> torch.Tensor:
    """Ladder over MSB-first w-NAF ``digits``: start at ``stream[rows[0]]``,
    then per step cyclotomic-square and, on a nonzero digit, multiply by
    the signed table entry ``stream[rows[t]]``. stream: [n_rows, 12,
    NLIMBS, B] -> KF12."""
    digits = np.asarray(digits, np.int32)
    rows = np.asarray(rows, np.int32)
    if len(digits) != len(rows) or digits[0] <= 0:
        raise ValueError("digits/rows must match and the top digit be positive")
    if rows.min() < 0 or rows.max() >= stream.shape[0]:
        raise ValueError("stream row out of range")
    if not dispatch.on_cuda(stream):
        return pow_ladder_stream_plain(stream, digits, rows)
    lanes = stream.shape[-1]
    dispatch.check_operand(stream, "stream", (stream.shape[0], 12), lanes)
    sched = np.stack([(digits != 0).astype(np.int32), rows], axis=1)
    sched_t = torch.as_tensor(sched, device=stream.device)
    out = torch.empty(stream.shape[1:], dtype=torch.int32, device=stream.device)
    POW_LADDER_STREAM(stream, sched_t, len(digits), out, lanes)
    return out


def pow_x_table(m_arr: torch.Tensor):
    """Signed table of the BN_X w4 ladder for m: (stream, rows).

    The entries (m, m^3, m^5, m^7 and conjugates as needed) are built with
    kernels A and B; one stream row per DISTINCT signed digit, and
    ``rows[t]`` is step t's row (unchanged on zero digits)."""
    m2 = KL.kcyc_sq(m_arr)
    ent = {1: m_arr}
    ent[3] = KL.kmul(m2, ent[1])
    ent[5] = KL.kmul(m2, ent[3])
    ent[7] = KL.kmul(m2, ent[5])

    rows_list, row_of_step, row_of = [], [], {}
    r = 0
    for t, d in enumerate(int(x) for x in BN_X_W4_DIGITS):
        if d != 0 or t == 0:
            if d not in row_of:
                e = ent[abs(d)]
                if d < 0:
                    e = KL.kconj(e)
                row_of[d] = len(rows_list)
                rows_list.append(e)
            r = row_of[d]
        row_of_step.append(r)
    return torch.stack(rows_list), np.asarray(row_of_step, np.int32)


def pow_x_streamed(m_arr: torch.Tensor) -> torch.Tensor:
    """m^BN_X on the cyclotomic subgroup via the streamed w4 ladder."""
    stream, rows = pow_x_table(m_arr)
    return pow_ladder_stream(stream, BN_X_W4_DIGITS, rows)


# ---------------------------------------------------------------------------
# Kernel K12: bit ladder with every row written out (witness path)
# ---------------------------------------------------------------------------

#: MSB-first 64-bit decomposition of BN_X (the exp-offload exponent).
BN_X_BITS_MSB = np.asarray([(BN_X >> (63 - i)) & 1 for i in range(64)], np.int32)


def exp_bits_ladder_plain(x: torch.Tensor, bits) -> torch.Tensor:
    """Plain PyTorch version of kernel K12; returns the rows."""
    xv = kf12_view(x)
    f = F12.fq12_cap(F12.fq12_one((x.shape[-1],), x.device))
    rows = []
    for b in bits:
        f = F12.fq12_cyclotomic_sq(f)
        if int(b):
            f = F12.fq12_cap(F12.fq12_mul(f, xv))
        rows.append(kf12_from(f))
    return torch.stack(rows)


def exp_bits_ladder(x: torch.Tensor, bits):
    """x^e for the MSB-first ``bits`` of e, shared by every lane, with every
    ladder row: row_s = row_{s-1}^2 * x^{b_s} from row_{-1} = 1. Squares are
    cyclotomic, so x must lie in the cyclotomic subgroup (an easy-part
    output). x: KF12 [12, NLIMBS, B] -> (out, rows [len(bits), 12, NLIMBS,
    B]); out is rows[-1]."""
    bits = np.asarray(bits, np.int32)
    if bits.ndim != 1 or len(bits) == 0 or not np.isin(bits, (0, 1)).all():
        raise ValueError("bits must be a non-empty 0/1 vector")
    if not dispatch.on_cuda(x):
        rows = exp_bits_ladder_plain(x, bits)
        return rows[-1], rows
    lanes = x.shape[-1]
    dispatch.check_operand(x, "x", (12,), lanes)
    rows = torch.empty((len(bits),) + tuple(x.shape), dtype=torch.int32, device=x.device)
    EXP_BITS(x, torch.as_tensor(bits, device=x.device), len(bits), rows, lanes)
    return rows[-1], rows
