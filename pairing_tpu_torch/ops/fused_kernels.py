"""Kernels C, D, K12, K15, K16 and K17 — the fused Miller f-accumulation,
the x-power ladders, the witness bit ladder and the fused hard-part chain,
on the batch-last kernel layout.

Counterparts of ``pairing_tpu/ops/fused_kernels.py``'s ``miller_f_pallas``
(any number of pairs per product, optional per-step collection),
``pow_ladder_stream_pallas`` with its host side ``pow_x_streamed`` (D),
``exp_bits_ladder_pallas`` (K12), ``hard_chain_pallas`` (K15),
``pow_ladder_pallas`` (K16, plain NAF) and ``pow_ladder_w4_pallas`` (K17, w4
NAF with the table built in the kernel). Each kernel loops over its steps
inside one launch and keeps the Fq12 accumulator on the chip: in the thread
(K15), or for C, D, K12, K16 and K17 in shared memory, split over six threads
per lane; the plain versions below run the same schedule with the field
library.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from ..fields import fp as F
from ..fields import fp12 as F12
from ..fields.fp import Fp
from ..fields.fp2 import Fp2
from ..utils.bn254 import BN_X, BN_X_NAF, P, get_wnaf
from . import dispatch
from .dispatch import device_table
from . import klayout as KL
from .fq12_kernels import kf12_from, kf12_view

MILLER_F = dispatch.KERNELS["miller_f"]
MILLER_F_MULTI = dispatch.KERNELS["miller_f_multi"]
MILLER_F_COLLECT = dispatch.KERNELS["miller_f_collect"]
POW_LADDER_STREAM = dispatch.KERNELS["pow_ladder_stream"]
EXP_BITS = dispatch.KERNELS["exp_bits"]
POW_LADDER = dispatch.KERNELS["pow_ladder"]
POW_LADDER_W4 = dispatch.KERNELS["pow_ladder_w4"]
HARD_CHAIN = dispatch.KERNELS["hard_chain"]

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
    sched_t = device_table(tuple(map(tuple, sched.tolist())), tg.device)
    opts = dict(dtype=torch.int32, device=tg.device)
    out = torch.empty((12, F.NLIMBS, lanes), **opts)
    fs = torch.empty((len(sched), 12, F.NLIMBS, lanes), **opts) if collect else None
    kernel = MILLER_F_COLLECT if collect else MILLER_F_MULTI if n_pairs > 1 else MILLER_F
    kernel(tg, ch, ep, sched_t, len(sched), n_pairs, out, 0 if fs is None else fs, lanes)
    return (out, fs) if collect else out


# ---------------------------------------------------------------------------
# Kernel D: streamed windowed cyclotomic ladder
# ---------------------------------------------------------------------------


def wnaf_msb(e: int, w: int) -> np.ndarray:
    return np.asarray(list(reversed(get_wnaf(e, w))), np.int32)


#: MSB-first BN_X w=4 NAF digits (top digit consumed by ladder init).
BN_X_W4_DIGITS = wnaf_msb(BN_X, 4)


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
    sched_t = device_table(tuple(map(tuple, sched.tolist())), stream.device)
    out = torch.empty(stream.shape[1:], dtype=torch.int32, device=stream.device)
    POW_LADDER_STREAM(stream, sched_t, len(digits), out, lanes)
    return out


def pow_x_table(m_arr: torch.Tensor, digits=BN_X_W4_DIGITS):
    """Signed table of the w4 ladder over MSB-first ``digits`` (BN_X's by
    default) for m: (stream, rows).

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
    for t, d in enumerate(int(x) for x in digits):
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
    EXP_BITS(x, device_table(tuple(bits.tolist()), x.device), len(bits), rows, lanes)
    return rows[-1], rows


# ---------------------------------------------------------------------------
# Kernel K16: plain-NAF cyclotomic ladder
# ---------------------------------------------------------------------------

#: MSB-first BN_X NAF digits with the leading 1 consumed by ladder init.
BN_X_LADDER_DIGITS = np.asarray(list(reversed(BN_X_NAF))[1:], np.int32)


def pow_ladder_plain(m: torch.Tensor, mc: torch.Tensor, digits) -> torch.Tensor:
    """Plain PyTorch version of kernel K16."""
    mv, mcv = kf12_view(m), kf12_view(mc)
    f = mv
    for d in (int(x) for x in digits):
        f = F12.fq12_cyclotomic_sq(f)
        if d != 0:
            f = F12.fq12_cap(F12.fq12_mul(f, mv if d > 0 else mcv))
    return kf12_from(f)


def pow_ladder(m: torch.Tensor, mc: torch.Tensor, digits) -> torch.Tensor:
    """m^e on the cyclotomic subgroup, e given by its MSB-first NAF
    ``digits`` after the leading 1 (``BN_X_LADDER_DIGITS``): start at m, then
    per digit square and multiply by m (+1), ``mc`` = conj(m) (-1) or nothing
    (0). KF12 in and out."""
    digits = np.asarray(digits, np.int32)
    if digits.ndim != 1 or not np.isin(digits, (-1, 0, 1)).all():
        raise ValueError("digits must be a vector of NAF digits -1, 0, 1")
    if not dispatch.on_cuda(m, mc):
        return pow_ladder_plain(m, mc, digits)
    lanes = m.shape[-1]
    dispatch.check_operand(m, "m", (12,), lanes)
    dispatch.check_operand(mc, "mc", (12,), lanes)
    out = torch.empty_like(m)
    POW_LADDER(m, mc, device_table(tuple(digits.tolist()), m.device), len(digits), out, lanes)
    return out


# ---------------------------------------------------------------------------
# Kernel K17: w4 ladder with the table built in the kernel
# ---------------------------------------------------------------------------

#: Lanes per block of kernel K17 (``csrc/pow_w4.cu``'s K17_LANES): its
#: scratch table spans whole blocks, a column for every lane's group.
K17_BLOCK_LANES = 20


def _check_w4_digits(digits) -> np.ndarray:
    digits = np.asarray(digits, np.int32)
    if digits.ndim != 1 or len(digits) == 0 or digits[0] <= 0:
        raise ValueError("digits must be a non-empty vector with a positive top digit")
    if not np.isin(digits, (-7, -5, -3, -1, 0, 1, 3, 5, 7)).all():
        raise ValueError("w4 NAF digits are 0 or odd with |d| <= 7")
    return digits


def pow_ladder_w4_plain(m: torch.Tensor, digits) -> torch.Tensor:
    """Plain PyTorch version of kernel K17."""
    mv = kf12_view(m)
    m2 = F12.fq12_cyclotomic_sq(mv)
    tab = [mv]
    for _ in range(3):
        tab.append(F12.fq12_cap(F12.fq12_mul(m2, tab[-1])))

    def entry(d):
        e = tab[abs(d) >> 1]
        return F12.fq12_cap(F12.conjugate(e)) if d < 0 else e

    digits = [int(x) for x in digits]
    f = entry(digits[0])
    for d in digits[1:]:
        f = F12.fq12_cyclotomic_sq(f)
        if d != 0:
            f = F12.fq12_cap(F12.fq12_mul(f, entry(d)))
    return kf12_from(f)


def pow_ladder_w4(m: torch.Tensor, digits=BN_X_W4_DIGITS) -> torch.Tensor:
    """m^e on the cyclotomic subgroup for the MSB-first w = 4 NAF ``digits``
    of e (``BN_X_W4_DIGITS``), one launch: the kernel builds the table {m,
    m^3, m^5, m^7}, starts at the top digit's entry and then squares per
    digit, multiplying by the entry of each nonzero digit, conjugated when
    it is negative. KF12 in and out."""
    digits = _check_w4_digits(digits)
    if not dispatch.on_cuda(m):
        return pow_ladder_w4_plain(m, digits)
    lanes = m.shape[-1]
    dispatch.check_operand(m, "m", (12,), lanes)
    cols = -(-lanes // K17_BLOCK_LANES) * K17_BLOCK_LANES
    tab = torch.empty((3, 12, F.NLIMBS, cols), dtype=torch.int32, device=m.device)
    out = torch.empty_like(m)
    POW_LADDER_W4(m, device_table(tuple(digits.tolist()), m.device), len(digits), tab, cols, out,
                  lanes)
    return out


# ---------------------------------------------------------------------------
# Kernel K15: the fused hard-part chain, an Fq12 register program
# ---------------------------------------------------------------------------

OPC_MUL, OPC_CYC, OPC_CONJ, OPC_F1, OPC_F2, OPC_F3 = range(6)

#: (op, dst, a, b) schedule of the hard-part chain; dst never aliases a
#: MUL/CYC source (CONJ/FROB are slotwise and alias-safe). Registers r0..r3
#: preload m, mx, mx2, mx3; the result is in r5.
HARD_CHAIN_PROG = (
    (OPC_F1, 4, 0, 0),    # mp = frob1(m)
    (OPC_F2, 5, 0, 0),    # mp2
    (OPC_MUL, 6, 4, 5),   # mp*mp2
    (OPC_F3, 4, 0, 0),    # mp3
    (OPC_MUL, 5, 6, 4),   # y0  (held to the end)
    (OPC_F1, 4, 3, 0),    # mx3p
    (OPC_MUL, 6, 3, 4),   # mx3*mx3p
    (OPC_CONJ, 6, 6, 0),  # y6
    (OPC_CYC, 3, 6, 0),   # sq6 = y6^2        (mx3 dead)
    (OPC_F1, 4, 2, 0),    # mx2p
    (OPC_MUL, 6, 1, 4),   # mx*mx2p
    (OPC_CONJ, 6, 6, 0),  # y4
    (OPC_MUL, 4, 3, 6),   # t0a = sq6*y4
    (OPC_CONJ, 6, 2, 0),  # y5
    (OPC_MUL, 3, 4, 6),   # t0 = t0a*y5
    (OPC_F1, 4, 1, 0),    # mxp               (mx dead)
    (OPC_CONJ, 4, 4, 0),  # y3
    (OPC_MUL, 7, 4, 6),   # t1a = y3*y5
    (OPC_MUL, 4, 7, 3),   # t1 = t1a*t0
    (OPC_F2, 6, 2, 0),    # y2                (mx2 dead)
    (OPC_MUL, 7, 6, 3),   # t0b = y2*t0
    (OPC_CYC, 3, 4, 0),   # t1b = t1^2
    (OPC_MUL, 6, 3, 7),   # t1c = t1b*t0b
    (OPC_CYC, 3, 6, 0),   # t1d = t1c^2
    (OPC_CONJ, 6, 0, 0),  # y1 = conj(m)      (m dead)
    (OPC_MUL, 7, 3, 6),   # ta = t1d*y1
    (OPC_MUL, 4, 3, 5),   # tb = t1d*y0
    (OPC_CYC, 3, 7, 0),   # ta2 = ta^2
    (OPC_MUL, 5, 3, 4),   # final = ta2*tb
)
HARD_CHAIN_NREG = 8
HARD_CHAIN_OUT = 5

#: The slot maps of opcodes OPC_CONJ.. OPC_F3, as kernel E's slot programs.
SLOT_POWERS = (None, 1, 2, 3)


def hard_chain_plain(m, mx, mx2, mx3, prog=HARD_CHAIN_PROG,
                     out_reg: int = HARD_CHAIN_OUT) -> torch.Tensor:
    """Plain PyTorch version of kernel K15: ``prog`` (HARD_CHAIN_PROG)
    interpreted on a register file [HARD_CHAIN_NREG, 12, NLIMBS, B] with
    the field library; register ``out_reg``."""
    regs = torch.zeros((HARD_CHAIN_NREG,) + tuple(m.shape), dtype=torch.int32, device=m.device)
    for r, x in enumerate((m, mx, mx2, mx3)):
        regs[r] = x
    for op, dst, a, b in prog:
        x = kf12_view(regs[a])
        if op == OPC_MUL:
            y = F12.fq12_mul(x, kf12_view(regs[b]))
        elif op == OPC_CYC:
            y = F12.fq12_cyclotomic_sq(x)
        elif op == OPC_CONJ:
            y = F12.conjugate(x)
        else:
            y = F12.frobenius_map(x, SLOT_POWERS[op - OPC_CONJ])
        regs[dst] = kf12_from(y)
    return regs[out_reg].clone()


#: Registers 0-2 (m, mx, mx2) the kernel reads in place from its inputs; it
#: keeps registers 3-7 in shared memory. At most this many operations.
CHAIN_INPUT_REGS, CHAIN_MAX_OPS = 3, 64


def check_chain_program(prog, out_reg: int = HARD_CHAIN_OUT) -> None:
    """Kernel K15's checks of a register program, as its C entry makes them
    (``csrc/hard_chain.cu``): rows (op, dst, a, b) with an opcode of 0-5,
    registers 0-7, no write to the inputs' registers 0-2 and no cyclotomic
    square of one of them (CYC reads shared rows only), at most
    CHAIN_MAX_OPS rows. A destination may be one of the operation's sources:
    the kernel stores an operation's components only after every thread
    has read its operands. Raises ValueError."""
    rows = [tuple(int(v) for v in row) for row in prog]
    if len(rows) > CHAIN_MAX_OPS or not 0 <= out_reg < HARD_CHAIN_NREG:
        raise ValueError(f"chain program: {len(rows)} operations (at most {CHAIN_MAX_OPS}), "
                         f"result register {out_reg}")
    for t, row in enumerate(rows):
        op, dst, a, b = row  # ValueError unless (op, dst, a, b)
        if not OPC_MUL <= op <= OPC_F3 or not all(0 <= r < HARD_CHAIN_NREG for r in (dst, a, b)):
            raise ValueError(f"chain program row {t}: {row}: opcode or register out of range")
        if dst < CHAIN_INPUT_REGS:
            raise ValueError(f"chain program row {t}: {row} writes input register {dst}")
        if op == OPC_CYC and a < CHAIN_INPUT_REGS:
            raise ValueError(f"chain program row {t}: {row} squares input register {a}")


@lru_cache(maxsize=None)
def _hard_chain_consts():
    """The program and its four slot programs as host tensors: the C entry
    checks the program and folds the slot programs into the launch's
    parameter."""
    check_chain_program(HARD_CHAIN_PROG)
    prog = torch.as_tensor(np.asarray(HARD_CHAIN_PROG, np.int32))
    progs = [KL._slot_prog(pw) for pw in SLOT_POWERS]
    ops = torch.as_tensor(np.stack([p[0] for p in progs]))
    consts = torch.as_tensor(np.stack([p[1] for p in progs]))
    return prog, ops, consts


def hard_chain(m, mx, mx2, mx3) -> torch.Tensor:
    """The hard-part chain (final_exp_native.rs:130-169) given m and its
    three x-powers, as one launch; value-identical to the 29-launch chain of
    ``pairing.final_exp.hard_part_chain_k``. Cyclotomic-subgroup inputs,
    KF12 in and out."""
    if not dispatch.on_cuda(m, mx, mx2, mx3):
        return hard_chain_plain(m, mx, mx2, mx3)
    lanes = m.shape[-1]
    for name, x in (("m", m), ("mx", mx), ("mx2", mx2), ("mx3", mx3)):
        dispatch.check_operand(x, name, (12,), lanes)
    prog, ops, consts = _hard_chain_consts()
    out = torch.empty_like(m)
    HARD_CHAIN(m, mx, mx2, mx3, dispatch.Host(prog), len(HARD_CHAIN_PROG), dispatch.Host(ops),
               dispatch.Host(consts), HARD_CHAIN_OUT, out, lanes)
    return out
