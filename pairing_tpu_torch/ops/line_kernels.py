"""Kernel K — the Miller loop's tangent and chord lines (Phase C), with the
Jacobian to affine conversion folded in.

The counterpart of ``pairing_tpu/ops/line_kernels.py``'s ``lines_pallas``.
Inputs: the trajectory (tops, dbls [n, 6, NLIMBS, B]), the Phase N
inverses zinv [>= 2n, 2, NLIMBS, B] (tops at [t], post-doubles at [n + t]),
and pq [6, NLIMBS, B] = (px, py, qx.c0, qx.c1, qy.c0, qy.c1). Outputs: the
tangent lines tg [n, 6, NLIMBS, B] (slots 0, 3, 4) and, for each step with
a nonzero digit, its chord at ch[ch_rows[t]] (slots 2, 3, 5), the operands
of kernel C. The kernel runs one thread per (line, lane); its chord table,
(step, digit, row) for each step with a nonzero digit, is built once per
schedule and device.

``epilogue_lines`` runs the Miller loop's two epilogue chords, through end
and Q1 and through end + Q1 and -Q2, on K's chord (``k_epilogue_lines``,
``csrc/miller_epilogue.cu``): the operand ep [2, 6, NLIMBS, B] of kernel C.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..fields import fp as F
from ..fields import fp2 as F2
from ..fields.fp2 import Fp2
from ..pairing import lines as L
from . import dispatch
from .fq12_kernels import kfp2_view, kfp_view, kstack

LINES = dispatch.KERNELS["lines"]
EPILOGUE_LINES = dispatch.KERNELS["epilogue_lines"]


def line_schedule(digits: Sequence[int], ch_rows: Sequence[int], n_ch: int) -> np.ndarray:
    """Per-step (digit, chord row) pairs, int32 [n, 2]; the row of a
    zero-digit step is unused."""
    sched = np.zeros((len(digits), 2), np.int32)
    for t, (d, r) in enumerate(zip(digits, ch_rows)):
        sched[t, 0] = int(d)
        if d:
            if not 0 <= int(r) < n_ch:
                raise ValueError(f"step {t}: chord row {r} outside [0, {n_ch})")
            sched[t, 1] = int(r)
    return sched


def chord_table(digits, ch_rows, n_ch: int, device: torch.device) -> torch.Tensor:
    """The kernel's chord table, int32 [n_chords, 3] on ``device``: (step,
    digit, row) of each step with a nonzero digit, in step order: the rows
    of ``line_schedule`` that have a chord, with their steps; from
    ``dispatch.device_table``, built once per table and device."""
    sched = line_schedule(digits, ch_rows, n_ch)
    steps = np.flatnonzero(sched[:, 0])
    tab = np.column_stack([steps, sched[steps]])
    return dispatch.device_table(tuple(map(tuple, tab.tolist())), device).reshape(-1, 3)


def affine(state: torch.Tensor, zi: torch.Tensor):
    """(X zi^2, Y zi^3) from Jacobian rows [..., 6, NLIMBS, B]."""
    z = kfp2_view(zi)
    z2 = F2.square(z)
    z3 = F2.mul(z2, z)
    return (F2.cap(F2.mul(kfp2_view(state[..., 0:2, :, :]), z2)),
            F2.cap(F2.mul(kfp2_view(state[..., 2:4, :, :]), z3)))


def _line_rows(line3) -> torch.Tensor:
    """3 Fp2 of batch [k, B] -> [k, 6, NLIMBS, B]."""
    comps = []
    for v in line3:
        comps += [v.c0, v.c1]
    return kstack(comps).transpose(0, 1).contiguous()


def lines_plain(tops, dbls, zinv, pq, sched: np.ndarray, n_ch: int):
    """Plain PyTorch version of kernel K."""
    n = sched.shape[0]
    px, py = kfp_view(pq[0]), kfp_view(pq[1])
    qx, qy = kfp2_view(pq[2:4]), kfp2_view(pq[4:6])
    x, y = affine(tops[:n], zinv[:n])
    tg = _line_rows(L.line_equal(x, y, px, py))

    ch = torch.zeros((n_ch,) + tuple(tops.shape[1:]), dtype=tops.dtype, device=tops.device)
    steps = [t for t in range(n) if sched[t, 0] != 0]
    if steps:
        idx = torch.as_tensor(steps, device=tops.device)
        cx, cy = affine(dbls[idx], zinv[n + idx])
        nqy = F2.neg(qy)
        sy = [qy if sched[t, 0] > 0 else nqy for t in steps]
        sy = Fp2(*(F.Fp(torch.stack([F._cap_2p(getattr(v, c)).limbs for v in sy]),
                        2 * F.P, F.SETTLED) for c in ("c0", "c1")))
        rows = torch.as_tensor(sched[steps, 1], device=tops.device, dtype=torch.long)
        ch[rows] = _line_rows(L.line_unequal(cx, cy, qx, sy, px, py))
    return tg, ch


def lines(tops, dbls, zinv, pq, digits: Sequence[int], ch_rows: Sequence[int], n_ch: int):
    """(tg [n, 6, NLIMBS, B], ch [n_ch, 6, NLIMBS, B]) for the n = len(digits)
    steps; chord rows that no step writes are unspecified."""
    n = len(digits)
    if tops.shape[0] < n or dbls.shape[0] < n or zinv.shape[0] < 2 * n:
        raise ValueError("fewer trajectory or inverse rows than steps")
    if not dispatch.on_cuda(tops, dbls, zinv, pq):
        return lines_plain(tops, dbls, zinv, pq, line_schedule(digits, ch_rows, n_ch), n_ch)
    chords = chord_table(digits, ch_rows, n_ch, tops.device)
    lanes = tops.shape[-1]
    dispatch.check_operand(tops, "tops", (tops.shape[0], 6), lanes)
    dispatch.check_operand(dbls, "dbls", (dbls.shape[0], 6), lanes)
    dispatch.check_operand(zinv, "zinv", (zinv.shape[0], 2), lanes)
    dispatch.check_operand(pq, "pq", (6,), lanes)
    opts = dict(dtype=torch.int32, device=tops.device)
    tg = torch.empty((n, 6, F.NLIMBS, lanes), **opts)
    ch = torch.empty((n_ch, 6, F.NLIMBS, lanes), **opts)
    LINES(tops, dbls, zinv, pq, chords, n, chords.shape[0], tg, ch, lanes)
    return tg, ch


def _chord_rows(state, zi, partner, px, py) -> torch.Tensor:
    """Chord through the affine form of Jacobian rows [6, NLIMBS, B] (inverse
    Z ``zi``) and the partner rows [4, NLIMBS, B], as line rows [6, NLIMBS, B]."""
    x, y = affine(state, zi)
    line = L.line_unequal(x, y, kfp2_view(partner[0:2]), kfp2_view(partner[2:4]), px, py)
    return kstack([c for v in line for c in (v.c0, v.c1)])


def epilogue_lines_plain(end, st91, zinv, p, q1, nq2):
    """Plain PyTorch version of ``k_epilogue_lines``: the Miller loop's eager
    epilogue lines."""
    px, py = kfp_view(p[0]), kfp_view(p[1])
    return torch.stack([_chord_rows(end, zinv[0], q1, px, py),
                        _chord_rows(st91, zinv[1], nq2, px, py)])


def epilogue_lines(end, st91, zinv, p, q1, nq2):
    """ep [2, 6, NLIMBS, B]: the chord through affine(end) and q1 (slots 2,
    3, 5), then through affine(st91) and nq2, evaluated at P. end, st91:
    Jacobian rows [6, NLIMBS, B]; zinv [2, 2, NLIMBS, B] their inverse Z;
    p [2, NLIMBS, B] the rows px, py; q1, nq2 [4, NLIMBS, B]."""
    if not dispatch.on_cuda(end, st91, zinv, p, q1, nq2):
        return epilogue_lines_plain(end, st91, zinv, p, q1, nq2)
    lanes = end.shape[-1]
    for t, name, lead in ((end, "end", (6,)), (st91, "st91", (6,)), (zinv, "zinv", (2, 2)),
                          (p, "p", (2,)), (q1, "q1", (4,)), (nq2, "nq2", (4,))):
        dispatch.check_operand(t, name, lead, lanes)
    ep = torch.empty((2, 6, F.NLIMBS, lanes), dtype=torch.int32, device=end.device)
    EPILOGUE_LINES(end, st91, zinv, p, q1, nq2, ep, lanes)
    return ep
