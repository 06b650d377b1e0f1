"""Kernel H — the Miller loop's point trajectory (Phase B).

The counterpart of ``pairing_tpu/ops/curve_kernels.py``'s
``trajectory_pallas``. Input: affine Q as component rows [4, NLIMBS, B]
(x.c0, x.c1, y.c0, y.c1). Output: the Jacobian loop tops and post-doubles
[n_steps, 6, NLIMBS, B] (X, Y, Z as Fq2 row pairs) and the end state
[6, NLIMBS, B], every state in the (2p, settled) envelope. Its end-only
mode (``trajectory_end``) writes the end state alone: the G2 subgroup
check's [6x^2] Q ladder (``curves.g2.g2_in_subgroup``).

``epilogue_points`` runs the Miller loop's epilogue points on H's mixed
addition (``k_epilogue_points``, ``csrc/miller_epilogue.cu``): Q1 = psi(Q),
-Q2 = -psi(Q1) and end + Q1, which the reference leaves to XLA.

``g1_on_curve``, ``g2_on_curve`` and ``g2_subgroup_compare`` are the three
modes of ``k_validate`` (``csrc/validate.cu``), one launch each: the curve
equations and the compare that ends the G2 subgroup check, exact mod p,
operands read in place through their strides as ``k_canonical`` reads them
(``canon_kernels.operand_table``). CPU tensors take the plain versions
(``curves.g1.g1_on_curve_plain``, ``curves.g2.g2_on_curve_plain``,
:func:`g2_subgroup_compare_plain`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..curves.g1 import G1, g1_on_curve_plain
from ..curves.g2 import (G2, G2Jac, g2_on_curve_plain, jac_cap, jac_double, jac_from_affine,
                         jac_mixed_add, neg_twisted_frobenius, twisted_frobenius)
from ..fields import fp as F
from ..fields import fp2 as F2
from ..fields.fp import NLIMBS, Fp
from . import dispatch
from .canon_kernels import operand_table
from .fq12_kernels import kfp2_view, kstack

TRAJECTORY = dispatch.KERNELS["trajectory"]
TRAJECTORY_END = dispatch.KERNELS["trajectory_end"]
EPILOGUE_POINTS = dispatch.KERNELS["epilogue_points"]
G1_ON_CURVE = dispatch.KERNELS["g1_on_curve"]
G2_ON_CURVE = dispatch.KERNELS["g2_on_curve"]
G2_SUBGROUP_COMPARE = dispatch.KERNELS["g2_subgroup_compare"]


def jac_rows(p: G2Jac) -> torch.Tensor:
    """G2Jac of batch [..., B] -> rows [6, ..., NLIMBS, B]."""
    return kstack([p.X.c0, p.X.c1, p.Y.c0, p.Y.c1, p.Z.c0, p.Z.c1])


def g2_rows(p: G2) -> torch.Tensor:
    """G2 of batch [B] -> rows [4, NLIMBS, B] (x.c0, x.c1, y.c0, y.c1)."""
    return kstack([p.x.c0, p.x.c1, p.y.c0, p.y.c1])


def g2_view(rows: torch.Tensor) -> G2:
    """Rows [4, NLIMBS, B] -> G2 views, envelope (2p, settled)."""
    return G2(kfp2_view(rows[0:2]), kfp2_view(rows[2:4]))


def jac_view(rows: torch.Tensor) -> G2Jac:
    """Rows [6, NLIMBS, B] -> G2Jac views, envelope (2p, settled)."""
    return G2Jac(kfp2_view(rows[0:2]), kfp2_view(rows[2:4]), kfp2_view(rows[4:6]))


def _start(q_arr: torch.Tensor):
    """(Q, -Q, R = Q in Jacobian form) of the affine rows [4, NLIMBS, B]."""
    q = g2_view(q_arr)
    return q, G2(q.x, F2.cap(F2.neg(q.y))), jac_cap(jac_from_affine(q))


def _step(cur: G2Jac, d: int, q: G2, nq: G2):
    """One step from R: (2R, 2R + sign(d) Q or 2R)."""
    dbl = jac_cap(jac_double(cur))
    return dbl, jac_cap(jac_mixed_add(dbl, q if d > 0 else nq)) if d else dbl


def trajectory_plain(q_arr: torch.Tensor, digits: Sequence[int]):
    """Plain PyTorch version of kernel H."""
    q, nq, cur = _start(q_arr)
    tops, dbls = [], []
    for d in digits:
        tops.append(jac_rows(cur))
        dbl, cur = _step(cur, d, q, nq)
        dbls.append(jac_rows(dbl))
    return torch.stack(tops), torch.stack(dbls), jac_rows(cur)


def trajectory_end_plain(q_arr: torch.Tensor, digits: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of kernel H's end-only mode: the same steps,
    only the running state kept."""
    q, nq, cur = _start(q_arr)
    for d in digits:
        _, cur = _step(cur, d, q, nq)
    return jac_rows(cur)


def _launch(kernel, q_arr: torch.Tensor, digits, with_steps: bool):
    lanes = q_arr.shape[-1]
    dispatch.check_operand(q_arr, "q", (4,), lanes)
    n = len(digits)
    opts = dict(dtype=torch.int32, device=q_arr.device)
    tops = torch.empty((n, 6, NLIMBS, lanes), **opts) if with_steps else None
    dbls = torch.empty((n, 6, NLIMBS, lanes), **opts) if with_steps else None
    end = torch.empty((6, NLIMBS, lanes), **opts)
    table = dispatch.device_table(tuple(int(d) for d in digits), q_arr.device)
    kernel(q_arr, table, n, tops, dbls, end, lanes)
    return tops, dbls, end


def trajectory(q_arr: torch.Tensor, digits: Sequence[int]):
    """Per NAF digit d (MSB first): emit the loop top R, double it, emit the
    double, and add sign(d) Q on a nonzero digit. Returns (tops, dbls, end)."""
    if not dispatch.on_cuda(q_arr):
        return trajectory_plain(q_arr, [int(d) for d in digits])
    return _launch(TRAJECTORY, q_arr, digits, True)


def trajectory_end(q_arr: torch.Tensor, digits: Sequence[int]) -> torch.Tensor:
    """The end state [6, NLIMBS, B] of :func:`trajectory`'s ladder, without
    its tops and post-doubles: from R = Q, per digit R = 2R + sign(d) Q (or
    2R on a zero digit); [e] Q for the MSB-first signed digits of e with its
    leading 1 consumed."""
    if not dispatch.on_cuda(q_arr):
        return trajectory_end_plain(q_arr, [int(d) for d in digits])
    return _launch(TRAJECTORY_END, q_arr, digits, False)[2]


def epilogue_points_plain(q_arr: torch.Tensor, end: torch.Tensor):
    """Plain PyTorch version of ``k_epilogue_points``: the Miller loop's
    eager epilogue points (miller_loop_native.rs:183-188)."""
    q1 = twisted_frobenius(g2_view(q_arr))
    nq2 = neg_twisted_frobenius(q1)
    return g2_rows(q1), g2_rows(nq2), jac_rows(jac_cap(jac_mixed_add(jac_view(end), q1)))


def epilogue_points(q_arr: torch.Tensor, end: torch.Tensor):
    """From the capped affine Q rows [4, NLIMBS, B] and kernel H's end state
    [6, NLIMBS, B]: (q1, nq2, st91) with q1 = twisted_frobenius(Q) and nq2 =
    neg_twisted_frobenius(q1) as rows [4, NLIMBS, B], st91 = end + q1
    (madd-2007-bl) as rows [6, NLIMBS, B]; every value below 2p with
    settled limbs."""
    if not dispatch.on_cuda(q_arr, end):
        return epilogue_points_plain(q_arr, end)
    lanes = q_arr.shape[-1]
    dispatch.check_operand(q_arr, "q", (4,), lanes)
    dispatch.check_operand(end, "end", (6,), lanes)
    opts = dict(dtype=torch.int32, device=q_arr.device)
    q1 = torch.empty((4, NLIMBS, lanes), **opts)
    nq2 = torch.empty((4, NLIMBS, lanes), **opts)
    st91 = torch.empty((6, NLIMBS, lanes), **opts)
    EPILOGUE_POINTS(q_arr, end, q1, nq2, st91, lanes)
    return q1, nq2, st91


def _validate(kernel, mode: int, operands: Sequence[Fp]) -> torch.Tensor:
    """One launch of ``k_validate``'s ``mode`` on the operands broadcast over
    their batch: bool [batch]."""
    bs = torch.broadcast_shapes(*(x.batch_shape for x in operands))
    out = torch.empty(bs, dtype=torch.bool, device=operands[0].device)
    if out.numel():
        table, keep = operand_table(operands, bs)  # keep: alive through the launch
        kernel(dispatch.Host(table), mode, out, out.numel())
    return out


def g1_on_curve(p: G1) -> torch.Tensor:
    """y^2 == x^3 + 3 exactly mod p: bool [batch]."""
    if not dispatch.on_cuda(p.x.limbs, p.y.limbs):
        return g1_on_curve_plain(p)
    return _validate(G1_ON_CURVE, 0, [p.x, p.y])


def g2_on_curve(q: G2) -> torch.Tensor:
    """y^2 == x^3 + 3/xi exactly mod p: bool [batch]."""
    comps = [q.x.c0, q.x.c1, q.y.c0, q.y.c1]
    if not dispatch.on_cuda(*(c.limbs for c in comps)):
        return g2_on_curve_plain(q)
    return _validate(G2_ON_CURVE, 1, comps)


def g2_subgroup_compare_plain(q: G2, end: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``k_validate``'s compare mode."""
    acc = jac_view(end)
    psi = twisted_frobenius(q)
    zz = F2.square(acc.Z)
    zzz = F2.mul(zz, acc.Z)
    z_nonzero = ~(F.fp_is_zero(acc.Z.c0) & F.fp_is_zero(acc.Z.c1))
    return F2.eq(acc.X, F2.mul(psi.x, zz)) & F2.eq(acc.Y, F2.mul(psi.y, zzz)) & z_nonzero


def g2_subgroup_compare(q: G2, end: torch.Tensor) -> torch.Tensor:
    """From Q of batch [B] and the Jacobian end state [6, NLIMBS, B] of its
    [6x^2] ladder (:func:`trajectory_end`): X == psi(Q).x Z^2, Y == psi(Q).y
    Z^3 and Z != 0, exactly mod p, with psi = ``twisted_frobenius``: bool
    [B]."""
    comps = [q.x.c0, q.x.c1, q.y.c0, q.y.c1]
    if not dispatch.on_cuda(end, *(c.limbs for c in comps)):
        return g2_subgroup_compare_plain(q, end)
    lanes = end.shape[-1]
    dispatch.check_operand(end, "end", (6,), lanes)
    acc = jac_view(end)
    state = [acc.X.c0, acc.X.c1, acc.Y.c0, acc.Y.c1, acc.Z.c0, acc.Z.c1]
    return _validate(G2_SUBGROUP_COMPARE, 2, comps + state)
