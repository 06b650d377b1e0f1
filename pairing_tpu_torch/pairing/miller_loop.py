"""Batched optimal-ate Miller loop, for products of K >= 1 pairs per lane.

PyTorch counterpart of ``pairing_tpu/pairing/miller_loop.py``'s
kernel-resident pipeline ``_miller_pallas_resident`` (:234), with the fused
epilogue of ``_fused_miller_with_epilogue`` (:677) and its witness
collection. Points carry a leading pairs axis K ([K, *inner]); the K * B
pairs (B = prod(inner)) are flattened pair-major, so pair k of product b is
lane ``k * B + b``. Every phase runs in the batch-last kernel layout
[rows, NLIMBS, lanes]:

  Phase B — point trajectory in Jacobian coordinates (kernel H): 64
            doublings plus a mixed addition on each nonzero NAF digit;
  Phase N — one bulk normalization of the 130 states (64 loop tops, 64
            post-doubles, end, end + Q1): prefix products (kernel I), one
            Fq2 inversion of the total (``k_fq2_inv``, kernel F's chain
            inside), running inverse (kernel J);
  Phase C — the 64 tangent and 25 chord lines with the affine conversion
            folded in (kernel K);
  Phase D — f-accumulation over the K * B line columns into B products
            (kernel C), one shared square per step, the two epilogue lines
            fused in as trailing steps.

Phases B, N and C work per lane, so they run unchanged over K * B lanes. The
epilogue (the twisted Frobenius points Q1 and -Q2 with end + Q1, then the
lines through end and Q1 and through end + Q1 and -Q2), which the reference
leaves to XLA, runs on CUDA tensors as two kernels of its own,
``k_epilogue_points`` in N and ``k_epilogue_lines`` in C
(``ops.curve_kernels.epilogue_points``, ``ops.line_kernels.epilogue_lines``);
on CPU tensors their plain versions run the plain tensor code. Each phase
is a ``torch.profiler.record_function`` range named ``miller_loop.<phase>``;
N's and C's kernels and glue have sub-ranges of their own (N: ``.points``,
``.prefix``, ``.inverse``, ``.running``; C: ``.lines``, ``.epilogue``). The
witness collection adds ``witness.affine_export`` (kernel K13).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.profiler import record_function

from ..utils.bn254 import SIX_U_PLUS_2_NAF
from ..fields import fp as F
from ..fields import fp2 as F2
from ..fields.fp import Fp
from ..fields.fp2 import Fp2
from ..fields.fp12 import Fq12
from ..curves.g1 import G1
from ..curves.g2 import G2
from ..ops import curve_kernels as CK
from ..ops import fp_kernels as FPK
from ..ops import line_kernels as LK
from ..ops import norm_kernels as NK
from ..ops.fq12_kernels import from_kernel_layout, kstack
from ..ops.fq2_vm import affine_export
from ..ops.fused_kernels import miller_f
from ..utils.interop import map_limbs, reshape_points

# ---------------------------------------------------------------------------
# Static schedule
# ---------------------------------------------------------------------------

assert SIX_U_PLUS_2_NAF[64] == 1, "top NAF digit must be 1"
#: digit for Miller step t (t = 0..63 corresponds to NAF index i = 63-t).
STEP_DIGITS: Tuple[int, ...] = tuple(SIX_U_PLUS_2_NAF[63 - t] for t in range(64))
#: steps with a chord (addition) part.
ADD_STEPS: Tuple[int, ...] = tuple(t for t, d in enumerate(STEP_DIGITS) if d != 0)
N_STEPS = 64
N_ADDS = len(ADD_STEPS)  # 25 in-loop additions

#: Phase D schedule: loop steps (flag 1 on chord steps), then 2 epilogue steps.
MILLER_FLAGS = tuple(1 if d != 0 else 0 for d in STEP_DIGITS) + (2, 2)
#: chord row of each step (-1: none).
CHORD_ROWS = tuple(ADD_STEPS.index(t) if t in ADD_STEPS else -1
                   for t in range(N_STEPS)) + (-1, -1)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


def _flat_fp(a: Fp) -> Fp:
    return Fp(a.limbs.reshape(-1, F.NLIMBS), a.bound, a.limb_bound)


def _flat_fp2(a: Fp2) -> Fp2:
    return Fp2(_flat_fp(a.c0), _flat_fp(a.c1))


def _miller_core(qs: G2, ps: G1, collect: bool = False):
    """Multi-Miller product over the leading pairs axis of [K, *inner]
    points. Returns (f as KF12 [12, NLIMBS, B], trace): the trace is None
    unless ``collect``, then the witness payload of the reference's
    ``_miller_pallas_resident(..., collect=True)`` (:359-420)."""
    kshape = ps.batch_shape
    if qs.batch_shape != kshape or len(kshape) < 1:
        raise ValueError(f"want points of one batch shape [K, *inner]: G1 {kshape}, "
                         f"G2 {qs.batch_shape}")
    q, p, _ = flatten_pairs(qs, ps)
    qc = G2(F2.cap(q.x), F2.cap(q.y))
    px, py = F._cap_2p(p.x), F._cap_2p(p.y)
    with record_function("miller_loop.B_trajectory"):
        q_rows = kstack([qc.x.c0, qc.x.c1, qc.y.c0, qc.y.c1])
        tops, dbls, end = CK.trajectory(q_rows, STEP_DIGITS)

    with record_function("miller_loop.N_normalize"):
        with record_function("miller_loop.N_normalize.points"):
            # the epilogue points (miller_loop_native.rs:183-188)
            q1, nq2, st91 = CK.epilogue_points(q_rows, end)
        z = torch.cat([tops[:, 4:6], dbls[:, 4:6], end[None, 4:6], st91[None, 4:6]])
        with record_function("miller_loop.N_normalize.prefix"):
            prefix, total = NK.prefix_products(z)
        with record_function("miller_loop.N_normalize.inverse"):
            tinv = FPK.fp2_inv(total)
        with record_function("miller_loop.N_normalize.running"):
            zinv = NK.running_inverse(z, prefix, tinv)

    with record_function("miller_loop.C_lines"):
        with record_function("miller_loop.C_lines.lines"):
            pq = kstack([px, py, qc.x.c0, qc.x.c1, qc.y.c0, qc.y.c1])
            tg, ch = LK.lines(tops, dbls, zinv, pq, STEP_DIGITS, CHORD_ROWS[:N_STEPS], N_ADDS)
        with record_function("miller_loop.C_lines.epilogue"):
            ep = LK.epilogue_lines(end, st91, zinv[2 * N_STEPS:], pq[0:2], q1, nq2)

    with record_function("miller_loop.D_miller_f"):
        out = miller_f(tg, ch, ep, MILLER_FLAGS, CHORD_ROWS, n_pairs=kshape[0], collect=collect)
    if not collect:
        return out, None
    f, fs = out

    # The witness payload, every entry in the reference's public layout.
    with record_function("witness.affine_export"):
        # serialize order: tops 0..63, post-doubles 64..127, end 128, end + Q1 129;
        # the kernel reads each segment where it lies
        aff = affine_export((tops[:, 0:4], dbls[:, 0:4], end[None, 0:4], st91[None, 0:4]), zinv)
    inner = kshape[1:]
    trace = {
        "f_steps": tuple((_public(fs[:N_STEPS, 2 * i], inner), _public(fs[:N_STEPS, 2 * i + 1], inner))
                         for i in range(6)),
        "r_affine": G2(_public_fp2(aff[:, 0:2], kshape), _public_fp2(aff[:, 2:4], kshape)),
        "tangent_lines": _public_line(tg, kshape),
        "chord_lines": _public_line(ch, kshape),
        "epilogue_lines": (_public_line(ep[0], kshape), _public_line(ep[1], kshape)),
        "q1": reshape_points(CK.g2_view(q1), kshape),
        "neg_q2": reshape_points(CK.g2_view(nq2), kshape),
    }
    return f, trace


def _public(rows: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Component rows [*lead, NLIMBS, lanes] -> limbs [*lead, *shape, NLIMBS]."""
    lead = tuple(rows.shape[:-2])
    return rows.transpose(-1, -2).reshape(lead + tuple(shape) + (F.NLIMBS,))


def _public_fp2(rows: torch.Tensor, shape: tuple) -> Fp2:
    """Rows [*lead, 2, NLIMBS, lanes] (c0, c1) -> Fp2 of batch [*lead, *shape]."""
    return F2.from_limbs((_public(rows.select(-3, 0), shape), _public(rows.select(-3, 1), shape)))


def _public_line(rows: torch.Tensor, shape: tuple):
    """Line rows [*lead, 6, NLIMBS, lanes] -> 3 Fp2 of batch [*lead, *shape]."""
    return tuple(_public_fp2(rows[..., 2 * j:2 * j + 2, :, :], shape) for j in range(3))


def _add_pairs_axis(a):
    """A G1 or G2 batch [*inner] -> the same points as [1, *inner]."""
    return map_limbs(a, lambda limbs: limbs.unsqueeze(0))


def flatten_pairs(q: G2, p: G1):
    """Public points with any batch shape -> flat [B] points and the shape."""
    bs = p.batch_shape
    if q.batch_shape != bs:
        raise ValueError(f"batch shapes differ: G1 {bs}, G2 {q.batch_shape}")
    return (G2(_flat_fp2(q.x), _flat_fp2(q.y)),
            G1(_flat_fp(p.x), _flat_fp(p.y)), bs)


def multi_miller_loop_k(qs: G2, ps: G1) -> torch.Tensor:
    """Kernel-layout multi-Miller product: points of batch [K, *inner] ->
    f as KF12 [12, NLIMBS, prod(inner)], for chaining with final_exp_k."""
    return _miller_core(qs, ps)[0]


def miller_loop_k(q: G2, p: G1) -> torch.Tensor:
    """Miller loop over a flat batch [B]; returns f as KF12 [12, NLIMBS, B]
    (the K = 1 case of :func:`multi_miller_loop_k`)."""
    return multi_miller_loop_k(_add_pairs_axis(q), _add_pairs_axis(p))


def multi_miller_loop_collect(qs: G2, ps: G1):
    """:func:`multi_miller_loop_k` with the witness trace: (f, trace)."""
    return _miller_core(qs, ps, collect=True)


def multi_miller_loop(qs: G2, ps: G1) -> Fq12:
    """multi_miller_loop_native (miller_loop_native.rs:324-326): the product
    of K pairings' Miller values with shared squarings; the leading axis of
    qs/ps is K, the result has batch shape [*inner]."""
    return from_kernel_layout(multi_miller_loop_k(qs, ps), qs.batch_shape[1:])


def miller_loop(q: G2, p: G1) -> Fq12:
    """miller_loop_native (miller_loop_native.rs:320-322), batched."""
    qf, pf, bs = flatten_pairs(q, p)
    return from_kernel_layout(miller_loop_k(qf, pf), bs)
