"""Prover-committed auxiliary columns for the witness npz (schema v2).

PyTorch counterpart of ``pairing_tpu/witness/aux.py``. The reference's
witness model fills every wire, intermediates included, and the constraints
only check them (``set_witness``, pairing.rs:77-78). This module computes
every auxiliary wire from the primary columns, batched, so the npz is a
self-contained trace and :mod:`.constraints` derives nothing.

Committed aux entries (L = NLIMBS, B = flattened batch, K = pairs):

  tg_lambda  [64, K, B, 2, L]   tangent slope lam_t = 3*T_t.x^2 / (2*T_t.y)
  tg_sqx     [64, K, B, 2, L]   T_t.x^2 helper
  ch_mu      [n_adds, K, B, 2, L] chord slope at D_t + sgn(d_t)*Q
  ep_mu      [K, B, 2, L]       slope of S = E + Q1 (epilogue mixed add)
  f_sq       [64, B, 12, L]     f_{t-1}^2 (f_{-1} = 1)
  f_mid      [n_mid, B, 12, L]  factor-chain intermediates, (t asc, factor
                                asc) order: per step the K tangents, then on
                                addition steps the K chords; the last factor
                                lands on f_steps[t], so K*(1+[d_t!=0]) - 1
                                mids per step
  ep_mid     [2K-1, B, 12, L]   epilogue-chain intermediates (k-major,
                                line-minor; the last product is miller_out)
  inv_m      [B, 12, L]         miller_out^{-1} (easy part witness column)
  easy_mid   [B, 12, L]         conj(m) * inv_m
  easy_frob  [B, 12, L]         frob^2(easy_mid)
  exp_sq     [3, 64, B, 12, L]  ladder squares g_s = row_{s-1}^2 (row_{-1}=1)
  hard_frob  [7, B, 12, L]      (m1, m2, m3, mx1, mx21, mx22, mx31)
  hard_mid   [16, B, 12, L]     hard-part chain (h0, y0, y4p, y6p, sq6,
                                t0a, t0, t1a, t1, t0b, t1b, t1c, t1d, ta,
                                tb, ta2); the final product is final_out

The Fq12 chains run on the kernel layout through ``ops.klayout`` (dense
products kernel A, conjugate and Frobenius kernel E, the inverse kernel G on
a CUDA device; their plain versions on the CPU). A sparse line factor is
multiplied as a dense Fq12 with zero slots: the same value. The slopes are
Fq2 field-library code with the Fq inverse through kernel F. Every output is
settled to 13-bit digits; values are redundant Montgomery (< 2p) like the
primary columns.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..fields import fp as F
from ..fields import fp2 as F2
from ..fields import fp12 as F12
from ..fields.fp2 import Fp2
from ..ops import fp_kernels as FPK
from ..ops import klayout as KL
from ..ops.fq12_kernels import kf12_from

L = F.NLIMBS

#: KF12 component 2*slot + c  <->  npz coefficient slot + 6*c.
_TO_K = [s + 6 * c for s in range(6) for c in range(2)]
_FROM_K = [2 * i for i in range(6)] + [2 * i + 1 for i in range(6)]


def _k(arr: torch.Tensor) -> torch.Tensor:
    """Committed Fq12 columns [..., 12, L] -> KF12 [12, L, N] (N = the
    product of the leading axes)."""
    flat = arr.reshape(-1, 12, L)[:, _TO_K, :]
    return flat.permute(1, 2, 0).contiguous()


def _cols(kf: torch.Tensor, lead) -> torch.Tensor:
    """KF12 [12, L, N] -> settled columns [*lead, 12, L]."""
    out = kf.permute(2, 0, 1)[:, _FROM_K, :]
    return settle(out.reshape(tuple(lead) + (12, L)))


def settle(limbs: torch.Tensor) -> torch.Tensor:
    """Exact carry of limb rows [..., L] with values below 2^273 to digits in
    [0, 2^13): the same values, every limb inside the checker's range."""
    digits, carry = F._ripple_carry(limbs.to(F.DTYPE))
    if bool((carry != 0).any()):
        raise ValueError("limb rows do not fit 21 digits")
    return digits


def _fp2(arr: torch.Tensor) -> Fp2:
    """Committed [..., 2, L] -> Fp2 batch [...] (redundant Montgomery)."""
    return F2.from_limbs((arr[..., 0, :], arr[..., 1, :]))


def _fp2_cols(v: Fp2) -> torch.Tensor:
    c0, c1 = torch.broadcast_tensors(F._cap_2p(v.c0).limbs, F._cap_2p(v.c1).limbs)
    return settle(torch.stack([c0, c1], dim=-2))


def _line(rows: torch.Tensor, slots) -> torch.Tensor:
    """Line coefficients [..., 3, 2, L] -> a dense KF12 [12, L, N] with the
    three Fq2 values in ``slots`` and zeros elsewhere."""
    flat = rows.reshape(-1, 3, 2, L)
    kf = torch.zeros((12, L, flat.shape[0]), dtype=F.DTYPE, device=rows.device)
    for jj, s in enumerate(slots):
        for c in range(2):
            kf[2 * s + c] = flat[:, jj, c, :].transpose(0, 1)
    return kf


def compute_aux_columns(meta: Dict, data: Dict, device=None) -> Dict[str, torch.Tensor]:
    """All schema-v2 aux columns from the primary committed columns.

    ``data`` holds the primary entries (``serialize.witness_entries``, or a
    loaded npz) as tensors, on whose device the computation runs, or as
    numpy arrays, then moved to ``device``. Returns tensors on that device,
    settled to 13-bit digits."""
    K = int(meta["k"])
    n_steps = int(meta["n_steps"])
    add_steps = list(meta["add_steps"])
    digits = [meta["naf"][63 - t] for t in range(n_steps)]

    def get(name: str) -> torch.Tensor:
        v = data[name]
        if isinstance(v, np.ndarray):
            if device is None:
                raise ValueError("numpy entries need a device")
            v = torch.as_tensor(np.ascontiguousarray(v), device=device)
        return v.to(F.DTYPE)

    out = {}
    B = data["f_steps"].shape[1]

    # ---- slopes + x^2 helper (aux wires of schema rules 1-2) ----------
    aff_x, aff_y = get("r_affine_x"), get("r_affine_y")
    tops_x, tops_y = _fp2(aff_x[:n_steps]), _fp2(aff_y[:n_steps])
    qx, qy = _fp2(get("q_x")), _fp2(get("q_y"))

    def inv(v: Fp2) -> Fp2:
        return F2.inv(v, FPK.fp_inv)

    sqx = F2.cap(F2.square(tops_x))
    lam = F2.mul(F2.scale(sqx, 3), inv(F2.scale(tops_y, 2)))
    out["tg_sqx"] = _fp2_cols(sqx)
    out["tg_lambda"] = _fp2_cols(lam)

    ai = torch.as_tensor([n_steps + t for t in add_steps], device=aff_x.device)
    a_x, a_y = _fp2(aff_x[ai]), _fp2(aff_y[ai])
    pos = torch.as_tensor([digits[t] > 0 for t in add_steps], device=aff_x.device)
    pos = pos.view(-1, *([1] * (aff_x.dim() - 2)))
    nqy = F2.cap(F2.neg(qy))
    by = F2.from_limbs(tuple(torch.where(pos, F._cap_2p(a).limbs, b.limbs)
                             for a, b in ((qy.c0, nqy.c0), (qy.c1, nqy.c1))))
    mu = F2.mul(F2.sub(by, a_y), inv(F2.sub(qx, a_x)))
    out["ch_mu"] = _fp2_cols(mu)

    end_x, end_y = _fp2(aff_x[2 * n_steps]), _fp2(aff_y[2 * n_steps])
    q1x, q1y = _fp2(get("q1_x")), _fp2(get("q1_y"))
    out["ep_mu"] = _fp2_cols(F2.mul(F2.sub(q1y, end_y), inv(F2.sub(q1x, end_x))))

    # ---- Miller f-chain: squares + per-factor intermediates -----------
    f_steps = get("f_steps")  # [64, B, 12, L]
    dev = f_steps.device
    one = kf12_from(F12.fq12_one((B,), dev))  # KF12 [12, L, B]
    prev = torch.cat([one.unsqueeze(0), _k(f_steps[: n_steps - 1]).reshape(12, L, n_steps - 1, B)
                      .permute(2, 0, 1, 3)]).permute(1, 2, 0, 3).reshape(12, L, n_steps * B)
    f_sq = KL.kmul(prev, prev)  # lanes (t, b)
    out["f_sq"] = _cols(f_sq, (n_steps, B))

    tg = get("tg_lines")  # [64, K, B, 3, 2, L]
    cur, stage_a = f_sq, []
    for k in range(K):
        cur = KL.kmul(cur, _line(tg[:, k], F12.LINE_EQUAL_SLOTS))
        stage_a.append(cur.reshape(12, L, n_steps, B))
    ch = get("ch_lines")  # [n_adds, K, B, 3, 2, L]
    n_adds = len(add_steps)
    cur_a = stage_a[-1][:, :, add_steps].reshape(12, L, n_adds * B)
    stage_b = []
    for k in range(K):
        cur_a = KL.kmul(cur_a, _line(ch[:, k], F12.LINE_UNEQUAL_SLOTS))
        stage_b.append(cur_a.reshape(12, L, n_adds, B))

    j_of = {t: j for j, t in enumerate(add_steps)}
    mids = []
    for t in range(n_steps):
        n_factors = K * (2 if digits[t] != 0 else 1)
        for fi in range(n_factors - 1):
            mids.append(stage_a[fi][:, :, t] if fi < K else stage_b[fi - K][:, :, j_of[t]])
    out["f_mid"] = (_cols(torch.stack(mids, dim=2).reshape(12, L, -1), (len(mids), B))
                    if mids else torch.zeros((0, B, 12, L), dtype=F.DTYPE, device=dev))

    # ---- epilogue chain (k-major, line-minor) --------------------------
    ep = get("ep_lines")  # [2, K, B, 3, 2, L]
    cur_e = _k(f_steps[n_steps - 1])
    ep_mids = []
    for k in range(K):
        for j in (0, 1):
            cur_e = KL.kmul(cur_e, _line(ep[j, k], F12.LINE_UNEQUAL_SLOTS))
            ep_mids.append(cur_e)
    out["ep_mid"] = _cols(torch.stack(ep_mids[:-1], dim=2).reshape(12, L, -1), (2 * K - 1, B))

    # ---- easy part: inverse wire + chain (final_exp_native.rs:195-206)
    m = _k(get("miller_out"))
    inv_m = KL.kinv(m)
    easy_mid = KL.kmul(KL.kconj(m), inv_m)
    out["inv_m"] = _cols(inv_m, (B,))
    out["easy_mid"] = _cols(easy_mid, (B,))
    out["easy_frob"] = _cols(KL.kfrob(easy_mid, 2), (B,))

    # ---- ladder squares (the C12 AIR aux, final_exp_target.rs:89-147) -
    rows = get("exp_rows")  # [3, 64, B, 12, L]
    n_bits = rows.shape[1]
    prev_rows = _k(rows[:, : n_bits - 1]).reshape(12, L, 3, n_bits - 1, B)
    prev_rows = torch.cat([one.view(12, L, 1, 1, B).expand(12, L, 3, 1, B), prev_rows], dim=3)
    prev_rows = prev_rows.reshape(12, L, 3 * n_bits * B)
    out["exp_sq"] = _cols(KL.kmul(prev_rows, prev_rows), (3, n_bits, B))

    # ---- hard part (final_exp_native.rs:130-169) -----------------------
    e = _k(get("easy_out"))
    outs = get("exp_outs")
    mx, mx2, mx3 = (_k(outs[i]) for i in range(3))
    frob, mul, conj = KL.kfrob, KL.kmul, KL.kconj
    m1, m2, m3 = frob(e, 1), frob(e, 2), frob(e, 3)
    mx1, mx21 = frob(mx, 1), frob(mx2, 1)
    mx22, mx31 = frob(mx2, 2), frob(mx3, 1)
    out["hard_frob"] = _cols(torch.stack([m1, m2, m3, mx1, mx21, mx22, mx31], dim=2)
                             .reshape(12, L, -1), (7, B))
    h0 = mul(m2, m3)
    y0 = mul(m1, h0)
    y4p = mul(mx, mx21)
    y6p = mul(mx3, mx31)
    y1, y2, y3 = conj(e), mx22, conj(mx1)
    y4, y5, y6 = conj(y4p), conj(mx2), conj(y6p)
    sq6 = mul(y6, y6)
    t0a = mul(sq6, y4)
    t0 = mul(t0a, y5)
    t1a = mul(y3, y5)
    t1 = mul(t1a, t0)
    t0b = mul(y2, t0)
    t1b = mul(t1, t1)
    t1c = mul(t1b, t0b)
    t1d = mul(t1c, t1c)
    ta = mul(t1d, y1)
    tb = mul(t1d, y0)
    ta2 = mul(ta, ta)
    chain = (h0, y0, y4p, y6p, sq6, t0a, t0, t1a, t1, t0b, t1b, t1c, t1d, ta, tb, ta2)
    out["hard_mid"] = _cols(torch.stack(chain, dim=2).reshape(12, L, -1), (16, B))
    return out
