"""Serialized witness-trace format (npz, schema v2) + loader.

PyTorch counterpart of ``pairing_tpu/witness/serialize.py``: the same
entries, shapes, dtypes and ``meta``, so either package's checkers read
either package's files. :mod:`.verify` is the value-level replay checker and
:mod:`.constraints` the limb-level AIR identity checker.

Conventions: every field element is radix-2^13, 21-limb int32, Montgomery
domain (value = limbs * R^-1 mod p, R = 2^273), redundant (< 2p). Fq2
values carry a trailing [2, L] (c0, c1); Fq12 values a trailing [12, L] in
the reference's ``MyFq12.coeffs`` order (coeffs[i] = slot-i real part,
coeffs[i+6] = slot-i u part). ``B`` is the flattened batch, ``K`` the
multi-pairing pairs axis.

Entries::

  meta                 JSON: version, nlimbs, radix_bits, p, r_mont, domain,
                       k, bn_x, naf (65 signed digits), add_steps, n_steps
  p_x, p_y             [K, B, L]               G1 inputs
  q_x, q_y             [K, B, 2, L]            G2 inputs
  r_affine_x/_y        [130, K, B, 2, L]       affine trajectory: 0..63 loop
                                               tops, 64..127 post-doubles,
                                               128 end, 129 end + Q1
  tg_lines             [64, K, B, 3, 2, L]     tangent coeffs (slots 0,3,4)
  ch_lines             [n_adds, K, B, 3, 2, L] chord coeffs (slots 2,3,5) of
                                               the steps meta.add_steps
  ep_lines             [2, K, B, 3, 2, L]      epilogue chords (end, Q1),
                                               (end + Q1, -Q2)
  q1_x/_y, nq2_x/_y    [K, B, 2, L]            twisted-Frobenius points
  f_steps              [64, B, 12, L]          Miller accumulator per step
  miller_out, easy_out [B, 12, L]
  exp_bits             [64]                    BN_X bits, LSB first
  exp_rows             [3, 64, B, 12, L]       x-power ladder rows
  exp_outs             [3, B, 12, L]           mx, mx2, mx3
  final_out            [B, 12, L]              pairing result

plus the schema-v2 auxiliary columns of :mod:`.aux`.

Limb range: the constraint checker range-checks every committed limb to
[0, 2^13]. Kernel and plain outputs may carry settled limbs of 2^13 + 1, so
the writer settles every column with an exact, value-preserving carry
before writing: every written limb is a digit in [0, 2^13). The reference's
writer copies its columns as they come.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..curves.g1 import G1
from ..curves.g2 import G2
from ..fields import fp as F
from ..fields.fp12 import Fq12
from ..pairing.miller_loop import ADD_STEPS, N_STEPS
from ..utils.bn254 import BN_X, P, SIX_U_PLUS_2_NAF
from . import aux as AUX
from .aux import settle

FORMAT_VERSION = 2

#: Axis of the flattened batch B in each primary entry (exp_bits has none).
BATCH_AXIS = {
    "p_x": 1, "p_y": 1, "q_x": 1, "q_y": 1, "r_affine_x": 2, "r_affine_y": 2,
    "tg_lines": 2, "ch_lines": 2, "ep_lines": 2, "q1_x": 1, "q1_y": 1,
    "nq2_x": 1, "nq2_y": 1, "f_steps": 1, "miller_out": 0, "easy_out": 0,
    "exp_rows": 2, "exp_outs": 1, "final_out": 0,
}


def _fp_arr(v) -> torch.Tensor:
    """Fp batch [...] -> [..., L]."""
    return F._cap_2p(v).limbs


def _fp2_arr(v) -> torch.Tensor:
    """Fp2 batch [...] -> [..., 2, L]."""
    c0, c1 = torch.broadcast_tensors(_fp_arr(v.c0), _fp_arr(v.c1))
    return torch.stack([c0, c1], dim=-2)


def _fq12_arr(a: Fq12) -> torch.Tensor:
    """Fq12 batch [...] -> [..., 12, L] in MyFq12.coeffs order."""
    return _fq12_limbtree_arr(tuple((_fp_arr(s.c0), _fp_arr(s.c1)) for s in a.s))


def _fq12_limbtree_arr(t) -> torch.Tensor:
    """6 x (c0, c1) limb tensors [..., L] -> [..., 12, L]."""
    comps = torch.broadcast_tensors(*[t[i][0] for i in range(6)], *[t[i][1] for i in range(6)])
    return torch.stack(comps, dim=-2)


def _lines_arr(line3) -> torch.Tensor:
    """3-tuple of Fp2 [...] -> [..., 3, 2, L]."""
    return torch.stack([_fp2_arr(c) for c in line3], dim=-3)


def witness_entries(p: G1, q: G2, out: Fq12, trace: Dict,
                    lanes: Optional[Sequence[int]] = None) -> Tuple[Dict, Dict[str, torch.Tensor]]:
    """(meta, primary entries) of a ``pairing_witness`` /
    ``multi_pairing_witness`` result, as tensors on the trace's device.

    ``p``/``q`` carry the batch shape used for the witness call; the trace's
    pairs axis K (1 for a single pairing) is preserved. ``lanes`` keeps only
    those indices of the flattened batch B (all when None)."""
    mt = trace["miller"]
    ft = trace["final_exp"]
    aff = mt["r_affine"]
    K = aff.x.c0.limbs.shape[1]

    # normalize p/q to carry the pairs axis ([K, *inner]) like the trace
    has_k = q.x.c0.limbs.ndim == aff.x.c0.limbs.ndim - 1
    px_a, py_a = _fp_arr(p.x), _fp_arr(p.y)
    qx_a, qy_a = _fp2_arr(q.x), _fp2_arr(q.y)
    if not has_k:
        px_a, py_a, qx_a, qy_a = px_a[None], py_a[None], qx_a[None], qy_a[None]

    def collapse(a: torch.Tensor, lead: int, tail: int) -> torch.Tensor:
        """Flatten the batch dims between ``lead`` leading and ``tail``
        trailing structural axes into one B axis."""
        shape = tuple(a.shape)
        return a.reshape(shape[:lead] + (-1,) + shape[len(shape) - tail:])

    entries = {
        "p_x": collapse(px_a, 1, 1),
        "p_y": collapse(py_a, 1, 1),
        "q_x": collapse(qx_a, 1, 2),
        "q_y": collapse(qy_a, 1, 2),
        "r_affine_x": collapse(_fp2_arr(aff.x), 2, 2),
        "r_affine_y": collapse(_fp2_arr(aff.y), 2, 2),
        "tg_lines": collapse(_lines_arr(mt["tangent_lines"]), 2, 3),
        "ch_lines": collapse(_lines_arr(mt["chord_lines"]), 2, 3),
        "ep_lines": torch.stack([collapse(_lines_arr(e), 1, 3) for e in mt["epilogue_lines"]]),
        "q1_x": collapse(_fp2_arr(mt["q1"].x), 1, 2),
        "q1_y": collapse(_fp2_arr(mt["q1"].y), 1, 2),
        "nq2_x": collapse(_fp2_arr(mt["neg_q2"].x), 1, 2),
        "nq2_y": collapse(_fp2_arr(mt["neg_q2"].y), 1, 2),
        "f_steps": collapse(_fq12_limbtree_arr(mt["f_steps"]), 1, 2),
        "miller_out": collapse(_fq12_arr(trace["miller_out"]), 0, 2),
        "easy_out": collapse(_fq12_arr(ft["easy_part_out"]), 0, 2),
        "exp_bits": ft["exp_inputs"][0].exp_bits.reshape(-1, 64)[0],
        "exp_rows": torch.stack([collapse(_fq12_limbtree_arr(r), 1, 2)
                                 for r in ft["exp_trace_rows"]]),
        "exp_outs": torch.stack([collapse(_fq12_arr(x), 0, 2) for x in ft["exp_outputs"]]),
        "final_out": collapse(_fq12_arr(out), 0, 2),
    }
    if lanes is not None:
        idx = torch.as_tensor(list(lanes), dtype=torch.long, device=entries["p_x"].device)
        entries = {k: v if k not in BATCH_AXIS else v.index_select(BATCH_AXIS[k], idx)
                   for k, v in entries.items()}
    meta = {
        "version": FORMAT_VERSION,
        "nlimbs": F.NLIMBS,
        "radix_bits": F.RADIX_BITS,
        "p": str(P),
        "r_mont": str(F.R_MONT),
        "domain": "montgomery-redundant-2p",
        "k": K,
        "bn_x": str(BN_X),
        "naf": list(SIX_U_PLUS_2_NAF),
        "add_steps": list(ADD_STEPS),
        "n_steps": N_STEPS,
    }
    return meta, entries


def save_pairing_witness(path: str, p: G1, q: G2, out: Fq12, trace: Dict,
                         lanes: Optional[Sequence[int]] = None) -> None:
    """Serialize a ``pairing_witness`` result (witness/trace.py) to npz.

    The primary columns and the schema-v2 aux columns (computed on the
    trace's device) are settled to 13-bit digits and written with the
    reference's names, shapes, dtypes and meta. ``lanes`` writes only those
    indices of the flattened batch B."""
    meta, entries = witness_entries(p, q, out, trace, lanes)
    entries.update(AUX.compute_aux_columns(meta, entries))
    arrays = {k: (v if k == "exp_bits" else settle(v)).cpu().numpy().astype(np.int32)
              for k, v in entries.items()}
    np.savez_compressed(path, meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                        **arrays)


def load_pairing_witness(path: str) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Load an npz witness; returns (meta dict, entry dict)."""
    z = np.load(path)
    meta = json.loads(bytes(z["meta"]).decode())
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"unknown witness format version {meta['version']}")
    data = {k: z[k] for k in z.files if k != "meta"}
    return meta, data
