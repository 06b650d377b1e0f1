"""Batched witness generation for in-circuit pairing checks.

PyTorch counterpart of ``pairing_tpu/witness/trace.py``. The wire values of
the reference's circuit side (miller_loop_target.rs / final_exp_target.rs)
are the intermediate values of the native algorithm; this module generates
them as batched tensors: the per-step Miller accumulator, the affine
trajectory, every line coefficient and the x-power ladder rows, so that a
downstream proof system can constrain each transition without re-running
the pairing.

The Miller half is the kernel pipeline with collection
(``miller_loop.multi_miller_loop_collect``: kernel C writes every step, kernel
K13 exports the affine trajectory). The final exponentiation runs the easy
part and the hard-part chain of the main path, with the three x-powers from
kernel K12, the bit ladder the C12 exp-offload AIR constrains
(final_exp_target.rs:89-147), inside a ``witness.exp_ladders`` range.

``fq12_exp_u64`` mirrors the STARK offload component C12 with per-lane
runtime u64 exponents; it is plain tensor code, as it is XLA code in the
reference, and is not on the kernel path.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..curves.g1 import G1
from ..curves.g2 import G2
from ..fields import fp12 as F12
from ..fields.fp import Fp
from ..fields.fp2 import Fp2
from ..fields.fp12 import Fq12
from ..ops.fq12_kernels import from_kernel_layout, to_kernel_layout
from ..ops.fused_kernels import BN_X_BITS_MSB, exp_bits_ladder
from ..pairing.final_exp import easy_part_k, hard_part_chain_k
from ..pairing.miller_loop import _add_pairs_axis, multi_miller_loop_collect
from ..utils.bn254 import BN_X


def miller_loop_witness(q: G2, p: G1) -> Tuple[Fq12, Dict]:
    """Single-pair Miller loop + full witness trace."""
    return multi_miller_loop_witness(_add_pairs_axis(q), _add_pairs_axis(p))


def multi_miller_loop_witness(qs: G2, ps: G1) -> Tuple[Fq12, Dict]:
    """Multi-Miller product over the leading pairs axis K, with its trace."""
    f, trace = multi_miller_loop_collect(qs, ps)
    return from_kernel_layout(f, ps.batch_shape[1:]), trace


# ---------------------------------------------------------------------------
# Fq12 exponentiation offload (C12 analogue)
# ---------------------------------------------------------------------------


class ExpU64Input(NamedTuple):
    """Mirror of starky-bn254's Fq12ExpU64InputTarget {x, offset, exp_val}.

    ``exp_bits``: int32 bit tensor [..., 64], LSB first (the bit
    decomposition the AIR constrains). Use :func:`exp_bits_from_u64`.
    """

    x: Fq12
    offset: Fq12
    exp_bits: torch.Tensor


def exp_bits_from_u64(values, device, batch_shape=()) -> torch.Tensor:
    """Host u64 ints -> [..., 64] int32 LSB-first bit tensor on ``device``."""
    arr = np.asarray(
        [[(int(v) >> i) & 1 for i in range(64)] for v in np.atleast_1d(values)],
        dtype=np.int32,
    )
    if np.ndim(values) == 0:
        arr = arr[0]
    out = torch.as_tensor(arr, device=device)
    if batch_shape:
        out = out.expand(tuple(batch_shape) + (64,))
    return out


def _limb_tree(a: Fq12):
    """Fq12 -> 6 x (c0, c1) limb tensors (the reference's limb pytree)."""
    return tuple((s.c0.limbs, s.c1.limbs) for s in a.s)


def _select(mask: torch.Tensor, a: Fq12, b: Fq12) -> Fq12:
    """Per-lane a where mask else b; both in the (2p, settled) envelope."""
    def fp(x: Fp, y: Fp) -> Fp:
        return Fp(torch.where(mask[..., None], x.limbs, y.limbs), x.bound, x.limb_bound)

    return Fq12(tuple(Fp2(fp(x.c0, y.c0), fp(x.c1, y.c1)) for x, y in zip(a.s, b.s)))


def fq12_exp_u64(inp: ExpU64Input, collect_trace: bool = False):
    """offset * x^exp with runtime 64-bit exponents (MSB-first ladder).

    Branchless per lane: each of 64 steps squares (dense) and multiplies by
    x or one depending on the lane's exponent bit. Returns (out, rows):
    with ``collect_trace`` the per-bit ladder state, 6 x (c0, c1) limb
    tensors [64, ..., NLIMBS] (the rows a STARK AIR would constrain,
    final_exp_target.rs:141), else None."""
    x = F12.fq12_cap(inp.x)
    inner = x.batch_shape
    one = F12.fq12_cap(F12.fq12_one(inner, x.device))
    bits = inp.exp_bits
    res, rows = one, []
    for i in range(63, -1, -1):
        bit = torch.broadcast_to(bits[..., i] == 1, inner)
        res = F12.fq12_cap(F12.fq12_mul(F12.fq12_sq(res), _select(bit, x, one)))
        if collect_trace:
            rows.append(res)
    out = F12.fq12_cap(F12.fq12_mul(F12.fq12_cap(inp.offset), res))
    if not collect_trace:
        return out, None
    stacked = tuple((torch.stack([r.s[i].c0.limbs for r in rows]),
                     torch.stack([r.s[i].c1.limbs for r in rows])) for i in range(6))
    return out, stacked


# ---------------------------------------------------------------------------
# Final exponentiation witness
# ---------------------------------------------------------------------------


def final_exp_witness(m: Fq12) -> Tuple[Fq12, Dict]:
    """Final exponentiation + witness trace (final_exp_target.rs:65-150):
    the three x-power exponentiations are the bit-ladder exp offloads, their
    inputs recorded like Fq12ExpU64InputTarget."""
    arr, bs = to_kernel_layout(F12.fq12_cap(m))
    return final_exp_witness_k(arr, bs)


def final_exp_witness_k(arr: torch.Tensor, bs: tuple) -> Tuple[Fq12, Dict]:
    """Kernel-layout final-exp witness of KF12 ``arr`` (batch ``bs``): easy
    part, three bit-ladder exp offloads with every row (kernel K12), and
    the hard-part chain; one layout conversion per trace array at the end."""
    f0 = easy_part_k(arr)
    with record_function("witness.exp_ladders"):
        mx, rows0 = exp_bits_ladder(f0, BN_X_BITS_MSB)
        mx2, rows1 = exp_bits_ladder(mx, BN_X_BITS_MSB)
        mx3, rows2 = exp_bits_ladder(mx2, BN_X_BITS_MSB)
    with record_function("final_exp.hard_chain"):
        out_arr = hard_part_chain_k(f0, mx, mx2, mx3)

    def back(a):
        return from_kernel_layout(a, bs)

    def rows_tree(rows):
        # [64, 12, NLIMBS, B] -> 6 x (c0, c1) limb tensors [64, *bs, NLIMBS]
        flat = rows.transpose(-1, -2).reshape((rows.shape[0], 12) + tuple(bs) + (rows.shape[-2],))
        return tuple((flat[:, 2 * i], flat[:, 2 * i + 1]) for i in range(6))

    f0_f = back(f0)
    mxs = (back(mx), back(mx2), back(mx3))
    exp_bits = exp_bits_from_u64(BN_X, arr.device, bs)
    one = F12.fq12_one(bs, arr.device)
    trace = {
        "easy_part_out": f0_f,
        "exp_inputs": [ExpU64Input(x=v, offset=one, exp_bits=exp_bits)
                       for v in (f0_f, mxs[0], mxs[1])],
        "exp_trace_rows": [rows_tree(r) for r in (rows0, rows1, rows2)],
        "exp_outputs": mxs,
    }
    return back(out_arr), trace


def pairing_witness(p: G1, q: G2) -> Tuple[Fq12, Dict]:
    """pairing_circuit analogue (pairing.rs:24-38): full pairing + traces."""
    return multi_pairing_witness(_add_pairs_axis(p), _add_pairs_axis(q))


def multi_pairing_witness(ps: G1, qs: G2) -> Tuple[Fq12, Dict]:
    """Groth16-shape witness: the product of K pairings with shared
    squarings (multi_miller_loop_BN_native, miller_loop_native.rs:192) and
    one final exponentiation, with the full per-transition trace. ``ps``/
    ``qs`` carry a leading pairs axis K. The Miller output stays in the
    kernel layout between the two stages. A ``witness.pairing`` range."""
    with record_function("witness.pairing"):
        inner = ps.batch_shape[1:]
        f_arr, mtrace = multi_miller_loop_collect(qs, ps)
        out, ftrace = final_exp_witness_k(f_arr, inner)
        f = from_kernel_layout(f_arr, inner)
        return out, {"miller": mtrace, "final_exp": ftrace, "miller_out": f}
