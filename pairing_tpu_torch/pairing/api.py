"""Top-level pairing facade (reference: src/pairing.rs:20-38).

``pairing(p, q)`` composes the Miller loop and the final exponentiation
over a batch of independent pairs: p/q carry any leading batch shape (the
same for both) and the result is the batch of Fq12 pairing values.
``multi_pairing(ps, qs)`` is the product of K pairings with one shared final
exponentiation (the Groth16-verification shape): the leading axis of ps/qs
is K. Between the two public edges everything stays in the batch-last
kernel layout. ``validate_inputs(p, q)`` is the batched mask of inputs the
pairing is defined on. Each entry is a ``torch.profiler.record_function``
range: ``pairing.pairing``, ``pairing.multi_pairing``, ``validate.inputs``.
Inside the first two, ``pairing.flatten`` (``pairing`` only) holds the
flattening of the public points and ``pairing.output`` the conversion of
the result from the kernel layout to the public Fq12.
"""

from __future__ import annotations

from torch.profiler import record_function

from ..curves.g1 import G1, g1_on_curve
from ..curves.g2 import G2, g2_in_subgroup, g2_on_curve
from ..fields.fp12 import Fq12
from ..ops.fq12_kernels import from_kernel_layout
from .final_exp import final_exp_k
from .miller_loop import flatten_pairs, miller_loop_k, multi_miller_loop_k


def pairing(p: G1, q: G2) -> Fq12:
    """e(P, Q) = final_exp(miller_loop(Q, P)); batched."""
    with record_function("pairing.pairing"):
        with record_function("pairing.flatten"):
            qf, pf, bs = flatten_pairs(q, p)
        f = final_exp_k(miller_loop_k(qf, pf))
        with record_function("pairing.output"):
            return from_kernel_layout(f, bs)


def multi_pairing(ps: G1, qs: G2) -> Fq12:
    """prod_k e(P_k, Q_k) over the leading axis K of ps/qs, with shared
    squarings in the Miller loop and one final exponentiation; batched over
    the remaining axes."""
    with record_function("pairing.multi_pairing"):
        f = final_exp_k(multi_miller_loop_k(qs, ps))
        with record_function("pairing.output"):
            return from_kernel_layout(f, ps.batch_shape[1:])


def validate_inputs(p: G1, q: G2, subgroup_check: bool = True):
    """Batched input validation mask for ``pairing(p, q)``.

    Returns bool [batch]: True iff P is on E (which rejects the (0,0)
    infinity encoding, since b != 0), Q is on the twist, and — with
    ``subgroup_check`` — Q lies in the r-torsion subgroup G2
    (``curves.g2.g2_in_subgroup``: one launch of kernel H's end-only mode
    on CUDA tensors, 127 doublings and 39 additions a lane; gate it off for
    trusted inputs). G1 needs no subgroup check: the BN254 G1 cofactor is
    1, so every curve point qualifies. The pairing itself assumes validated
    inputs; on invalid points its output is unspecified.
    """
    with record_function("validate.inputs"):
        ok = g1_on_curve(p) & g2_on_curve(q)
        if subgroup_check:
            ok = ok & g2_in_subgroup(q)
        return ok
