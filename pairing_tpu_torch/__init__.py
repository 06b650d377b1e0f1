"""pairing_tpu_torch — the BN254 pairing framework ported to PyTorch and CUDA.

A second package beside ``pairing_tpu`` (the JAX reference), with the same
subpackages and representation (21 limbs of 13 bits in int32, Montgomery
R = 2^273, values < 2p). Plain tensor code is PyTorch; the TPU kernels on
the main path are hand-written CUDA for Hopper (``csrc/``), built with nvcc
at first use and launched on CUDA tensors. CPU tensors take each kernel's
plain PyTorch version. Nothing here imports JAX.

Public entry points mirror the reference:

    from pairing_tpu_torch import pairing, g1_from_ints, g2_from_ints
    out = pairing(g1_from_ints(ps, "cuda"), g2_from_ints(qs, "cuda"))
    fq12_to_int_coeffs(out)

``multi_pairing(ps, qs)`` takes points with a leading pairs axis K and
returns the product of the K pairings. ``validate_inputs(p, q)`` masks the
lanes whose P is on the curve and whose Q is on the twist and in G2.
Witness generation, its npz format and the two checkers are in
``pairing_tpu_torch.witness``; chunked, checkpointed streaming in
``pairing_tpu_torch.parallel.runner.pairing_stream`` (configured by
``utils.config.PairingConfig``).
"""

from .curves.g1 import G1, g1_from_ints, g1_neg, g1_on_curve, g1_to_ints
from .curves.g2 import (
    G2,
    g2_from_ints,
    g2_in_subgroup,
    g2_neg,
    g2_on_curve,
    g2_to_ints,
    neg_twisted_frobenius,
    twisted_frobenius,
)
from .fields.fp12 import Fq12, fq12_from_int_coeffs, fq12_to_int_coeffs
from .pairing.api import multi_pairing, pairing, validate_inputs
from .pairing.final_exp import final_exp
from .pairing.miller_loop import miller_loop, multi_miller_loop

__all__ = [
    "G1",
    "G2",
    "Fq12",
    "pairing",
    "multi_pairing",
    "miller_loop",
    "multi_miller_loop",
    "final_exp",
    "g1_from_ints",
    "g1_to_ints",
    "g1_neg",
    "g1_on_curve",
    "g2_from_ints",
    "g2_to_ints",
    "g2_neg",
    "g2_on_curve",
    "g2_in_subgroup",
    "validate_inputs",
    "twisted_frobenius",
    "neg_twisted_frobenius",
    "fq12_from_int_coeffs",
    "fq12_to_int_coeffs",
]
