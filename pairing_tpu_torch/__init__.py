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
returns the product of the K pairings. Witness generation, its npz format
and the two checkers are in ``pairing_tpu_torch.witness``.
"""

from .curves.g1 import G1, g1_from_ints
from .curves.g2 import G2, g2_from_ints
from .fields.fp12 import Fq12, fq12_from_int_coeffs, fq12_to_int_coeffs
from .pairing.api import multi_pairing, pairing
from .pairing.final_exp import final_exp
from .pairing.miller_loop import miller_loop, multi_miller_loop

__all__ = [
    "G1", "G2", "Fq12", "pairing", "multi_pairing", "miller_loop", "multi_miller_loop",
    "final_exp",
    "g1_from_ints", "g2_from_ints", "fq12_from_int_coeffs", "fq12_to_int_coeffs",
]
