"""Kernel K12 (``csrc/exp_bits.cu``, ``k_exp_bits``): x^BN_X by the bit
ladder with every row written, one of the witness's three x-powers.

From one, each of the 64 MSB-first bits of BN_X takes a cyclotomic square
and each set bit a dense product by x. Bytes: x read, the bits, the 64 rows
written.
"""

from . import CYC_SQ, FQ12_DENSE, LIMB_BYTES, Work
from ..reference.bn254 import BN_X

KERNEL = "k_exp_bits"
BITS = [(BN_X >> (63 - i)) & 1 for i in range(64)]


def work(lanes: int) -> Work:
    return lanes * (len(BITS) * CYC_SQ + sum(BITS) * FQ12_DENSE)


def n_bytes(lanes: int) -> int:
    return (1 + len(BITS)) * 12 * LIMB_BYTES * lanes + len(BITS) * 4


def shapes_of(shapes: dict):
    return (shapes["lanes"],) if "lanes" in shapes else None
