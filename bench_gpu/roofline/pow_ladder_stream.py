"""Kernel D (``csrc/pow_ladder.cu``, ``k_pow_ladder_stream``): m^x on the
cyclotomic subgroup by the w4 NAF ladder over a streamed table, one of the
three x-powers of each final exponentiation.

The ladder starts at the top digit's entry, then takes a cyclotomic square
a digit and a dense product a nonzero digit (BN_X's w4 NAF: 63 squares and
the products of its nonzero digits below the top). Bytes: the table's rows
(one Fq12 a distinct signed digit), the schedule (two int32 a digit) and the
Fq12 written.
"""

from . import CYC_SQ, FQ12_DENSE, LIMB_BYTES, Work
from ..reference.bn254 import BN_X, get_wnaf

KERNEL = "k_pow_ladder_stream"
DIGITS = list(reversed(get_wnaf(BN_X, 4)))  # MSB first
TABLE_ROWS = len({d for d in DIGITS if d != 0})


def work(lanes: int) -> Work:
    below = DIGITS[1:]
    return lanes * (len(below) * CYC_SQ + sum(1 for d in below if d) * FQ12_DENSE)


def n_bytes(lanes: int) -> int:
    return (TABLE_ROWS + 1) * 12 * LIMB_BYTES * lanes + len(DIGITS) * 2 * 4


def shapes_of(shapes: dict):
    return (shapes["products"],) if "products" in shapes else None
