"""Kernel C (``csrc/miller_f.cu``, ``k_miller_f``) in its K-pair mode: the
Miller accumulation of ``products`` products of ``pairs`` pairs each.

Per product, 64 loop steps square f once (an Fq12 square) and multiply it
by each pair's tangent line, 25 of them by each pair's chord line, and two
epilogue steps by each pair's two Frobenius chords: 64 squares and
91 x pairs sparse products. Bytes: the line rows it reads (6 Fq a line, one
column a pair), its schedule (66 steps of two int32), and f written.
"""

from . import FQ12_SPARSE, FQ12_SQ, LIMB_BYTES, Work

KERNEL = "k_miller_f"
N_SQUARES = 64
N_LINES = 64 + 25 + 2
N_SCHEDULE = 66


def work(products: int, pairs: int) -> Work:
    return products * (N_SQUARES * FQ12_SQ + pairs * N_LINES * FQ12_SPARSE)


def n_bytes(products: int, pairs: int) -> int:
    lines = N_LINES * 6 * LIMB_BYTES * pairs * products
    return lines + N_SCHEDULE * 2 * 4 + 12 * LIMB_BYTES * products


def shapes_of(shapes: dict):
    """The (products, pairs) of a run's shapes, or None if it has none."""
    if "products" not in shapes or "pairs" not in shapes:
        return None
    return shapes["products"], shapes["pairs"]
