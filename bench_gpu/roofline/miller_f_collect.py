"""Kernel C (``csrc/miller_f.cu``, ``k_miller_f``) in its collecting mode:
the Miller accumulation of ``lanes`` single pairs with f written after
every one of the 66 steps (the witness's Miller steps).

Per lane: 64 Fq12 squares and 91 sparse products, as in the K-pair mode with
one pair. Bytes: the line rows read, the schedule, and the 66 step values
plus f written.
"""

from . import LIMB_BYTES, Work
from . import miller_f_multi

KERNEL = "k_miller_f"


def work(lanes: int) -> Work:
    return miller_f_multi.work(lanes, 1)


def n_bytes(lanes: int) -> int:
    return (miller_f_multi.n_bytes(lanes, 1)
            + miller_f_multi.N_SCHEDULE * 12 * LIMB_BYTES * lanes)


def shapes_of(shapes: dict):
    return (shapes["lanes"],) if "lanes" in shapes else None
