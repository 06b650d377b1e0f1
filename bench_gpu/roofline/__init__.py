"""The least time a kernel could take on one H100, from the work its
algorithm needs at a call's shapes, whatever kernel implements it.

Work is counted at the field level, as ``chip_smoke.py`` counts it (Fq
products, Fq squares and Montgomery reductions of the tower: an Fq2 product
by Karatsuba is 3 Fq products, an Fq12 product 54, an Fq12 square 36, a
product by a sparse line 39, a cyclotomic square 18, each output
coefficient reduced once; additions and small constants are not counted),
and each of those is then costed at the fewest 32-bit IMAD issues a
254-bit Montgomery product needs on 32-bit words:

  * a 254-bit value is 8 words; a 32 x 32 -> 64-bit word product takes two
    issues at the IMAD rate (IMAD.LO and IMAD.HI, or one IMAD.WIDE, which
    runs at half the rate);
  * an Fq product is 8 x 8 word products: 128 issues;
  * an Fq square needs the 36 distinct word products: 72;
  * a word-by-word Montgomery reduction takes, per word, one low product for
    m and 8 word products for m * p: 8 x (1 + 8 x 2) = 136.

So an Fq product with its reduction costs 264 issues, against 903 IMADs on
the port's 13-bit limbs (441 limb products and a 462-IMAD reduction, one
IMAD a limb product): a kernel's share of this bound is 0.29 times its
share of the 13-bit bound. No implementation of the same field-level
algorithm on the IMAD pipe can take fewer issues than these, whatever its
limbs, so a share cannot pass 100% unless the algorithm changes. A kernel
moved onto the tensor cores (int8 MMA) does its products on another unit:
its bound would need re-costing in a later change to the benchmark.

Peaks (the H100 SXM's; a card's power limit is reported beside each run):
132 SMs x 64 IMAD a clock x 1980 MHz = 16.73 T IMAD/s (the CUDA throughput
table for compute capability 9.0, which ``tools/fb_variants.py`` measured at
63.67-64.02 a clock), and 3.35 TB/s of HBM3. Bytes count each input read
once and each output written once.
"""

from __future__ import annotations

import dataclasses

SMS = 132
IMADS_PER_SM_CLOCK = 64
CLOCK_HZ = 1980e6
IMADS_PER_S = SMS * IMADS_PER_SM_CLOCK * CLOCK_HZ
HBM_BYTES_PER_S = 3.35e12
LIMB_BYTES = 21 * 4  # one Fq element as the port stores it: 21 int32 limbs


@dataclasses.dataclass(frozen=True)
class Costs:
    """IMAD issues of one Fq product, Fq square and Montgomery reduction."""

    product: int
    square: int
    reduction: int


WORDS = 8
#: the benchmark's costs: 32-bit words, two issues a word product
WORD32 = Costs(product=WORDS * WORDS * 2, square=WORDS * (WORDS + 1) // 2 * 2,
               reduction=WORDS * (1 + WORDS * 2))
#: ``chip_smoke.py``'s costs on 21 limbs of 13 bits, one IMAD a limb product
LIMB13 = Costs(product=21 * 21, square=21 * 22 // 2, reduction=21 * (1 + 21))


@dataclasses.dataclass(frozen=True)
class Work:
    """Field-level work: Fq products, Fq squares, Montgomery reductions."""

    products: int = 0
    squares: int = 0
    reductions: int = 0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.products + other.products, self.squares + other.squares,
                    self.reductions + other.reductions)

    def __mul__(self, k: int) -> "Work":
        return Work(self.products * k, self.squares * k, self.reductions * k)

    __rmul__ = __mul__

    def issues(self, costs: Costs = WORD32) -> int:
        return (self.products * costs.product + self.squares * costs.square
                + self.reductions * costs.reduction)


FQ12_DENSE = Work(products=54, reductions=12)
FQ12_SQ = Work(products=36, reductions=12)
FQ12_SPARSE = Work(products=39, reductions=12)
CYC_SQ = Work(products=18, reductions=12)


def least_seconds(work: Work, n_bytes: int) -> float:
    """The larger of the work at the IMAD rate and the bytes at the HBM rate."""
    return max(work.issues() / IMADS_PER_S, n_bytes / HBM_BYTES_PER_S)
