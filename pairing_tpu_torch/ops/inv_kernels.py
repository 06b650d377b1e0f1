"""Fq12 inversion of public Fq12 values on kernel G.

The counterpart of ``pairing_tpu/ops/inv_kernels.py``'s ``fq12_inv_pallas``
(:118), which runs two fq2_vm programs around a Fermat inverse of the norm.
Kernel G (``klayout.kinv``, ``csrc/fq12_inv.cu``) does the whole tower
inverse in one launch, so this is only the layout conversion around it.
"""

from __future__ import annotations

from ..fields.fp12 import Fq12
from .fq12_kernels import from_kernel_layout, to_kernel_layout
from .klayout import kinv


def fq12_inv(x: Fq12) -> Fq12:
    """x^-1 (any batch shape; x must be nonzero), value-identical to
    ``fields.fp12.fq12_inv``."""
    arr, bs = to_kernel_layout(x)
    return from_kernel_layout(kinv(arr), bs)
