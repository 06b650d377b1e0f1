"""Limb rows of the program's outputs read as field values.

The program keeps an Fq element as 21 limbs of 13 bits (int32), in the
Montgomery domain with R = 2^273, the value below 2p. These helpers read
such rows back; they know only that representation, nothing of the code
that made the rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .bn254 import P

RADIX_BITS = 13
NLIMBS = 21
R_MONT = 1 << (RADIX_BITS * NLIMBS)
R_INV = pow(R_MONT, -1, P)
_WEIGHTS = np.array([1 << (RADIX_BITS * i) for i in range(NLIMBS)], dtype=object)


def values(rows) -> np.ndarray:
    """Limb rows ``[..., 21]`` -> their field values (Python ints, out of
    the Montgomery domain, reduced mod p) ``[...]``."""
    a = np.asarray(rows)
    if a.shape[-1] != NLIMBS:
        raise ValueError(f"limb axis is {a.shape[-1]}, want {NLIMBS}")
    return (a.astype(object) * _WEIGHTS).sum(axis=-1) * R_INV % P


def montgomery_rows(vals) -> np.ndarray:
    """Field values ``[...]`` -> limb rows ``[..., 21]`` of x R mod p."""
    a = np.asarray(vals, dtype=object)
    flat = [digits(int(v) * R_MONT % P) for v in a.reshape(-1)]
    return np.asarray(flat, dtype=np.int64).reshape(a.shape + (NLIMBS,))


def digits(value: int) -> list:
    """The 21 base-2^13 digits of ``value`` (value < 2^273)."""
    return [(value >> (RADIX_BITS * i)) & ((1 << RADIX_BITS) - 1) for i in range(NLIMBS)]


def normalized(limbs: torch.Tensor) -> torch.Tensor:
    """Limb rows ``[..., 21]`` -> base-2^13 digits of the same integer
    (int64; a nonzero carry out of the top limb is added to it, so that a
    value of 2^273 or more, or a negative one, never reads as a digit row)."""
    x = limbs.to(torch.int64)
    out, carry = [], torch.zeros_like(x[..., 0])
    for i in range(NLIMBS):
        c = x[..., i] + carry
        out.append(c & ((1 << RADIX_BITS) - 1))
        carry = c >> RADIX_BITS
    out[-1] = out[-1] + (carry << RADIX_BITS)
    return torch.stack(out, dim=-1)


def montgomery_matches(limbs: torch.Tensor, expected: torch.Tensor) -> torch.Tensor:
    """bool ``[...]``: the limb rows ``limbs [..., 21]`` hold the field values
    ``expected`` as the program must hold them: x R mod p or x R mod p + p.
    ``expected [..., 2, 21]`` gives those two digit rows for each element
    (from :func:`representatives`)."""
    d = normalized(limbs).unsqueeze(-2)
    return (d == expected).all(dim=-1).any(dim=-1)


def representatives(value: int) -> list:
    """The two digit rows a value below 2p may take in the Montgomery domain."""
    m = value * R_MONT % P
    return [digits(m), digits(m + P)]
