"""Carry values between the JAX package and the port as numpy limb arrays.

Both packages keep the same representation (int32 limbs ``[..., 21]``,
Montgomery R = 2^273), so a JAX ``Fp``/``G1``/``G2``/``Fq12`` crosses over
as its pytree leaves converted with ``numpy.asarray``. This module only
sees numpy arrays and never imports JAX.

It also reshapes point batches (``[K * B]`` pair-major to the ``[K, B]``
batch of the K-pair products) and reduces limb arrays of either package to
their field values, for comparing witness npz entries.

Leaf orders (the JAX pytree flatten order):
  G1:   (x, y)
  G2:   (x.c0, x.c1, y.c0, y.c1)
  Fq12: (s0.c0, s0.c1, s1.c0, s1.c1, ..., s5.c0, s5.c1)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..curves.g1 import G1
from ..curves.g2 import G2
from ..fields import fp as F
from ..fields.fp import Fp
from ..fields.fp2 import Fp2
from ..fields.fp12 import Fq12
from ..utils.bn254 import P


def fp_from_numpy(arr, device, bound: int = 2 * P,
                  limb_bound: int = F.SETTLED) -> Fp:
    """One limb array ``[..., 21]`` -> Fp with the given static envelope
    (the defaults hold for every capped value of either package)."""
    a = np.array(arr, dtype=np.int32, copy=True)
    if a.shape[-1] != F.NLIMBS:
        raise ValueError(f"limb axis is {a.shape[-1]}, want {F.NLIMBS}")
    return Fp(torch.as_tensor(a, device=device), bound, limb_bound)


def fp_to_numpy(a: Fp) -> np.ndarray:
    return a.limbs.detach().cpu().numpy()


def g1_from_leaves(leaves: Sequence, device, **env) -> G1:
    x, y = leaves
    return G1(fp_from_numpy(x, device, **env), fp_from_numpy(y, device, **env))


def g2_from_leaves(leaves: Sequence, device, **env) -> G2:
    x0, x1, y0, y1 = (fp_from_numpy(v, device, **env) for v in leaves)
    return G2(Fp2(x0, x1), Fp2(y0, y1))


def fq12_from_leaves(leaves: Sequence, device, **env) -> Fq12:
    if len(leaves) != 12:
        raise ValueError(f"{len(leaves)} leaves, want 12")
    c = [fp_from_numpy(v, device, **env) for v in leaves]
    return Fq12(tuple(Fp2(c[2 * i], c[2 * i + 1]) for i in range(6)))


def fq12_to_leaves(a: Fq12) -> list:
    out = []
    for s in a.s:
        out += [fp_to_numpy(s.c0), fp_to_numpy(s.c1)]
    return out


def map_limbs(a, fn):
    """A G1, G2 or Fq12 batch with ``fn`` applied to each coordinate's limb
    tensor ``[..., 21]`` (static envelopes kept): reshape, tile, slice."""
    def fp(x: Fp) -> Fp:
        return Fp(fn(x.limbs), x.bound, x.limb_bound)

    if isinstance(a, Fq12):
        return Fq12(tuple(Fp2(fp(s.c0), fp(s.c1)) for s in a.s))
    if isinstance(a, G1):
        return G1(fp(a.x), fp(a.y))
    return G2(Fp2(fp(a.x.c0), fp(a.x.c1)), Fp2(fp(a.y.c0), fp(a.y.c1)))


def reshape_points(a, shape):
    """A G1 or G2 batch -> the same points with batch shape ``shape``; e.g.
    K * B pairs in pair-major order -> the [K, B] batch of ``multi_pairing``."""
    return map_limbs(a, lambda limbs: limbs.reshape(tuple(shape) + (F.NLIMBS,)))


def limb_values(arr) -> np.ndarray:
    """Limb rows ``[..., 21]`` of either package (a witness npz entry, say)
    -> their values mod p as Python ints ``[...]``: equal arrays mean equal
    field elements in the same domain, whatever the representatives."""
    a = np.asarray(arr)
    if a.shape[-1] != F.NLIMBS:
        raise ValueError(f"limb axis is {a.shape[-1]}, want {F.NLIMBS}")
    weights = np.array([1 << (F.RADIX_BITS * i) for i in range(F.NLIMBS)], dtype=object)
    return (a.astype(object) * weights).sum(axis=-1) % P
