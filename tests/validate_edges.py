"""Seeded operands for holding ``k_validate`` (``csrc/validate.cu``) to its
plain versions; shared by ``test_torch_validate_kernel.py`` (the CPU route
and a model of the kernel's formulas) and ``test_torch_cuda.py`` (the
card).

Lane i holds the pair of kind ``KINDS[i % 8]``:

  ``valid``         P in G1, Q in G2;
  ``outside_g2``    Q on the twist outside G2 (its end state's X is moved
                    by one in :func:`validate_case`);
  ``p_5_5``         P = (5, 5), off the curve;
  ``plus_p``        a valid pair whose every coordinate is the
                    representative x + p (below 2p);
  ``p_0_0``         P = (0, 0), the encoding of infinity;
  ``off_twist``     Q = (x, y + 1), off the twist;
  ``lazy``          a valid pair whose coordinates are x + 3p, the low limb
                    raised by 2^13 and the next lowered by one where that
                    is not negative (the same value; bound 4p, limbs up to
                    2^14);
  ``z_zero``        a valid pair whose end state has Z = (p, 0), zero mod p.

The first ``PERIOD`` lanes are made on the host from ``DISTINCT`` seeded
points of each group; lane i >= ``PERIOD`` repeats lane i % ``PERIOD``.
"""

import random
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from pairing_tpu_torch.curves.g1 import G1
from pairing_tpu_torch.curves.g2 import G2
from pairing_tpu_torch.fields import fp as F
from pairing_tpu_torch.fields.fp import Fp
from pairing_tpu_torch.fields.fp2 import Fp2
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.utils import bn254 as c

KINDS = ("valid", "outside_g2", "p_5_5", "plus_p", "p_0_0", "off_twist", "lazy", "z_zero")
DISTINCT = 8
PERIOD = 192
P = c.P


@lru_cache(maxsize=None)
def _points(seed: int):
    rng = random.Random(seed)
    g1s = [o.g1_mul(c.G1_GEN, rng.randrange(1, c.R_SCALAR)) for _ in range(DISTINCT)]
    g2s = [o.g2_mul((c.G2_GEN_X, c.G2_GEN_Y), rng.randrange(1, c.R_SCALAR))
           for _ in range(DISTINCT)]
    outside = next(q for q in (o.g2_point_from_x((x0, 1)) for x0 in range(1, 200))
                   if q is not None and not o.g2_in_subgroup(q))
    return g1s, g2s, outside


def _fq2_mont(v) -> Tuple[int, int]:
    return tuple(x % P * F.R_MONT % P for x in v)


def _column(values: List[int], kinds: List[str], device) -> Fp:
    """Montgomery values (canonical) -> an Fp of batch [lanes] in each lane's
    representation (bound 4p, limbs up to 2^14)."""
    rows = []
    for v, kind in zip(values, kinds):
        if kind == "plus_p":
            v += P
        elif kind == "lazy":
            v += 3 * P
        limbs = F.int_to_limbs(v).astype(np.int64)
        if kind == "lazy" and limbs[1] > 0:
            limbs[0] += F.RADIX
            limbs[1] -= 1
        rows.append(limbs)
    limbs = torch.as_tensor(np.stack(rows).astype(np.int32), device=device)
    return Fp(limbs, 4 * P, 2 * F.RADIX)


def validate_case(lanes: int, device, seed: int = 2025):
    """(P: G1, Q: G2, end rows [6, 21, lanes], kinds) at ``lanes`` lanes.
    ``end`` is made by hand: on every lane but ``outside_g2`` and ``z_zero``
    the state (psi(Q).x z^2, psi(Q).y z^3, z) for a seeded nonzero z, which
    the compare accepts; its rows are the kernel layout (below 2p)."""
    g1s, g2s, outside = _points(seed)
    rng = random.Random(seed + 1)
    n = min(lanes, PERIOD)
    kinds = [KINDS[i % len(KINDS)] for i in range(n)]
    ps, qs, ends = [], [], []
    for i, kind in enumerate(kinds):
        p, q = g1s[(i // len(KINDS)) % DISTINCT], g2s[(i // 3) % DISTINCT]
        if kind == "outside_g2":
            q = outside
        elif kind == "p_5_5":
            p = (5, 5)
        elif kind == "p_0_0":
            p = (0, 0)
        elif kind == "off_twist":
            q = (q[0], ((q[1][0] + 1) % P, q[1][1]))
        ps.append(p)
        qs.append(q)
        z = (rng.randrange(P), rng.randrange(1, P))
        zz = c.fq2_mul(z, z)
        psx = c.fq2_mul(c.TWIST_C2, (q[0][0], -q[0][1] % P))
        psy = c.fq2_mul(c.TWIST_C3, (q[1][0], -q[1][1] % P))
        X, Y = c.fq2_mul(psx, zz), c.fq2_mul(psy, c.fq2_mul(zz, z))
        if kind == "outside_g2":
            X = ((X[0] + 1) % P, X[1])
        if kind == "z_zero":
            X, Y, z = (0, 0), (0, 0), (0, 0)
        ends.append([w for v in (X, Y, z) for w in _fq2_mont(v)])
    mont = [list(_fq2_mont(p)) for p in ps]
    g1 = G1(*(_column([m[k] for m in mont], kinds, device) for k in (0, 1)))
    qm = [[w for v in q for w in _fq2_mont(v)] for q in qs]
    comps = [_column([m[k] for m in qm], kinds, device) for k in range(4)]
    g2 = G2(Fp2(comps[0], comps[1]), Fp2(comps[2], comps[3]))
    rows = np.zeros((6, F.NLIMBS, n), np.int32)
    for i, (e, kind) in enumerate(zip(ends, kinds)):
        for k, v in enumerate(e):
            rows[k, :, i] = F.int_to_limbs(P if kind == "z_zero" and k == 4 else v)
    tile = torch.arange(lanes, device=device) % n

    def tiled(x: Fp) -> Fp:
        return Fp(x.limbs[tile], x.bound, x.limb_bound)

    g1 = G1(tiled(g1.x), tiled(g1.y))
    g2 = G2(Fp2(tiled(g2.x.c0), tiled(g2.x.c1)), Fp2(tiled(g2.y.c0), tiled(g2.y.c1)))
    end = torch.as_tensor(rows, device=device)[..., tile].contiguous()
    return g1, g2, end, [kinds[i % n] for i in range(lanes)]
