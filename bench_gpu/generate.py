"""The benchmark's input generation: every cell's inputs from its seed.

A traffic mix is a data file under ``traffic/`` whose ``"generator"`` key
names a kind; the kind is the module ``generators/<kind>.py``, found by
that name (``harness.make_inputs``), and the file's other keys are its
parameters. A new kind is a new file there.

This module holds what the kinds share. Every point is made by additions
along arithmetic progressions of scalars (one Jacobian mixed addition a
point, then one batch inversion to affine form), not by a scalar
multiplication each: a G2 multiplication in Python takes about 380 affine
steps, so 65,536 of them would take longer than a run. The same seed gives
the same points, and every seed gives the same sizes.

The curve arithmetic here is plain Python integers over the frozen constants
in ``reference/bn254.py``; nothing of the program under test is imported.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

from .reference import oracle as o
from .reference.bn254 import G1_GEN, G2_GEN_X, G2_GEN_Y, P, R_SCALAR

G2_GEN = (G2_GEN_X, G2_GEN_Y)

# ---------------------------------------------------------------------------
# Fq, and Fq2 on (c0, c1) tuples with u^2 = -1
# ---------------------------------------------------------------------------


def _fq_mul(a, b):
    return a * b % P


def _fq_inv(a):
    return pow(a, P - 2, P)


def _f2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % P, (a0 * b1 + a1 * b0) % P)


def _f2_sq(a):
    a0, a1 = a
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def _f2_inv(a):
    n = pow((a[0] * a[0] + a[1] * a[1]) % P, P - 2, P)
    return (a[0] * n % P, -a[1] * n % P)


def walk_g1(start, steps) -> List[Tuple[int, int]]:
    """The affine points start, start + s_0, start + s_0 + s_1, ... for the
    affine G1 ``steps``: Jacobian mixed additions (madd-2007-bl, a = 0),
    then one batch inversion of the Z values."""
    x, y, z = start[0], start[1], 1
    jac = [(x, y, z)]
    for sx, sy in steps:
        zz = z * z % P
        h = (sx * zz - x) % P
        if h == 0:
            raise ValueError("progression met a doubling; draw another seed")
        hh = h * h % P
        i4 = 4 * hh % P
        j = h * i4 % P
        r = 2 * (sy * z * zz - y) % P
        v = x * i4 % P
        x3 = (r * r - j - 2 * v) % P
        y = (r * (v - x3) - 2 * y * j) % P
        z = ((z + h) * (z + h) - zz - hh) % P
        x = x3
        jac.append((x, y, z))
    out = []
    for (x, y, _), zi in zip(jac, _batch_inv([j[2] for j in jac], _fq_mul, _fq_inv, 1)):
        zi2 = zi * zi % P
        out.append((x * zi2 % P, y * zi2 * zi % P))
    return out


def _batch_inv(zs: list, mul, inv, one) -> list:
    """1 / z for every z, by one inversion (Montgomery's trick)."""
    prefix, acc = [], one
    for z in zs:
        prefix.append(acc)
        acc = mul(acc, z)
    acc, out = inv(acc), [None] * len(zs)
    for k in range(len(zs) - 1, -1, -1):
        out[k] = mul(acc, prefix[k])
        acc = mul(acc, zs[k])
    return out


def g1_progression(a0: int, da: int, n: int) -> List[Tuple[int, int]]:
    """[a0 + i da] G1 for i < n."""
    return walk_g1(o.g1_mul(G1_GEN, a0), [o.g1_mul(G1_GEN, da)] * (n - 1))


def g2_progression(b0: int, db: int, n: int):
    """[b0 + i db] G2 for i < n: :func:`walk_g1`'s steps over Fq2, written
    out on the components."""
    (x0, x1), (y0, y1) = o.g2_mul(G2_GEN, b0)
    (s0, s1), (t0, t1) = o.g2_mul(G2_GEN, db)
    z0, z1 = 1, 0
    jac = [(x0, x1, y0, y1, z0, z1)]
    for _ in range(n - 1):
        zz0, zz1 = (z0 + z1) * (z0 - z1) % P, 2 * z0 * z1 % P  # Z1Z1
        h0, h1 = (s0 * zz0 - s1 * zz1 - x0) % P, (s0 * zz1 + s1 * zz0 - x1) % P
        if h0 == 0 and h1 == 0:
            raise ValueError("progression met a doubling; draw another seed")
        hh0, hh1 = (h0 + h1) * (h0 - h1) % P, 2 * h0 * h1 % P
        i0, i1 = 4 * hh0, 4 * hh1
        j0, j1 = (h0 * i0 - h1 * i1) % P, (h0 * i1 + h1 * i0) % P
        w0, w1 = (t0 * z0 - t1 * z1) % P, (t0 * z1 + t1 * z0) % P  # S2 = Y2 Z1 Z1Z1
        r0 = 2 * ((w0 * zz0 - w1 * zz1 - y0) % P)
        r1 = 2 * ((w0 * zz1 + w1 * zz0 - y1) % P)
        v0, v1 = (x0 * i0 - x1 * i1) % P, (x0 * i1 + x1 * i0) % P
        X0 = ((r0 + r1) * (r0 - r1) - j0 - 2 * v0) % P
        X1 = (2 * r0 * r1 - j1 - 2 * v1) % P
        yj0, yj1 = (y0 * j0 - y1 * j1), (y0 * j1 + y1 * j0)
        d0, d1 = v0 - X0, v1 - X1
        y0, y1 = (r0 * d0 - r1 * d1 - 2 * yj0) % P, (r0 * d1 + r1 * d0 - 2 * yj1) % P
        a0, a1 = z0 + h0, z1 + h1
        z0, z1 = ((a0 + a1) * (a0 - a1) - zz0 - hh0) % P, (2 * a0 * a1 - zz1 - hh1) % P
        x0, x1 = X0, X1
        jac.append((x0, x1, y0, y1, z0, z1))
    zinv = _batch_inv([(j[4], j[5]) for j in jac], _f2_mul, _f2_inv, (1, 0))
    out = []
    for (x0, x1, y0, y1, _, _), zi in zip(jac, zinv):
        zi2 = _f2_sq(zi)
        out.append((_f2_mul((x0, x1), zi2), _f2_mul((y0, y1), _f2_mul(zi2, zi))))
    return out


def scalar(rng: random.Random) -> int:
    return rng.randrange(1, R_SCALAR)


def twist_point_outside_g2(rng: random.Random):
    """A point on the twist y^2 = x^3 + 3/(9 + u) from a random x: it lies
    in G2 with probability about 1/p (the reference checks membership)."""
    while True:
        pt = o.g2_point_from_x((rng.randrange(P), rng.randrange(P)))
        if pt is not None:
            return pt


def stable_seed(seed: int, *salt: int) -> int:
    """A seed for a sub-stream of ``seed`` (Python's hash of ints is fixed)."""
    return hash((seed,) + tuple(salt)) & ((1 << 63) - 1)


def sample(seed: int, population: Sequence, k: int, salt: int) -> list:
    """``k`` items of ``population`` drawn from ``seed`` (sorted, distinct)."""
    rng = random.Random(stable_seed(seed, salt))
    return sorted(rng.sample(list(population), min(k, len(population))))
