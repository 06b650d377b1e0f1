"""Groth16 proofs of one circuit: the ``groth16_proofs`` kind.

One verifying key; one proof in ``bad_c_every`` has C + [k] G1 in place of
C, k from 1 to 8 (the product is then e(G1, delta)^k, not one), one in
``bad_b_every`` a B on the twist outside G2, at places drawn from the seed.
"""

from __future__ import annotations

import dataclasses
import random

from ..generate import (G1_GEN, G2_GEN, g1_progression, g2_progression, scalar,
                        twist_point_outside_g2, walk_g1)
from ..reference import oracle as o
from ..reference.bn254 import R_SCALAR

#: a bad proof's C is moved by [k] G1, k from 1 to MOVES
MOVES = 8


@dataclasses.dataclass
class Groth16Pool:
    """Proofs (A_i, B_i, C_i) with their public-input points vk_x_i, and the
    verifying key (alpha in G1; beta, gamma, delta in G2), as affine ints.

    Proof i is made from the scalars a_i = a0 + i da, b_i = b0 + i db,
    c_i = c0 + i dc and x_i = (a_i b_i - alpha beta - c_i delta) / gamma
    mod r, so that e(-A, B) e(alpha, beta) e(vk_x, gamma) e(C, delta) = 1.
    ``bad_c`` and ``bad_b`` list the proofs made bad on purpose, and
    ``moves[i]`` the k by which proof i's C was moved: C_i + [k] G1, whose
    product is e(G1, delta)^k."""

    alpha: tuple
    beta: tuple
    gamma: tuple
    delta: tuple
    a: list
    b: list
    c: list
    vk_x: list
    bad_c: list
    bad_b: list
    moves: dict


def make(seed: int, pool: int, bad_c_every: int, bad_b_every: int, **_) -> Groth16Pool:
    if pool % bad_b_every or pool % bad_c_every:
        raise ValueError("the pool must hold a whole number of each kind of bad proof")
    rng = random.Random(seed)
    al, be, ga, de = (scalar(rng) for _ in range(4))
    a0, da, b0, db, c0, dc = (scalar(rng) for _ in range(6))
    gi = pow(ga, -1, R_SCALAR)
    # x_i = q(i) = (a_i b_i - al be - c_i de) / ga: second difference 2 da db / ga
    x0 = (a0 * b0 - al * be - c0 * de) * gi % R_SCALAR
    d0 = ((a0 + da) * (b0 + db) - a0 * b0 - dc * de) * gi % R_SCALAR
    dd = 2 * da * db * gi % R_SCALAR
    a = g1_progression(a0, da, pool)
    b = g2_progression(b0, db, pool)
    c = g1_progression(c0, dc, pool)
    # vk_x_{i+1} = vk_x_i + [d0 + i dd] G1: two additions a proof
    vk_x = walk_g1(o.g1_mul(G1_GEN, x0), g1_progression(d0, dd, pool)[:-1])
    # the bad proofs at seeded places (a fixed number of each kind, never both
    # at once): C moved by [k] G1 with k from 1 to MOVES, or B replaced
    order = rng.sample(range(pool), pool // bad_c_every + pool // bad_b_every)
    bad_c, bad_b = sorted(order[:pool // bad_c_every]), sorted(order[pool // bad_c_every:])
    moves = {}
    for i in bad_c:
        moves[i] = 1 + rng.randrange(MOVES)
        c[i] = o.g1_add(c[i], o.g1_mul(G1_GEN, moves[i]))
    for i in bad_b:
        b[i] = twist_point_outside_g2(rng)
    return Groth16Pool(o.g1_mul(G1_GEN, al), o.g2_mul(G2_GEN, be), o.g2_mul(G2_GEN, ga),
                       o.g2_mul(G2_GEN, de), a, b, c, vk_x, bad_c, bad_b, moves)
