"""Plain reference of a batch of Groth16 verifications, and its comparison.

A proof is accepted iff its points are valid inputs of the EIP-197
``ecPairing`` call (A, C and vk_x on E, B on the twist and in G2) and
e(-A, B) e(alpha, beta) e(vk_x, gamma) e(C, delta) = 1. For the generator's
proofs (``generators/groth16_proofs.py``) bilinearity gives every product
without a pairing: one for a sound proof, e(G1, delta)^k for one whose C
was moved by [k] G1. The reference works that value out with the frozen oracle, and
on a few proofs drawn from the seed it computes the whole four-pair product
with the oracle as well, from the points alone.

Membership in G2 of the sound proofs' B_i = [b_i] G2 holds by construction;
the reference tests it for the B replaced by twist points, and tests every
point's curve equation.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import oracle as o
from .bn254 import G1_GEN, P, TWIST_B
from .limbs import montgomery_matches, representatives


def _on_g1(pt) -> bool:
    x, y = pt
    return (y * y - x * x * x - 3) % P == 0


def _on_twist(pt) -> bool:
    (x, y) = pt
    rhs = o.fq2_add(o.fq2_mul(o.fq2_mul(x, x), x), TWIST_B)
    return o.fq2_mul(y, y) == rhs


def expected(pool) -> Dict[str, list]:
    """Per proof of the pool: ``valid`` (the validation mask), ``accept``,
    and ``moved`` (k for a valid proof whose product is e(G1, delta)^k, else
    0)."""
    bad_c, bad_b = set(pool.bad_c), set(pool.bad_b)
    outside = {i: not o.g2_in_subgroup(pool.b[i]) for i in bad_b}
    valid, accept, moved = [], [], []
    for i in range(len(pool.a)):
        ok = (_on_g1(pool.a[i]) and _on_twist(pool.b[i]) and _on_g1(pool.c[i])
              and _on_g1(pool.vk_x[i]) and not outside.get(i, False))
        valid.append(ok)
        moved.append(pool.moves[i] if ok and i in bad_c else 0)
        accept.append(ok and i not in bad_c and i not in bad_b)
    return {"valid": valid, "accept": accept, "moved": moved}


def product(pool, i: int) -> List[int]:
    """The oracle's four-pair product of proof i, from its points alone."""
    pairs = [(o.g1_neg(pool.a[i]), pool.b[i]), (pool.alpha, pool.beta),
             (pool.vk_x[i], pool.gamma), (pool.c[i], pool.delta)]
    return o.final_exp(o.multi_miller_loop(pairs))


def _reps(coeffs: Sequence[int]) -> torch.Tensor:
    """[12, 2, 21]: the two Montgomery digit rows of each coefficient."""
    return torch.tensor([representatives(c) for c in coeffs], dtype=torch.int64)


def compare(pool, calls, sampled: Sequence[int]) -> Dict[str, int]:
    """Count the program's wrong answers.

    ``calls``: one dict per verify call of the window, with ``lanes`` (the
    range of pool indices of its proofs), ``accept`` and ``valid`` (bool [B]) and,
    for the calls whose product was kept, ``product`` (limbs [B, 12, 21] in
    the oracle's coefficient order). ``sampled``: pool indices whose product
    the oracle also computes outright, compared wherever a kept call holds
    them."""
    ref = expected(pool)
    g = o.pairing(G1_GEN, pool.delta)
    powers = [o.fq12_one()]
    for _ in range(max(pool.moves.values(), default=0)):
        powers.append(o.fq12_mul(powers[-1], g))
    table = torch.stack([_reps(v) for v in powers])  # [k, 12, 2, 21]: e(G1, delta)^k
    direct = {i: _reps(product(pool, i)) for i in sampled}
    bits = {k: torch.tensor(v) for k, v in ref.items()}
    counts = {"accept_wrong": 0, "mask_wrong": 0, "product_wrong": 0, "oracle_wrong": 0}
    for call in calls:
        lanes = slice(call["lanes"].start, call["lanes"].stop)
        for key, name in (("accept", "accept_wrong"), ("valid", "mask_wrong")):
            counts[name] += int((call[key].cpu().to(torch.bool) != bits[key][lanes]).sum())
        if call.get("product") is None:
            continue
        prod = call["product"]
        valid, k = bits["valid"][lanes], bits["moved"][lanes]
        want = table[k].to(prod.device)
        ok = montgomery_matches(prod, want).all(dim=-1).cpu()
        counts["product_wrong"] += int((valid & ~ok).sum())
        for i, reps in direct.items():
            if i in call["lanes"]:
                got = montgomery_matches(prod[call["lanes"].index(i)], reps.to(prod.device))
                counts["oracle_wrong"] += int(not bool(got.all()))
    return counts
