"""Batched Groth16 verification on the port: the ``groth16_verify`` cells.

One timed call verifies a batch of proofs of one circuit, as the EIP-197
``ecPairing`` precompile and the standard Solidity and snarkjs verifiers do
for one proof, for the whole batch at once:

  1. ``validate_inputs`` (with the subgroup check) on (A_i, B_i), and
     ``g1_on_curve`` on C_i and vk_x_i;
  2. ``multi_pairing`` over the four pairs (-A_i, B_i), (alpha, beta),
     (vk_x_i, gamma), (C_i, delta);
  3. on the device, whether each product equals one;
  4. the accept bit: valid and equal to one; then a device synchronise.

The verifying key is made and checked once at set-up; vk_x_i (the public
inputs' MSM, which the port does not have) is an input. Calls run back to
back (a closed loop) over ``pool // batch`` slices of the proof pool in
turn. Every call's accept bits and masks are kept for the check, and the
products of one call in ``product_every`` (from a seeded offset; the first
call always).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

import pairing_tpu_torch as pt
from pairing_tpu_torch.curves.g1 import G1
from pairing_tpu_torch.curves.g2 import G2
from pairing_tpu_torch.fields.fp import Fp
from pairing_tpu_torch.fields.fp2 import Fp2
from pairing_tpu_torch.fields.fp12 import fq12_eq, fq12_one
from pairing_tpu_torch.utils.interop import map_limbs

from .. import generate
from ..reference import groth16 as ref

PAIRS = 4


def _stack_fp(xs) -> Fp:
    return Fp(torch.stack([x.limbs for x in xs]), max(x.bound for x in xs),
              max(x.limb_bound for x in xs))


def stack_g1(points) -> G1:
    """G1 batches [B] -> one batch [K, B] (the pairs axis first)."""
    return G1(_stack_fp([p.x for p in points]), _stack_fp([p.y for p in points]))


def stack_g2(points) -> G2:
    return G2(Fp2(_stack_fp([q.x.c0 for q in points]), _stack_fp([q.x.c1 for q in points])),
              Fp2(_stack_fp([q.y.c0 for q in points]), _stack_fp([q.y.c1 for q in points])))


def product_limbs(prod) -> torch.Tensor:
    """An Fq12 batch -> limbs [B, 12, 21] in the coefficient order c_i, c_{i+6}."""
    comps = [s.c0.limbs for s in prod.s] + [s.c1.limbs for s in prod.s]
    return torch.stack(comps, dim=-2)


class Driver:
    unit = "proofs"

    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.batch = int(traffic["batch"])
        # the control runs the program's own path without the subgroup check
        self.subgroup_check = not control
        self.traced = False
        self.calls, self.k = [], 0
        self.keep_offset = generate.stable_seed(seed, 1) % int(config["product_every"])
        self.shapes = {"products": self.batch, "pairs": PAIRS}
        self.counters = {}

    # -- set-up -------------------------------------------------------------

    def setup(self, inputs, seconds: float) -> None:
        self.pool = inputs
        dev, pool = self.device, self.pool
        if len(pool.a) % self.batch:
            raise ValueError("the pool must hold whole calls")
        a, b = pt.g1_from_ints(pool.a, dev), pt.g2_from_ints(pool.b, dev)
        c, x = pt.g1_from_ints(pool.c, dev), pt.g1_from_ints(pool.vk_x, dev)
        alpha = pt.g1_from_ints([pool.alpha], dev)
        beta, gamma, delta = (pt.g2_from_ints([q], dev)
                              for q in (pool.beta, pool.gamma, pool.delta))
        vk_ok = (pt.validate_inputs(alpha, beta) & pt.g2_on_curve(gamma) & pt.g2_on_curve(delta)
                 & pt.g2_in_subgroup(gamma) & pt.g2_in_subgroup(delta))
        if not bool(vk_ok.all()):
            raise RuntimeError("the verifying key failed validation")
        n = self.batch

        def wide(limbs):
            return limbs.expand(n, limbs.shape[-1])

        self.vk = (map_limbs(alpha, wide), map_limbs(beta, wide), map_limbs(gamma, wide),
                   map_limbs(delta, wide))
        self.one = fq12_one((n,), dev)
        self.slices = []
        for s in range(len(pool.a) // n):
            def cut(limbs, s=s):
                return limbs[s * n:(s + 1) * n]

            self.slices.append(tuple(map_limbs(v, cut) for v in (a, b, c, x)))
        for _ in range(int(self.traffic["warmup_calls"])):
            self.verify(*self.slices[0])
        self._sync()

    # -- the timed entry ----------------------------------------------------

    def verify(self, a, b, c, x):
        """One batched verification: (accept, valid, product)."""
        alpha, beta, gamma, delta = self.vk
        with record_function("bench.validate"):
            self._sync_if_traced()
            valid = (pt.validate_inputs(a, b, subgroup_check=self.subgroup_check)
                     & pt.g1_on_curve(c) & pt.g1_on_curve(x))
            self._sync_if_traced()
        with record_function("bench.multi_pairing"):
            prod = pt.multi_pairing(stack_g1([pt.g1_neg(a), alpha, x, c]),
                                    stack_g2([b, beta, gamma, delta]))
        with record_function("bench.accept"):
            accept = valid & fq12_eq(prod, self.one)
        return accept, valid, prod

    def start(self) -> None:
        pass

    def step(self) -> int:
        s = self.k % len(self.slices)
        accept, valid, prod = self.verify(*self.slices[s])
        self._sync()
        keep = self.k == 0 or self.k % int(self.config["product_every"]) == self.keep_offset
        self.calls.append({"lanes": range(s * self.batch, (s + 1) * self.batch),
                           "accept": accept, "valid": valid, "product": prod if keep else None})
        self.k += 1
        return self.batch

    def stop(self) -> None:
        self._sync()

    # -- after the window ---------------------------------------------------

    def release(self) -> None:
        del self.slices, self.vk, self.one
        for call in self.calls:
            if call["product"] is not None:
                call["product"] = product_limbs(call["product"])

    def check(self) -> dict:
        """Every number the comparison reads, each with its limit, and the
        proofs attempted and answered wrongly."""
        kept = sorted({i for call in self.calls if call["product"] is not None
                       for i in call["lanes"]})
        bad_c = set(self.pool.bad_c)
        sampled = generate.sample(self.seed, kept, int(self.config["oracle_proofs"]), salt=2)
        sampled += generate.sample(self.seed, [i for i in kept if i in bad_c], 1, salt=3)
        counts = ref.compare(self.pool, self.calls, sorted(set(sampled)))
        limits = self.config["limits"]
        return {"checks": [(name, counts[name], limits[name]) for name in limits],
                "attempted": len(self.calls) * self.batch, "failed": counts["accept_wrong"]}

    # -- helpers ------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sync_if_traced(self) -> None:
        if self.traced:
            self._sync()
