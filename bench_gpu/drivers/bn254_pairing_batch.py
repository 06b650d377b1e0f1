"""Batched independent pairings on the port: the ``bn254_pairing_batch``
cells.

One timed call is the port's main entry, ``pairing(p, q)``, on ``batch``
distinct pairs, followed by the hand-over: the values stacked as limbs
[B, 12, 21] and copied whole into one pinned host buffer (allocated at
set-up), then a device synchronise, so that every value of the call is in
host memory when the call returns. Calls run back to back (a closed loop)
over the ``pool // batch`` slices of the pool in turn. No validation: the
inputs are trusted, as ``pairing()`` assumes.

The first call, and one call in ``check_every`` after it (from an offset
drawn from the seed), keep a reference to the device tensor they copied
from, which adds no work to the step. After the window those values, and
the host buffer as the last call left it, are compared with the plain
reference (``reference/pairing_batch.py``), every lane exactly.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

import pairing_tpu_torch as pt
from pairing_tpu_torch.pairing.final_exp import easy_part
from pairing_tpu_torch.utils.interop import map_limbs

from .. import generate
from ..reference import pairing_batch as ref
from .groth16_verify import product_limbs


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.batch = int(traffic["batch"])
        if int(traffic["g2_pool"]) % self.batch:
            raise ValueError("a call's slice must not cross a stride of G2 points")
        # the control leaves out the hard part of the final exponentiation
        self.control = control
        self.traced = False
        self.kept, self.last, self.k = [], None, 0
        self.every = int(config["check_every"])
        self.keep_offset = generate.stable_seed(seed, 5) % self.every
        self.shapes = {"products": self.batch, "pairs": 1}
        self.counters = {}

    def setup(self, inputs, seconds: float) -> None:
        self.ps, self.qs = inputs
        n, dev = self.batch, self.device
        if len(self.ps) % n:
            raise ValueError("the pool must hold whole calls")
        p, q = pt.g1_from_ints(self.ps, dev), pt.g2_from_ints(self.qs, dev)
        self.slices = []
        for s in range(len(self.ps) // n):
            def cut(limbs, s=s):
                return limbs[s * n:(s + 1) * n]

            self.slices.append((map_limbs(p, cut), map_limbs(q, cut)))
        self.host = torch.empty((n, 12, 21), dtype=torch.int32, pin_memory=dev.type == "cuda")
        self.counters["host_bytes_per_pair"] = self.host.numel() * self.host.element_size() / n
        for _ in range(int(self.traffic["warmup_calls"])):
            self.call(*self.slices[0])
        self._sync()

    # -- the timed entry ----------------------------------------------------

    def call(self, p, q) -> torch.Tensor:
        """One call: the pairings, then their values copied to the host
        buffer; returns the device tensor copied from."""
        with record_function("bench.pairing"):
            out = easy_part(pt.miller_loop(q, p)) if self.control else pt.pairing(p, q)
        with record_function("bench.to_host"):
            limbs = product_limbs(out)
            self.host.copy_(limbs, non_blocking=True)
        self._sync()
        return limbs

    def start(self) -> None:
        pass

    def step(self) -> int:
        s = self.k % len(self.slices)
        limbs = self.call(*self.slices[s])
        lanes = range(s * self.batch, (s + 1) * self.batch)
        if self.k == 0 or self.k % self.every == self.keep_offset:
            self.kept.append((lanes, limbs))
        self.last = (lanes, limbs)
        self.k += 1
        return self.batch

    def stop(self) -> None:
        self._sync()

    # -- after the window ---------------------------------------------------

    def release(self) -> None:
        del self.slices

    def check(self) -> dict:
        """Every lane of the kept calls and of the host buffer against the
        reference, a few sampled lanes against the oracle outright, and the
        host buffer against the device tensor it was copied from."""
        lanes, limbs = self.last
        checked = self.kept + [(lanes, self.host)]
        held = sorted({i for call_lanes, _ in checked for i in call_lanes})
        sampled = generate.sample(self.seed, held, int(self.config["oracle_lanes"]), salt=6)
        counts = ref.compare(self.ps, self.qs, checked, sampled)
        copied = (self.host.to(limbs.device) == limbs).flatten(1).all(dim=1)
        counts["value_wrong"] += int((~copied).sum())
        limits = self.config["limits"]
        return {"checks": [(name, counts[name], limits[name]) for name in limits],
                "attempted": self.k * self.batch, "failed": counts["value_wrong"]}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
