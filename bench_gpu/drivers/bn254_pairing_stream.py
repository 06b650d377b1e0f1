"""A checkpointed job of independent pairings on the port: the
``bn254_pairing_stream`` cells.

The timed entry is ``parallel.runner.pairing_stream`` as a user calls it:
the job's Python int tuples, ``PairingConfig(device, chunk_size,
checkpoint_dir)``, and the canonical limbs of each chunk yielded in host
memory, its checkpoint published. A step is one ``next()`` of the current
stream: one chunk, computed or read back from its checkpoint.

A pass is one job over all the pairs, in a fresh checkpoint directory under
the system temporary directory. Once a pass, after a chunk drawn from the
seed anew each pass (from 1 to the job's chunks less 2; the traced run
after ``trace_preempt_after``), the driver preempts the job: it closes the
stream and starts a new ``pairing_stream`` over the same lists and
directory, which yields the chunks already done from their files, then
computes the rest. Passes repeat back to back; the step that finds a pass
finished also deletes its directory and starts the next.

For the check the driver keeps references to what the stream yielded: the
first computed chunk and one in ``check_every`` computed chunks after it
(from an offset drawn from the seed), every chunk yielded before a
preemption and every chunk resumed after it. At a preemption it records
each checkpoint file's inode and modification time, and again once the
resumed stream has read them (at the pass's end, or when the window
closes). After the window ``reference/pairing_stream.py`` compares them.

``--control`` hands the stream the G2 list rotated by one lane within
each chunk: every value is a true pairing of the wrong pair.
"""

from __future__ import annotations

import os
import random
import shutil
import sys
import tempfile
import time

import torch

from pairing_tpu_torch import native
from pairing_tpu_torch.parallel.runner import pairing_stream
from pairing_tpu_torch.utils.config import PairingConfig

from .. import generate
from ..reference import pairing_stream as ref


def rotated(qs: list, chunk: int) -> list:
    """``qs`` with each chunk's points rotated by one lane."""
    out = []
    for s in range(0, len(qs), chunk):
        c = qs[s:s + chunk]
        out.extend(c[1:] + c[:1])
    return out


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.chunk = int(traffic["chunk_size"])
        self.control = control
        self.traced = False
        self.shapes = {"products": self.chunk, "pairs": 1}
        self.counters = {}
        self.every = int(config["check_every"])
        self.keep_offset = generate.stable_seed(seed, 7) % self.every
        self.rng = random.Random(generate.stable_seed(seed, 8))
        self.stream, self.dir = None, None
        self.kept, self.preemptions = [], []
        self.computed = self.resumed = self.passes = self.units = 0

    def setup(self, inputs, seconds: float) -> None:
        self.ps, self.qs = inputs
        if len(self.ps) % self.chunk:
            raise ValueError("the job must hold whole chunks")
        self.chunks = len(self.ps) // self.chunk
        self.qs_run = rotated(self.qs, self.chunk) if self.control else self.qs
        warm = int(self.traffic["warmup_chunks"]) * self.chunk
        with tempfile.TemporaryDirectory(prefix="pairing_stream.warm.") as d:
            cfg = PairingConfig(device=str(self.device), chunk_size=self.chunk, checkpoint_dir=d)
            for _ in range(2):  # computed, then resumed from the checkpoints
                for _ in pairing_stream(self.ps[:warm], self.qs_run[:warm], cfg):
                    pass
        self.native = native.available()
        self._sync()

    # -- the timed entry ----------------------------------------------------

    def start(self) -> None:
        pass

    def step(self) -> int:
        if self.stream is None:
            self._begin_pass()
        limbs = next(self.stream, None)
        if limbs is None:
            self._end_pass()
            self._begin_pass()
            limbs = next(self.stream)
        c = self.at
        self.at += 1
        if self.pre is not None and c < self.preempt_at:  # read back from its file
            self.pre["resumed"][c] = limbs
            self.resumed += 1
        else:
            if self.pre is None:  # the pass's first stream
                self.yielded[c] = limbs
            if self.computed == 0 or self.computed % self.every == self.keep_offset:
                self.kept.append((c, limbs))
            self.computed += 1
        if self.pre is None and self.at == self.preempt_at:
            self._preempt()
        self.units += len(limbs)
        return len(limbs)

    def stop(self) -> None:
        if self.stream is not None:
            self.stream.close()
            self._settle()
        self._sync()

    # -- passes and preemptions ---------------------------------------------

    def _begin_pass(self) -> None:
        self.dir = tempfile.mkdtemp(prefix="pairing_stream.")
        self.cfg = PairingConfig(device=str(self.device), chunk_size=self.chunk,
                                 checkpoint_dir=self.dir)
        self.preempt_at = (int(self.traffic["trace_preempt_after"]) if self.traced
                           else self.rng.randint(1, self.chunks - 2))
        self.at, self.yielded, self.pre = 0, {}, None
        self.stream = pairing_stream(self.ps, self.qs_run, self.cfg)

    def _preempt(self) -> None:
        self.stream.close()
        stats = {c: self._stat(c) for c in range(self.at)}
        self.pre = {"yielded": self.yielded, "after": {}, "resumed": {},
                    "at": {c: s and (s.st_ino, s.st_mtime_ns) for c, s in stats.items()}}
        self._count_bytes(stats.values())
        self.preemptions.append(self.pre)
        self.stream, self.at = pairing_stream(self.ps, self.qs_run, self.cfg), 0

    def _settle(self) -> None:
        """The identity of each checkpoint file that the resumed stream has
        read back so far."""
        if self.pre is not None:
            for c in range(min(self.at, self.preempt_at)):
                s = self._stat(c)
                self.pre["after"][c] = s and (s.st_ino, s.st_mtime_ns)

    def _end_pass(self) -> None:
        self._settle()
        self._count_bytes([self._stat(c) for c in range(self.chunks)])
        shutil.rmtree(self.dir)
        self.stream, self.dir = None, None
        self.passes += 1

    def _stat(self, c: int):
        """``os.stat`` of chunk ``c``'s checkpoint (the runner's file name),
        or None if there is none."""
        try:
            return os.stat(os.path.join(self.dir, f"pairing_chunk_{c:06d}.npz"))
        except FileNotFoundError:
            return None

    def _count_bytes(self, stats) -> None:
        """``checkpoint_bytes_per_pair``: the bytes of the files ``stats``
        over the pairs they hold (every chunk is whole)."""
        sizes = [s.st_size for s in stats if s is not None]
        if sizes:
            self.counters["checkpoint_bytes_per_pair"] = sum(sizes) / (len(sizes) * self.chunk)

    # -- after the window ---------------------------------------------------

    def release(self) -> None:
        self.stream = None
        if self.dir is not None:
            shutil.rmtree(self.dir, ignore_errors=True)

    def check(self) -> dict:
        """The kept computed chunks against the reference, every lane; a few
        sampled lanes against the oracle outright; and every preemption's
        checkpoints and resumed chunks against what was yielded before it."""
        t0 = time.perf_counter()
        chunks = [(range(c * self.chunk, (c + 1) * self.chunk), limbs) for c, limbs in self.kept]
        held = sorted({i for lanes, _ in chunks for i in lanes})
        sampled = generate.sample(self.seed, held, int(self.config["oracle_lanes"]), salt=9)
        counts = ref.compare_values(self.ps, self.qs, chunks, sampled)
        counts["checkpoint_wrong"] = ref.compare_checkpoints(self.preemptions)
        print(f"bench_gpu: passes ended {self.passes}, preemptions {len(self.preemptions)}, "
              f"chunks computed {self.computed}, resumed {self.resumed}, value-checked "
              f"{len({k for k, _ in chunks})} distinct of {len(chunks)} kept; native codec "
              f"{self.native}; check {time.perf_counter() - t0:.1f} s", file=sys.stderr)
        limits = self.config["limits"]
        return {"checks": [(name, counts[name], limits[name]) for name in limits],
                "attempted": self.units, "failed": counts["value_wrong"]}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
