"""Streamed pairing witnesses on the port: the ``plonky2_pairing_witness``
cells.

The timed entry is ``witness.stream.witness_stream`` over a batch longer
than the window can use (the seeded pool of distinct pairs, repeated): it
runs ``pairing_witness`` a chunk at a time and hands each chunk's whole
trace over as numpy arrays in host memory, the copy of one chunk running
beside the next chunk's compute. A step is one hand-over. The consumer
drops each chunk once counted; of the first chunk, and of one in every
``check_every`` after it (from an offset drawn from the seed), it first
keeps the rows of ``lanes_kept`` lanes for the check, one lane from each of
as many equal strides of the chunk. A lane's rows lie a batch apart in the
host arrays (the leaves are batch-last), so a kept lane costs some 3.7 ms
of scattered reads on an H100 machine's host CPU: too much to keep many in
every chunk. The window closes the stream.

Set-up makes the pool, puts it on the card, and runs the stream once over
``warmup_chunks`` chunks, which builds the port's lazy tables and
page-locks the host blocks that every later hand-over reuses.
"""

from __future__ import annotations

import random

import numpy as np
import torch

import pairing_tpu_torch as pt
from pairing_tpu_torch.utils.interop import map_limbs
from pairing_tpu_torch.witness.stream import tensor_leaves, witness_stream

from .. import generate
from ..reference import witness as ref

def _take(c: np.ndarray, lanes: np.ndarray) -> np.ndarray:
    """Limbs [*lead, B, 21] -> the lanes' [L, *lead, 21] (a copy)."""
    return np.moveaxis(c[..., lanes, :], -2, 0)


def _fq12(a, lanes) -> np.ndarray:
    """An Fq12 of numpy limbs [*lead, B, 21] -> the lanes' [L, *lead, 12, 21]."""
    comps = [s.c0.limbs for s in a.s] + [s.c1.limbs for s in a.s]
    return np.stack([_take(c, lanes) for c in comps], axis=-2)


def _slots(pairs, lanes) -> np.ndarray:
    """6 x (c0, c1) limb arrays [*lead, B, 21] -> the lanes' [L, *lead, 12, 21]."""
    comps = [c0 for c0, _ in pairs] + [c1 for _, c1 in pairs]
    return np.stack([_take(c, lanes) for c in comps], axis=-2)


def _fp2s(values, lanes) -> np.ndarray:
    """Fp2 values of limbs [*lead, B, 21] -> the lanes' [L, *lead, 2 * n, 21]."""
    comps = [c for v in values for c in (v.c0.limbs, v.c1.limbs)]
    return np.stack([_take(c, lanes) for c in comps], axis=-2)


def lane_rows(out, trace, lanes) -> list:
    """The given lanes of a handed-over chunk, one dict a lane, named and
    laid out as ``reference.witness.lane_trace`` gives a lane (limb rows
    [..., 21]); one gather a leaf for all the lanes, copied out of the
    stream's host blocks."""
    lanes = np.asarray(lanes)
    m, f = trace["miller"], trace["final_exp"]
    r = m["r_affine"]
    rows = {
        "r_affine": _fp2s((r.x, r.y), lanes)[:, :, 0],
        "tg_lines": _fp2s(m["tangent_lines"], lanes)[:, :, 0],
        "ch_lines": _fp2s(m["chord_lines"], lanes)[:, :, 0],
        "ep_lines": np.stack([_fp2s(line, lanes)[:, 0] for line in m["epilogue_lines"]], axis=1),
        "q1": _fp2s((m["q1"].x, m["q1"].y), lanes)[:, 0],
        "neg_q2": _fp2s((m["neg_q2"].x, m["neg_q2"].y), lanes)[:, 0],
        "f_steps": _slots(m["f_steps"], lanes),
        "miller_out": _fq12(trace["miller_out"], lanes),
        "easy_out": _fq12(f["easy_part_out"], lanes),
        "exp_inputs": np.stack([_fq12(e.x, lanes) for e in f["exp_inputs"]], axis=1),
        "exp_offsets": np.stack([_fq12(e.offset, lanes) for e in f["exp_inputs"]], axis=1),
        "exp_bits": np.stack([np.asarray(e.exp_bits)[lanes] for e in f["exp_inputs"]], axis=1),
        "exp_rows": np.stack([_slots(rows, lanes) for rows in f["exp_trace_rows"]], axis=1),
        "exp_outs": np.stack([_fq12(e, lanes) for e in f["exp_outputs"]], axis=1),
        "out": _fq12(out, lanes),
    }
    return [{k: v[j] for k, v in rows.items()} for j in range(len(lanes))]


def strata(seed: int, chunk: int, k: int, n: int) -> list:
    """``n`` lanes of chunk ``k``, one from each of ``n`` equal strides of
    the chunk, drawn from the seed: lanes far apart, so in different thread
    blocks of every kernel."""
    n = min(n, chunk)
    width = chunk // n
    rng = random.Random(generate.stable_seed(seed, 100, k))
    return [j * width + rng.randrange(width) for j in range(n)]


def host_bytes(tree) -> int:
    """Bytes the numpy leaves of ``tree`` span in host memory (the union of
    their byte ranges)."""
    ivs = []
    for a in tensor_leaves(tree, np.ndarray):
        if a.size:
            lo, hi = np.byte_bounds(a) if hasattr(np, "byte_bounds") else \
                np.lib.array_utils.byte_bounds(a)
            ivs.append((lo, hi))
    total, end = 0, None
    for lo, hi in sorted(ivs):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


class Driver:
    unit = "witnesses"

    def __init__(self, config: dict, traffic: dict, seed: int, device, control: bool = False):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.chunk = int(traffic["chunk_size"])
        # the control: the reference with projective lines in the program's place
        self.control = control
        self.traced = False
        self.shapes = {"lanes": self.chunk}
        self.counters = {}
        self.kept, self.k, self.stream = {}, 0, None
        # the chunks whose lanes are kept: the first, then one in every
        # check_every from an offset drawn from the seed
        self.every = int(config["check_every"])
        self.offset = 1 + generate.stable_seed(seed, 4) % max(1, self.every - 1)

    def setup(self, inputs, seconds: float) -> None:
        ps, qs = inputs
        self.ps, self.qs = ps, qs
        pool = len(ps)
        if pool % self.chunk:
            raise ValueError("the pool must hold whole chunks")
        p, q = pt.g1_from_ints(ps, self.device), pt.g2_from_ints(qs, self.device)
        warm = int(self.traffic["warmup_chunks"]) * self.chunk
        for _ in witness_stream(map_limbs(p, lambda t: t[:warm]), map_limbs(q, lambda t: t[:warm]),
                                self.chunk):
            pass
        need = max(seconds * float(self.traffic["max_rate"]),
                   (int(self.traffic["trace_warm_steps"]) + int(self.traffic["trace_steps"]) + 2)
                   * self.chunk)
        reps = max(1, -(-int(need) // pool))
        self.p = map_limbs(p, lambda t: t.repeat(reps, 1))
        self.q = map_limbs(q, lambda t: t.repeat(reps, 1))
        self._sync()

    def start(self) -> None:
        self.stream = witness_stream(self.p, self.q, self.chunk)

    def step(self) -> int:
        item = next(self.stream, None)
        if item is None:
            return 0
        start, out, trace = item
        del item
        if not self.counters:
            self.counters["host_bytes_per_lane"] = host_bytes((out, trace)) / self.chunk
        if self.k == 0 or self.k % self.every == self.offset % self.every:
            lanes = strata(self.seed, self.chunk, self.k, int(self.config["lanes_kept"]))
            for b, rows in zip(lanes, lane_rows(out, trace, lanes)):
                self.kept[(self.k, (start + b) % len(self.ps))] = rows
        self.k += 1
        return self.chunk

    def stop(self) -> None:
        if self.stream is not None:
            self.stream.close()
        self.stream = None
        self._sync()

    def release(self) -> None:
        del self.p, self.q

    def check(self) -> dict:
        """Every kept lane against the reference: every field element of the
        trace and the pairing value."""
        if not self.kept:
            return {"checks": [("chunks", 0, -1)], "attempted": 0, "failed": 0}
        trace_wrong = out_wrong = 0
        for (_, i), got in sorted(self.kept.items()):
            want = ref.lane_trace(self.ps[i], self.qs[i])
            if self.control:
                got = ref.as_rows(ref.lane_trace(self.ps[i], self.qs[i], "projective"))
            counts = ref.mismatches(got, want)
            out_wrong += int(counts.pop("out") > 0)
            trace_wrong += sum(counts.values())
        limits = self.config["limits"]
        counts = {"trace_wrong": trace_wrong, "out_wrong": out_wrong}
        return {"checks": [(name, counts[name], limits[name]) for name in limits],
                "attempted": self.k * self.chunk, "failed": out_wrong}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
