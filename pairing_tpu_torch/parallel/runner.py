"""Streaming runner for very large pairing batches (BASELINE config 5).

The PyTorch counterpart of ``pairing_tpu/parallel/runner.py``. It chunks a
huge (e.g. 1M-pair) workload through the device, optionally checkpointing
each finished chunk to disk so a preempted run resumes where it left off:

  * each chunk's points are made with ``g1_from_ints`` / ``g2_from_ints``
    on ``config.device`` (through the native codec when it is built), go
    through ``api.pairing``, and come back in one bulk copy of canonical
    int32 limbs (``fq12_to_canonical_limbs``): no per-element Python
    bigints on the hot path; convert with ``fq12_limbs_to_int_coeffs`` only
    when actual integers are needed;
  * the tail chunk is not padded: the JAX package pads it so that its
    jitted pairing compiles once, and the port runs eagerly;
  * checkpoints are npz files that carry a digest of the chunk's inputs;
    resuming against different inputs raises instead of yielding stale
    values.

The JAX package's mesh branch (``config.mesh_shape``) comes with the port's
parallel layer over ``torch.distributed``.
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterator, Sequence, Tuple

import numpy as np

from ..curves.g1 import g1_from_ints
from ..curves.g2 import g2_from_ints
from ..fields import fp12 as F12
from ..pairing import api
from ..utils.config import PairingConfig


def _chunk_path(ckpt_dir: str, idx: int) -> str:
    return os.path.join(ckpt_dir, f"pairing_chunk_{idx:06d}.npz")


def _digest(g1_chunk, g2_chunk) -> str:
    h = hashlib.sha256()
    for pt in g1_chunk:
        h.update(repr(tuple(pt)).encode())
    for pt in g2_chunk:
        h.update(repr(tuple(pt)).encode())
    return h.hexdigest()


def pairing_stream(
    g1_points: Sequence[Tuple[int, int]],
    g2_points: Sequence,
    config: PairingConfig = PairingConfig(),
) -> Iterator[np.ndarray]:
    """Yield canonical Fq12 limb arrays chunk by chunk.

    Each yielded array has shape ``[chunk, 12, NLIMBS]`` (int32 canonical
    limbs; see ``fields.fp12.fq12_to_canonical_limbs``); the last chunk
    holds the remaining pairs. With ``config.checkpoint_dir`` set, finished
    chunks are persisted and skipped on re-run (resume support); a resumed
    run validates that the checkpointed chunk was computed from the same
    inputs.
    """
    n = len(g1_points)
    if len(g2_points) != n:
        raise ValueError(f"{n} G1 points but {len(g2_points)} G2 points")
    cs = config.chunk_size
    if config.checkpoint_dir:
        os.makedirs(config.checkpoint_dir, exist_ok=True)

    for idx, start in enumerate(range(0, n, cs)):
        g1_chunk = list(g1_points[start : start + cs])
        g2_chunk = list(g2_points[start : start + cs])
        if config.checkpoint_dir:
            path = _chunk_path(config.checkpoint_dir, idx)
            if os.path.exists(path):
                with np.load(path) as z:
                    if str(z["digest"]) != _digest(g1_chunk, g2_chunk):
                        raise ValueError(
                            f"checkpoint {path} was computed from different "
                            "inputs; refusing to resume"
                        )
                    yield z["limbs"]
                continue
        p = g1_from_ints(g1_chunk, config.device)
        q = g2_from_ints(g2_chunk, config.device)
        limbs = F12.fq12_to_canonical_limbs(api.pairing(p, q)).cpu().numpy()
        if config.checkpoint_dir:
            np.savez(
                _chunk_path(config.checkpoint_dir, idx),
                limbs=limbs,
                digest=np.str_(_digest(g1_chunk, g2_chunk)),
            )
        yield limbs
