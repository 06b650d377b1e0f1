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
    values;
  * ``config.mesh_shape`` / ``mesh_axes`` shard each chunk's batch axis over
    the first axis of a ``torch.distributed`` mesh (P2 data parallelism):
    every rank pairs its contiguous share, the canonical limbs are
    all-gathered (the exchange buffer padded to equal shares, since the
    tail chunk is not padded, and trimmed after), and every rank yields the
    whole chunk. Only rank 0 writes a checkpoint, then all ranks meet at a
    barrier; on resume every rank reads it, so the directory must be one
    that every rank sees.
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterator, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..curves.g1 import g1_from_ints
from ..curves.g2 import g2_from_ints
from ..fields import fp12 as F12
from ..fields.fp import NLIMBS
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
    inputs. With ``config.mesh_shape`` set, every rank of the initialized
    process group calls this with the same points and gets the same
    chunks.
    """
    n = len(g1_points)
    if len(g2_points) != n:
        raise ValueError(f"{n} G1 points but {len(g2_points)} G2 points")
    cs = config.chunk_size
    sharded = config.mesh_shape is not None
    pair = _sharded_pairing(config) if sharded else _host_pairing(config.device)
    writer = not sharded or dist.get_rank() == 0
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
        limbs = pair(g1_chunk, g2_chunk)
        if config.checkpoint_dir:
            if writer:
                np.savez(
                    _chunk_path(config.checkpoint_dir, idx),
                    limbs=limbs,
                    digest=np.str_(_digest(g1_chunk, g2_chunk)),
                )
            if sharded:
                dist.barrier()
        yield limbs


def _canonical_pairing(g1_chunk, g2_chunk, device) -> torch.Tensor:
    """Canonical limbs [m, 12, NLIMBS] of the chunk's pairings on ``device``."""
    p = g1_from_ints(g1_chunk, device)
    q = g2_from_ints(g2_chunk, device)
    return F12.fq12_to_canonical_limbs(api.pairing(p, q))


def _host_pairing(device: str):
    """The per-chunk function without a mesh: the whole chunk on ``device``,
    one bulk copy of its canonical limbs to the host."""
    def pair(g1_chunk, g2_chunk) -> np.ndarray:
        return _canonical_pairing(g1_chunk, g2_chunk, device).cpu().numpy()

    return pair


def _sharded_pairing(config: PairingConfig):
    """The per-chunk function of the mesh branch: this rank's share of the
    chunk over the mesh's first axis, then one all-gather of the canonical
    limbs over that axis' group; returns the whole chunk on the host."""
    from .collectives import wire_device
    from .launch import mesh_device_type
    from .mesh import make_mesh

    mesh = make_mesh(config.mesh_shape, config.mesh_axes, mesh_device_type())
    axis = config.mesh_axes[0]
    group, size, me = mesh.get_group(axis), mesh.size(0), mesh.get_local_rank(axis)
    wire = wire_device(group, torch.device(config.device))

    def pair(g1_chunk, g2_chunk) -> np.ndarray:
        m = len(g1_chunk)
        share = -(-m // size)
        lo, hi = min(me * share, m), min((me + 1) * share, m)
        mine = torch.zeros((share, 12, NLIMBS), dtype=torch.int32, device=wire)
        if hi > lo:  # the ragged tail leaves the last ranks no lanes
            mine[: hi - lo] = _canonical_pairing(g1_chunk[lo:hi], g2_chunk[lo:hi],
                                                 config.device).to(wire)
        parts = [torch.empty_like(mine) for _ in range(size)]
        dist.all_gather(parts, mine, group=group)
        return torch.cat(parts)[:m].cpu().numpy()

    return pair
