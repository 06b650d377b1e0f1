"""Multiplicative Fq12 collectives over a ``torch.distributed`` group.

PyTorch counterpart of ``pairing_tpu/parallel/collectives.py``. The
reduction op is Fq12 multiplication: associative, commutative and exact
over Z/p, so any order gives the same field value. It combines per-rank
partial Miller products of a large multi-pairing (``mesh.
multi_pairing_sharded``).

NCCL and gloo reduce only by sums, products, minima and maxima of
machine numbers, never by an Fq12 product, so the values cross the group
as limb tensors and every rank multiplies locally:

  * ``fq12_reduce_mul_psum_style``: one ``all_gather`` of the limbs, then
    a chain of products in rank order;
  * ``fq12_all_reduce_mul``: a log-depth butterfly, each round one
    ``batch_isend_irecv`` exchange with the partner ``rank ^ shift``, when
    the group's size is a power of two; the all-gather form otherwise.

The local product of a CUDA value runs kernel A (``ops.dispatch.fq12_mul``),
of a CPU value its plain version. The limbs cross the group on the
backend's own device: NCCL gets the CUDA tensors; gloo gets CPU copies,
which come back to the operand's device. Each product takes the lower
rank's value on the left, so every rank computes the same products on the
same limbs and holds the same limbs at the end, not only the same value.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..fields import fp as F
from ..fields.fp import Fp
from ..fields.fp2 import Fp2
from ..fields.fp12 import Fq12, fq12_cap
from ..ops.dispatch import fq12_mul
from ..utils.bn254 import P


def wire_device(group: Optional[dist.ProcessGroup], device: torch.device) -> torch.device:
    """Where a tensor on ``device`` crosses ``group``: the operand's CUDA
    device under NCCL, the host under gloo."""
    backend = dist.get_backend(group)
    if backend == dist.Backend.NCCL:
        if device.type != "cuda":
            raise ValueError(f"an NCCL group exchanges CUDA tensors; the value is on {device}")
        return device
    if backend == dist.Backend.GLOO:
        return torch.device("cpu")
    raise ValueError(f"no rule for the {backend!r} backend (nccl or gloo)")


def _pack(f: Fq12) -> torch.Tensor:
    """Fq12 of batch [*bs] -> limbs [12, *bs, NLIMBS] (c0, c1 of each slot)."""
    return torch.stack([c.limbs for s in f.s for c in (s.c0, s.c1)])


def _unpack(limbs: torch.Tensor) -> Fq12:
    """The inverse of :func:`_pack` for capped values (< 2p, settled limbs)."""
    c = [Fp(limbs[i], 2 * P, F.SETTLED) for i in range(12)]
    return Fq12(tuple(Fp2(c[2 * i], c[2 * i + 1]) for i in range(6)))


def _mul(lo: Fq12, hi: Fq12) -> Fq12:
    return fq12_cap(fq12_mul(lo, hi))


def fq12_all_reduce_mul(f: Fq12, group: Optional[dist.ProcessGroup] = None) -> Fq12:
    """All-reduce by Fq12 multiplication over ``group`` (default: the world).

    Dispatches on the group's size: a log-depth butterfly when it is a
    power of two, the all-gather form otherwise. Every rank passes a value
    of the same batch shape and gets the product of all of them, lane by
    lane, with the same limbs on every rank.
    """
    n = dist.get_world_size(group)
    if n & (n - 1):
        return fq12_reduce_mul_psum_style(f, group)
    f = fq12_cap(f)
    me = dist.get_rank(group)
    dev = f.device
    wire = wire_device(group, dev)
    shift = 1
    while shift < n:
        mate = me ^ shift
        peer = dist.get_global_rank(group, mate) if group is not None else mate
        mine = _pack(f).to(wire).contiguous()
        theirs = torch.empty_like(mine)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, peer, group),
                                       dist.P2POp(dist.irecv, theirs, peer, group)])
        for req in reqs:
            req.wait()
        partner = _unpack(theirs.to(dev))
        f = _mul(f, partner) if me < mate else _mul(partner, f)
        shift *= 2
    return f


def fq12_reduce_mul_psum_style(f: Fq12, group: Optional[dist.ProcessGroup] = None) -> Fq12:
    """All-reduce via one ``all_gather`` of the limbs and a local chain of
    products in rank order: one hop, for small groups or any size. The
    same value as the butterfly, and the same limbs on every rank."""
    n = dist.get_world_size(group)
    f = fq12_cap(f)
    dev = f.device
    mine = _pack(f).to(wire_device(group, dev)).contiguous()
    gathered = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(gathered, mine, group=group)
    out = _unpack(gathered[0].to(dev))
    for limbs in gathered[1:]:
        out = _mul(out, _unpack(limbs.to(dev)))
    return out
