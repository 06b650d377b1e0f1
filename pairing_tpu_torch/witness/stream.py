"""Streamed witness generation for batches beyond the card's memory.

PyTorch counterpart of ``pairing_tpu/witness/stream.py``. A full pairing
witness trace takes about 350 KB a lane (the three 64-row x-power ladders
194 KB, the Miller steps 67 KB, the lines 45 KB, the affine trajectory
44 KB), 5.7 GB at 16384 lanes. This module runs a large batch
in fixed-size chunks and overlaps each chunk's device-to-host copy of its
trace with the next chunk's compute:

  1. chunk i runs on the current stream, then an event is recorded;
  2. a side stream waits on that event and copies every leaf out with
     ``non_blocking=True`` (into pinned memory from torch's caching host
     allocator), then records a copy event;
  3. chunk i + 1 runs on the current stream;
  4. the host waits on chunk i's copy event, wraps the host tensors as
     numpy arrays and yields them.

The reference relies on JAX's asynchronous dispatch for the same overlap.
The port's glue makes blocking host-to-device copies, each of which waits
for the current stream, so the copies go on a stream of their own: they
run on the copy engine while the host waits for chunk i + 1's kernels.

Peak device residency is two chunks: the one computing and the one being
drained, whose device tensors stay referenced until its copy event has
completed, so the caching allocator cannot hand their memory to the next
chunk. The stream keeps no reference to a chunk it has yielded, so the
pinned host blocks of a chunk the caller has dropped serve the next one. Leaves that are views of one device buffer (the kernel layout is
batch-last, so most trace leaves are strided views of a few kernel
outputs) are copied once, as the buffer's span, and rebuilt as views of
the host copy with the same strides: nothing is copied twice and no
contiguous copy is made on the device.

On CPU tensors the same loop runs without streams or events: each chunk is
computed, its leaves are copied the same way, and it is handed over.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Tuple

import torch

from ..curves.g1 import G1
from ..curves.g2 import G2
from ..utils.interop import map_limbs
from .trace import pairing_witness


def map_tensors(tree, fn, kind=torch.Tensor):
    """``tree`` with ``fn`` applied to every leaf of type ``kind`` (torch
    tensors by default): dicts, lists, tuples, named tuples and dataclasses
    are rebuilt with the same types; any other leaf is kept as it is."""
    if isinstance(tree, kind):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: map_tensors(getattr(tree, f.name), fn, kind)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return type(tree)((k, map_tensors(v, fn, kind)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(v, fn, kind) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(v, fn, kind) for v in tree)
    return tree


def tensor_leaves(tree, kind=torch.Tensor) -> list:
    """The leaves of type ``kind`` of ``tree`` in :func:`map_tensors` order
    (``kind=numpy.ndarray`` walks a tree the stream yielded)."""
    out = []
    map_tensors(tree, out.append, kind)
    return out


def _extent(t: torch.Tensor) -> int:
    """Elements of t's storage from its offset to its last element, + 1."""
    return 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))


def _key(t: torch.Tensor):
    return t.untyped_storage().data_ptr(), t.dtype, t.device


def spans(tree) -> dict:
    """{(storage, dtype, device): (lo, hi)}: the element range of each
    storage that the tensor leaves of ``tree`` read."""
    out = {}
    for t in tensor_leaves(tree):
        if t.numel() == 0:
            continue
        lo, hi = out.get(_key(t), (t.storage_offset(), 0))
        out[_key(t)] = (min(lo, t.storage_offset()), max(hi, t.storage_offset() + _extent(t)))
    return out


def span_bytes(tree) -> int:
    """Bytes :func:`copy_out` moves for ``tree``."""
    return sum((hi - lo) * key[1].itemsize for key, (lo, hi) in spans(tree).items())


def copy_out(tree, non_blocking: bool):
    """Start copying every tensor leaf of ``tree`` to the host.

    Leaves are grouped by storage and dtype; each group's span (from its
    lowest element to its highest) is copied once and every leaf is
    rebuilt as a view of the host copy with its own shape and strides.
    Returns the host tree (torch CPU tensors; complete once the copies
    issued on the current stream have finished)."""
    ranges, copies = spans(tree), {}
    for t in tensor_leaves(tree):
        key = _key(t)
        if key in ranges and key not in copies:
            lo, hi = ranges[key]
            span = t.as_strided((hi - lo,), (1,), lo)
            copies[key] = (lo, span.to("cpu", non_blocking=non_blocking, copy=True))

    def host(t: torch.Tensor) -> torch.Tensor:
        if t.numel() == 0:
            return torch.empty(t.shape, dtype=t.dtype)
        lo, span = copies[_key(t)]
        return span.as_strided(t.shape, t.stride(), t.storage_offset() - lo)

    return map_tensors(tree, host)


def make_stream_fn(collect: Optional[Callable] = None) -> Callable:
    """The per-chunk function: ``pairing_witness`` then ``collect``.

    The port runs eagerly, so there is nothing to compile; the name is kept
    so that a reader finds the reference's counterpart."""
    if collect is None:
        def collect(out, trace):
            return out, trace

    def run(pc: G1, qc: G2):
        out, trace = pairing_witness(pc, qc)
        return collect(out, trace)

    return run


def witness_stream(
    p: G1,
    q: G2,
    chunk_size: int,
    collect: Optional[Callable] = None,
    fn: Optional[Callable] = None,
) -> Iterator[Tuple[int, object, object]]:
    """Yield ``(start, out_host, trace_host)`` per chunk of a big batch.

    ``p``/``q`` carry a flat leading batch axis on one device; the batch
    must divide evenly into ``chunk_size`` chunks (pad the tail as
    ``parallel.runner.pairing_stream`` would: witness consumers index lanes
    explicitly, so padding is the caller's policy), else ``ValueError``. An
    empty batch yields nothing.

    ``collect(out, trace) -> (out_like, trace_like)`` selects what is
    streamed to the host (default: everything); it must return a 2-tuple.
    The yielded structures are those ``collect`` returns (the port's
    dataclasses, dicts, lists and tuples) with every tensor replaced by a
    numpy array, which belongs to the caller: a later chunk never writes
    it. Pass ``fn`` (from :func:`make_stream_fn`, or any function of a
    chunk's (p, q) returning a 2-tuple) to replace the per-chunk function;
    ``collect`` is ignored when ``fn`` is given.
    """
    n = p.batch_shape[0] if p.batch_shape else 0
    if q.batch_shape[:1] != p.batch_shape[:1]:
        raise ValueError(f"G1 batch {p.batch_shape}, G2 batch {q.batch_shape}")
    if chunk_size < 1 or n % chunk_size:
        raise ValueError(f"batch {n} not divisible by chunk_size {chunk_size}; pad the tail")
    if fn is None:
        fn = make_stream_fn(collect)
    cuda = p.x.limbs.is_cuda

    def chunk(start):
        def cut(limbs):
            return limbs[start:start + chunk_size]

        return fn(map_limbs(p, cut), map_limbs(q, cut))

    def handed_over(host):
        out, trace = map_tensors(host, torch.Tensor.numpy)
        return out, trace

    if not cuda:
        for start in range(0, n, chunk_size):
            yield (start, *handed_over(copy_out(chunk(start), non_blocking=False)))
        return

    dev = p.x.limbs.device
    current = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    pending = None  # (start, host tree, copy event, device result) of the chunk in flight
    for start in range(0, n, chunk_size):
        res = chunk(start)
        computed = torch.cuda.Event()
        computed.record(current)
        side.wait_event(computed)
        with torch.cuda.stream(side):
            host = copy_out(res, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(side)
        if pending is not None:
            item = _drained(pending, handed_over)
            pending = None  # its copy has completed: its device tensors may go
            yield item
            del item  # the caller's alone now: once dropped, its pinned blocks serve again
        pending = (start, host, copied, res)
        del res, host
    if pending is not None:
        item = _drained(pending, handed_over)
        pending = None
        yield item


def _drained(pending, handed_over):
    """Wait for a chunk's copy event (its device result still referenced
    by ``pending``); returns (start, out, trace) on the host."""
    start, host, copied, _ = pending
    copied.synchronize()
    return (start, *handed_over(host))
