"""Device meshes and sharded pairing entry points over ``torch.distributed``.

PyTorch counterpart of ``pairing_tpu/parallel/mesh.py``. The reference is
single-controller: one process sees every device of ``jax.devices()`` and
places shards of global arrays. The port is multi-controller (SPMD): one
process per device, a process group over them, and a
``torch.distributed.device_mesh.DeviceMesh`` that names its axes. Every
rank calls the same function on the same global batch and computes its
share on its own device.

  P1  lane batching     every kernel is batch-last; thousands of pairings
                        a launch.
  P2  data parallelism  ``pairing_data_parallel``: independent pairings
                        split over a mesh axis; no communication at all.
  P3  multi-pairing     ``multi_pairing_sharded``: the pairs axis split
                        over a mesh axis, one partial Miller product per
                        rank, a multiplicative all-reduce
                        (``collectives.fq12_all_reduce_mul``), one final
                        exponentiation.
  P4  cross-host        the same meshes with a leading ``dcn`` axis
                        (``launch.make_hybrid_mesh``).
  P5  comm backend      NCCL between CUDA devices, gloo through the host.

An ``axis`` argument names one mesh dimension or a tuple of them; a tuple
splits the batch over their product in row-major order, as a JAX
``PartitionSpec`` entry of several axes does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..curves.g1 import G1
from ..curves.g2 import G2
from ..fields.fp12 import Fq12
from ..pairing import api
from ..pairing.final_exp import final_exp
from ..pairing.miller_loop import multi_miller_loop
from ..utils.interop import map_limbs
from .collectives import fq12_all_reduce_mul

Axis = Union[str, Sequence[str]]


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("data",),
    device_type: str = "cuda",
) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` (default: ``(world_size,)``) with axes
    ``axis_names`` over the initialized default process group.

    It initializes nothing itself: call ``launch.init_distributed`` (or
    ``torch.distributed.init_process_group``) first. ``device_type`` is
    "cuda" over NCCL; over gloo pass "cpu", whose subgroups cross the host
    wherever the tensors live.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group: call "
                           "pairing_tpu_torch.parallel.launch.init_distributed first")
    if shape is None:
        shape = (dist.get_world_size(),)
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


def axis_names(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh: DeviceMesh, axis: Axis) -> int:
    n = 1
    for name in axis_names(axis):
        n *= mesh.size(mesh.mesh_dim_names.index(name))
    return n


def axis_index(mesh: DeviceMesh, axis: Axis) -> int:
    """This rank's row-major coordinate over the named mesh dimensions."""
    idx = 0
    for name in axis_names(axis):
        idx = idx * mesh.size(mesh.mesh_dim_names.index(name)) + mesh.get_local_rank(name)
    return idx


def axis_share(mesh: DeviceMesh, axis: Axis, n: int, what: str) -> Tuple[int, int]:
    """[lo, hi) of this rank's contiguous share of ``n`` items split evenly
    over ``axis``; a count the axis does not divide raises, as a JAX
    sharding of that shape would."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{what} of {n} does not divide over mesh axis {axis!r} of size {size}")
    share = n // size
    lo = axis_index(mesh, axis) * share
    return lo, lo + share


def _slice(points, lo: int, hi: int):
    return map_limbs(points, lambda limbs: limbs[lo:hi])


def pairing_data_parallel(mesh: DeviceMesh, p: G1, q: G2, axis: Axis = "data") -> Fq12:
    """P2: independent pairings, the leading batch axis split over ``axis``.

    Every rank passes the same global batch; each pairs its contiguous
    share on the device its operands lie on and returns that shard (batch
    [n / axis size, ...]), with no collective, as the reference's sharded
    output has none.
    """
    lo, hi = axis_share(mesh, axis, p.batch_shape[0], "a batch")
    return api.pairing(_slice(p, lo, hi), _slice(q, lo, hi))


def multi_pairing_sharded(mesh: DeviceMesh, ps: G1, qs: G2, axis: Axis = "pairs") -> Fq12:
    """P3: product of K pairings, the leading pairs axis split over ``axis``.

    Each rank runs ``multi_miller_loop`` on its K / size pairs into a
    partial Fq12, the partials are multiplied together over the axis'
    process groups (``fq12_all_reduce_mul``, one dimension after the
    other), and one ``final_exp`` finishes; the result is replicated on
    every rank, batch ``ps.batch_shape[1:]``.

    The partial products compose to the whole product's Miller value:
    each starts from one, and the shared square of every step distributes
    over the product ((a b)^2 = a^2 b^2), so the product of the partials
    equals the K-pair loop's f. The epilogue lines, which the port's Miller
    loop multiplies into f at its end, are factors of each pair's value and
    compose the same way.
    """
    lo, hi = axis_share(mesh, axis, ps.batch_shape[0], "a pairs axis")
    f = multi_miller_loop(_slice(qs, lo, hi), _slice(ps, lo, hi))
    for name in axis_names(axis):
        f = fq12_all_reduce_mul(f, mesh.get_group(name))
    return final_exp(f)
