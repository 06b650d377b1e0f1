"""Multi-process execution over ``torch.distributed`` (P4 of the mesh map).

PyTorch counterpart of ``pairing_tpu/parallel/launch.py``. The reference
runs one JAX process per host; the port runs one process per device, each
in the same global process group, with a mesh whose leading axis spans
hosts (``dcn``) and whose trailing axis spans the processes of a host
(``data``). Only the multi-pairing product's reduce crosses processes
(``mesh.multi_pairing_sharded``); data-parallel batches never communicate.

Launch, one command per process:

    python -m pairing_tpu_torch.parallel.launch \\
        --coordinator HOST0:29500 --num-processes 2 --process-id $I

or under ``torchrun`` (which sets RANK, WORLD_SIZE, LOCAL_RANK and
MASTER_ADDR/PORT) with no arguments: ``init_distributed()`` then reads
``env://``.

  * ``--cpu-smoke`` runs gloo with CPU tensors: the kernels take their
    plain versions, and the substrate is testable without a card
    (``tests/test_torch_parallel.py`` runs two processes).
  * ``--backend gloo --device cuda`` launches the kernels on the card and
    exchanges limbs through the host. Two processes can share one card
    this way; NCCL refuses two ranks on one device.
  * The default, ``--backend nccl --device cuda``, wants one card a
    process.
"""

from __future__ import annotations

import argparse
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> None:
    """Initialize the default process group (idempotent).

    With ``coordinator`` ("host:port") the group meets over
    ``tcp://coordinator`` with ``num_processes`` ranks, this one
    ``process_id``. With no arguments it reads ``env://`` (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as torchrun sets them). On NCCL
    it first makes the rank's local device current: LOCAL_RANK when set,
    else the rank modulo the number of cards.
    """
    if dist.is_initialized():
        return
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        kwargs = dict(init_method=f"tcp://{coordinator}", world_size=num_processes,
                      rank=process_id)
        rank = process_id
    else:
        kwargs = dict(init_method="env://")
        rank = int(os.environ.get("RANK", "0"))
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, **kwargs)


def mesh_device_type() -> str:
    """The ``DeviceMesh`` device type for the default group's backend:
    "cuda" over NCCL, "cpu" over gloo (whose groups cross the host)."""
    return "cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu"


def make_hybrid_mesh(ici_axis: str = "data", dcn_axis: str = "dcn") -> DeviceMesh:
    """Global mesh [hosts (dcn) x processes per host].

    The hosts are told apart by name; ranks must be grouped by host
    (torchrun numbers them so). On one host this is a [1, world] mesh: the
    same program runs from one process to many hosts.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_hybrid_mesh needs an initialized process group: call "
                           "init_distributed first")
    world = dist.get_world_size()
    names = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    hosts = list(dict.fromkeys(names))
    per_host = world // len(hosts)
    if per_host * len(hosts) != world or any(names[r] != hosts[r // per_host]
                                              for r in range(world)):
        raise RuntimeError(f"ranks are not grouped evenly by host: {names}")
    return init_device_mesh(mesh_device_type(), (len(hosts), per_host),
                            mesh_dim_names=(dcn_axis, ici_axis))


def _smoke(args) -> bool:
    """A small end-to-end multi-process drive: data-parallel pairings over
    the global mesh, each rank's shard against the oracle, and one product
    of 2 x world pairings with its reduce across every process; prints a
    line for each process. Returns whether every rank agreed."""
    from ..curves.g1 import g1_from_ints
    from ..curves.g2 import g2_from_ints
    from ..fields.fp12 import fq12_to_int_coeffs
    from ..oracle import native as o
    from ..utils import bn254 as c
    from ..utils.interop import reshape_points
    from . import mesh as M

    backend, device = ("gloo", "cpu") if args.cpu_smoke else (args.backend, args.device)
    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(args.coordinator, args.num_processes, args.process_id, backend)
    if device == "cuda":
        device = f"cuda:{torch.cuda.current_device()}"
    mesh = make_hybrid_mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world * args.per_device_batch
    axes = ("dcn", "data")

    rng = np.random.RandomState(11)  # the same inputs on every process
    scal = [int(rng.randint(1, 1 << 30)) for _ in range(n + 2 * world)]
    g1s = [o.g1_mul(c.G1_GEN, s) for s in scal]
    g2s = [o.g2_mul((c.G2_GEN_X, c.G2_GEN_Y), s + 1) for s in scal]

    p, q = g1_from_ints(g1s[:n], device), g2_from_ints(g2s[:n], device)
    shard = M.pairing_data_parallel(mesh, p, q, axis=axes)
    lo, hi = M.axis_share(mesh, axes, n, "a batch")
    ok = fq12_to_int_coeffs(shard) == [o.pairing(a, b) for a, b in zip(g1s[lo:hi], g2s[lo:hi])]

    k = 2 * world  # one product of k pairs, k / world on each rank
    ps = reshape_points(g1_from_ints(g1s[n:], device), (k, 1))
    qs = reshape_points(g2_from_ints(g2s[n:], device), (k, 1))
    prod = M.multi_pairing_sharded(mesh, ps, qs, axis=axes)
    ok = ok and fq12_to_int_coeffs(prod) == [
        o.final_exp(o.multi_miller_loop(list(zip(g1s[n:], g2s[n:]))))]

    flag = torch.tensor([int(ok)], dtype=torch.int32,
                        device=device if backend == "nccl" else "cpu")
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    agreed = bool(flag.item())
    print(f"process {rank}/{world}: mesh {tuple(mesh.shape)}, batch {n}, product of {k} "
          f"pairings: {'OK' if agreed else 'MISMATCH'}", flush=True)
    dist.destroy_process_group()
    return agreed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None, help="host:port of rank 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--per-device-batch", type=int, default=1)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cpu-smoke", action="store_true",
                    help="gloo with CPU tensors (the kernels' plain versions)")
    args = ap.parse_args()
    return 0 if _smoke(args) else 1


if __name__ == "__main__":
    raise SystemExit(main())
