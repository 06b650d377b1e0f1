"""The port's parallel layer on the CPU: gloo over 127.0.0.1, real processes.

Each world is one run of this file as a script (``python
tests/test_torch_parallel.py <case> <rank> <world> <port> <out>``), one
process a rank, one thread each, under a timeout; every rank writes what
it computed to ``<out>/rank<r>.npz`` and the tests read those files:

  * world 2 (``main``): both collectives (the butterfly of
    ``fq12_all_reduce_mul`` and the all-gather form) on seeded random Fq12
    values; ``multi_pairing_sharded`` on the K = 2, B = 2 products of
    ``tests/data/torch_multi_fixture.npz`` (its XLA ``pairing_k2`` and
    ``miller_k2``); ``pairing_data_parallel`` on 2 lanes of
    ``torch_pairing_fixture.npz``; the sharded ``pairing_stream`` on 3
    pairs in chunks of 2 (rank 1 has no lane of the ragged tail),
    checkpointed and resumed;
  * world 3 (``collectives``): both collectives take the all-gather form;
  * ``python -m pairing_tpu_torch.parallel.launch --cpu-smoke`` with two
    processes, as tests/test_multihost.py runs the JAX package's.

On CPU tensors every kernel takes its plain version. Comparison is exact,
on canonical limbs, against the oracle and the JAX fixtures. The unsharded
``pairing_stream`` yields the oracle's canonical limbs
(tests/test_torch_runner.py), so equality with those is equality with the
unsharded chunks. The three runs start together: about 55 s.
"""

import os
import random
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)  # the worker sets one thread a rank

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
LANES = 2  # lanes of each rank's random Fq12 value
SEED = 555
TIMEOUT = 400


def random_values(world):
    """world x LANES Fq12 values as coefficient lists, the same on every rank."""
    from pairing_tpu_torch.utils.bn254 import P

    rng = random.Random(SEED + world)
    return [[[rng.randrange(P) for _ in range(12)] for _ in range(LANES)] for _ in range(world)]


def fixture_points(name, n):
    """The first n (G1, G2) pairs of a fixture npz, as ints."""
    from pairing_tpu_torch.fields.fp import limbs_to_int

    data = np.load(DATA / name)
    g1 = [tuple(limbs_to_int(v) for v in row) for row in data["g1"][:n]]
    g2 = [((limbs_to_int(r[0]), limbs_to_int(r[1])), (limbs_to_int(r[2]), limbs_to_int(r[3])))
          for r in data["g2"][:n]]
    return data, g1, g2


# ---------------------------------------------------------------------------
# The worker: one rank of a world
# ---------------------------------------------------------------------------


def _collectives(rank, world, out):
    from pairing_tpu_torch.fields.fp12 import fq12_from_int_coeffs, fq12_to_canonical_limbs
    from pairing_tpu_torch.parallel.collectives import (fq12_all_reduce_mul,
                                                        fq12_reduce_mul_psum_style)

    f = fq12_from_int_coeffs(random_values(world)[rank], "cpu")
    for name, fn in (("all_reduce", fq12_all_reduce_mul), ("psum", fq12_reduce_mul_psum_style)):
        r = fn(f)
        out[name] = fq12_to_canonical_limbs(r).numpy()
        out[name + "_raw"] = np.stack([c.limbs.numpy() for s in r.s for c in (s.c0, s.c1)])


def _main_case(rank, world, out, tmp):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.fields.fp12 import fq12_to_canonical_limbs
    from pairing_tpu_torch.parallel import mesh as M
    from pairing_tpu_torch.parallel import runner
    from pairing_tpu_torch.utils.config import PairingConfig
    from pairing_tpu_torch.utils.interop import reshape_points

    _collectives(rank, world, out)

    # multi_pairing_sharded: the fixture's K = 2 products of B = 2 (pair k
    # of product b is k * B + b)
    _, g1, g2 = fixture_points("torch_multi_fixture.npz", 4)
    ps = reshape_points(pt.g1_from_ints(g1, "cpu"), (2, 2))
    qs = reshape_points(pt.g2_from_ints(g2, "cpu"), (2, 2))
    mesh = M.make_mesh((world,), ("pairs",), device_type="cpu")
    seen = {}
    miller_loop, final_exp = M.multi_miller_loop, M.final_exp

    def partial(q, p):  # this rank's partial Miller product
        seen["part"] = miller_loop(q, p)
        return seen["part"]

    def finish(f):  # the all-reduced product
        seen["reduced"] = f
        return final_exp(f)

    M.multi_miller_loop, M.final_exp = partial, finish
    try:
        out["multi"] = fq12_to_canonical_limbs(M.multi_pairing_sharded(mesh, ps, qs)).numpy()
    finally:
        M.multi_miller_loop, M.final_exp = miller_loop, final_exp
    out["miller_part"] = fq12_to_canonical_limbs(seen["part"]).numpy()
    out["miller_reduced"] = fq12_to_canonical_limbs(seen["reduced"]).numpy()

    # pairing_data_parallel on 2 lanes; a batch of 3 does not divide
    _, g1, g2 = fixture_points("torch_pairing_fixture.npz", 3)
    mesh = M.make_mesh((world,), ("data",), device_type="cpu")
    p, q = pt.g1_from_ints(g1[:2], "cpu"), pt.g2_from_ints(g2[:2], "cpu")
    out["data_parallel"] = fq12_to_canonical_limbs(M.pairing_data_parallel(mesh, p, q)).numpy()
    try:
        M.pairing_data_parallel(mesh, pt.g1_from_ints(g1, "cpu"), pt.g2_from_ints(g2, "cpu"))
    except ValueError:
        out["ragged_refused"] = np.array(True)

    # the sharded pairing_stream, every pairing call of this rank counted
    calls = []
    pairing = runner.api.pairing

    def counted(a, b):
        calls.append(a.batch_shape[0])
        return pairing(a, b)

    runner.api.pairing = counted
    cfg = PairingConfig(device="cpu", chunk_size=2, checkpoint_dir=str(tmp / "ckpt"),
                        mesh_shape=(world,), mesh_axes=("data",))
    first = list(runner.pairing_stream(g1, g2, cfg))
    out["stream_calls"] = np.array(calls)
    again = list(runner.pairing_stream(g1, g2, cfg))
    out["resume_calls"] = np.array(calls[len(out["stream_calls"]):] or [0])
    runner.api.pairing = pairing
    for i, (a, b) in enumerate(zip(first, again)):
        out[f"stream_{i}"], out[f"resumed_{i}"] = a, b
    out["checkpoints"] = np.array(sorted(os.listdir(cfg.checkpoint_dir)))


def worker(case, rank, world, port, outdir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    out = {}
    if case == "collectives":
        _collectives(rank, world, out)
    else:
        _main_case(rank, world, out, Path(outdir))
    np.savez(Path(outdir) / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


def _free_ports(n):
    """n distinct free ports on 127.0.0.1 (all bound at once, then freed)."""
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    env.pop("PYTHONSTARTUP", None)
    return env


def _start(cmds):
    return [subprocess.Popen(cmd, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for cmd in cmds]


def _wait(procs):
    """Wait for every process under TIMEOUT (killing the rest on a
    failure); each must exit 0. Their outputs."""
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=TIMEOUT)[0])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for r, (pr, text) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"process {r} failed:\n{text}"
    return outs


def _world(case, world, outdir, port):
    return _start([[sys.executable, str(Path(__file__).resolve()), case, str(r), str(world),
                    str(port), str(outdir)] for r in range(world)])


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every multi-process run of this file, started together."""
    dirs = {w: tmp_path_factory.mktemp(f"world{w}") for w in (2, 3)}
    ports = _free_ports(3)
    runs = {
        2: _world("main", 2, dirs[2], ports[0]),
        3: _world("collectives", 3, dirs[3], ports[1]),
        "smoke": _start([[sys.executable, "-m", "pairing_tpu_torch.parallel.launch",
                          "--cpu-smoke", "--coordinator", f"127.0.0.1:{ports[2]}",
                          "--num-processes", "2", "--process-id", str(pid),
                          "--per-device-batch", "1"] for pid in range(2)]),
    }
    yield runs, dirs
    for procs in runs.values():
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()


def _ranks(started, world):
    runs, dirs = started
    _wait(runs[world])
    return [dict(np.load(dirs[world] / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def world2(started):
    return _ranks(started, 2)


@pytest.fixture(scope="module")
def world3(started):
    return _ranks(started, 3)


def _oracle_limbs(coeffs):
    from pairing_tpu_torch.fields.fp import int_to_limbs

    return np.asarray([[int_to_limbs(v) for v in row] for row in coeffs], dtype=np.int32)


@pytest.mark.parametrize("name", ["all_reduce", "psum"])
@pytest.mark.parametrize("world", [2, 3])
def test_collectives_match_oracle_on_every_rank(request, world, name):
    """world 2 runs the butterfly (all_reduce) and the all-gather form
    (psum); world 3 is not a power of two, so both take the all-gather."""
    from pairing_tpu_torch.oracle import native as o

    ranks = request.getfixturevalue(f"world{world}")
    vals = random_values(world)
    want = []
    for lane in range(LANES):
        acc = vals[0][lane]
        for r in range(1, world):
            acc = o.fq12_mul(acc, vals[r][lane])
        want.append(acc)
    for out in ranks:
        assert out[name].tolist() == _oracle_limbs(want).tolist()
        # every rank holds the same limbs, not only the same value
        assert out[name + "_raw"].tolist() == ranks[0][name + "_raw"].tolist()


def test_multi_pairing_sharded_matches_jax_and_oracle(world2):
    from pairing_tpu_torch.oracle import native as o

    data, g1, g2 = fixture_points("torch_multi_fixture.npz", 4)
    want = [o.final_exp(o.multi_miller_loop([(g1[k * 2 + b], g2[k * 2 + b]) for k in range(2)]))
            for b in range(2)]
    for out in world2:
        assert out["multi"].tolist() == data["pairing_k2"].tolist()
        assert out["multi"].tolist() == _oracle_limbs(want).tolist()


def test_sharded_partial_miller_products_compose(world2):
    """Each rank's partial is its own pair's Miller value (epilogue lines
    included); their product is the K = 2 loop's f, limb for limb with the
    fixture's XLA miller_k2."""
    from pairing_tpu_torch.oracle import native as o

    data, g1, g2 = fixture_points("torch_multi_fixture.npz", 4)
    for r, out in enumerate(world2):
        want = [o.multi_miller_loop([(g1[r * 2 + b], g2[r * 2 + b])]) for b in range(2)]
        assert out["miller_part"].tolist() == _oracle_limbs(want).tolist()
        assert out["miller_reduced"].tolist() == data["miller_k2"].tolist()


def test_pairing_data_parallel_shards_match_jax(world2):
    data, _, _ = fixture_points("torch_pairing_fixture.npz", 2)
    for r, out in enumerate(world2):
        assert out["data_parallel"].shape == (1, 12, 21)
        assert out["data_parallel"].tolist() == data["pairing"][r:r + 1].tolist()
        assert bool(out["ragged_refused"])


def test_sharded_pairing_stream_matches_unsharded(world2):
    from pairing_tpu_torch.oracle import native as o

    data, g1, g2 = fixture_points("torch_pairing_fixture.npz", 3)
    want = _oracle_limbs([o.pairing(a, b) for a, b in zip(g1, g2)])
    assert want.tolist() == data["pairing"][:3].tolist()
    for out in world2:
        chunks = [out["stream_0"], out["stream_1"]]
        assert [c.shape for c in chunks] == [(2, 12, 21), (1, 12, 21)]
        assert np.concatenate(chunks).tolist() == want.tolist()
        assert [out["resumed_0"].tolist(), out["resumed_1"].tolist()] == [
            c.tolist() for c in chunks]
        assert out["resume_calls"].tolist() == [0]  # resumed from the checkpoints
    # each rank paired its share: rank 1 had no lane of the ragged tail
    assert world2[0]["stream_calls"].tolist() == [1, 1]
    assert world2[1]["stream_calls"].tolist() == [1]
    # one set of checkpoints, written by rank 0 alone
    assert world2[1]["checkpoints"].tolist() == ["pairing_chunk_000000.npz",
                                                 "pairing_chunk_000001.npz"]


def test_make_mesh_needs_a_process_group():
    from pairing_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh()


def test_config_mesh_fields():
    from pairing_tpu_torch.utils.config import PairingConfig

    cfg = PairingConfig()
    assert (cfg.mesh_shape, cfg.mesh_axes) == (None, ("data",))
    assert PairingConfig(mesh_shape=(2, 4), mesh_axes=("dcn", "data")).mesh_shape == (2, 4)


def test_launch_cpu_smoke_two_processes(started):
    outs = _wait(started[0]["smoke"])
    for pid, text in enumerate(outs):
        assert f"process {pid}/2: mesh (1, 2), batch 2, product of 4 pairings: OK" in text, text


if __name__ == "__main__":
    case, rank, world, port, outdir = sys.argv[1:6]
    worker(case, int(rank), int(world), int(port), outdir)
