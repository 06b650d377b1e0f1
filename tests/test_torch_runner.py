"""The port's streaming runner (``parallel.runner.pairing_stream``) and its
config (``utils.config.PairingConfig``) on the CPU, as
tests/test_parallel.py holds the JAX package's: 3 pairs in chunks of 2 (a
full chunk and a ragged tail of 1, not padded), checkpointed, resumed from
the checkpoints, and refused against changed inputs. Then the publication
of a checkpoint by rename: in copies of the checkpoint directory, a whole
or truncated file left under a temporary name (as by a run killed
mid-write) is ignored and its chunk recomputed, and only the chunks with
no file are computed. Six plain pairing calls, at batch 2 once and 1
five times, about 60 s on two threads.
"""

import dataclasses
import io
import os
import shutil

import numpy as np
import pytest
import torch

from pairing_tpu_torch.fields.fp12 import fq12_limbs_to_int_coeffs
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.parallel import runner
from pairing_tpu_torch.parallel.runner import pairing_stream
from pairing_tpu_torch.utils import bn254 as c
from pairing_tpu_torch.utils.config import PairingConfig

torch.set_num_threads(2)

N = 3
G1S = [o.g1_mul(c.G1_GEN, 3 + i) for i in range(N)]
G2S = [o.g2_mul((c.G2_GEN_X, c.G2_GEN_Y), 5 + i) for i in range(N)]


def test_config_defaults_and_frozen():
    cfg = PairingConfig()
    assert (cfg.device, cfg.chunk_size, cfg.checkpoint_dir) == ("cuda", 8192, None)
    assert not hasattr(cfg, "backend") and not hasattr(cfg, "apply_backend")
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.chunk_size = 1


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    cfg = PairingConfig(device="cpu", chunk_size=2, checkpoint_dir=str(ckpt))
    calls = []
    pairing = runner.api.pairing

    def counted(p, q):
        calls.append(p.batch_shape)
        return pairing(p, q)

    runner.api.pairing = counted
    try:
        first = list(pairing_stream(G1S, G2S, cfg))
        again = list(pairing_stream(G1S, G2S, cfg))
    finally:
        runner.api.pairing = pairing
    return cfg, first, again, calls


def test_stream_chunks_match_oracle_with_ragged_tail(streamed):
    cfg, first, _, calls = streamed
    assert [ch.shape for ch in first] == [(2, 12, 21), (1, 12, 21)]
    assert all(ch.dtype == np.int32 for ch in first)
    assert calls[:2] == [(2,), (1,)]  # the tail chunk is not padded
    got = [v for ch in first for v in fq12_limbs_to_int_coeffs(ch)]
    assert got == [o.pairing(p, q) for p, q in zip(G1S, G2S)]
    assert sorted(os.listdir(cfg.checkpoint_dir)) == ["pairing_chunk_000000.npz",
                                                       "pairing_chunk_000001.npz"]


def test_stream_resumes_from_checkpoints(streamed):
    _, first, again, calls = streamed
    assert len(calls) == 2  # the second run computed nothing
    assert len(again) == len(first)
    for a, b in zip(first, again):
        assert a.tolist() == b.tolist()


def test_stream_refuses_changed_inputs(streamed):
    cfg = streamed[0]
    changed = list(G1S)
    changed[0] = o.g1_mul(c.G1_GEN, 99)
    with pytest.raises(ValueError, match="different"):
        next(iter(pairing_stream(changed, G2S, cfg)))


def test_stream_refuses_unequal_inputs():
    with pytest.raises(ValueError):
        next(iter(pairing_stream(G1S, G2S[:2], PairingConfig(device="cpu"))))


def _rerun(streamed, tmp_path, prepare):
    """Copy the checkpoint directory, let ``prepare(dir)`` change it, stream
    again over it; (the chunks, the batch shapes of the pairing calls)."""
    cfg, first = streamed[0], streamed[1]
    ckpt = tmp_path / "ckpt"
    shutil.copytree(cfg.checkpoint_dir, ckpt)
    prepare(ckpt)
    calls = []
    pairing = runner.api.pairing

    def counted(p, q):
        calls.append(p.batch_shape)
        return pairing(p, q)

    runner.api.pairing = counted
    try:
        again = list(pairing_stream(G1S, G2S, dataclasses.replace(cfg, checkpoint_dir=str(ckpt))))
    finally:
        runner.api.pairing = pairing
    assert [a.tolist() for a in again] == [a.tolist() for a in first]
    return ckpt, calls


def test_leftover_temporary_file_is_ignored_and_its_chunk_recomputed(streamed, tmp_path):
    """A run killed between the write and the rename leaves the whole file
    under its temporary name: the resume does not take it, recomputes the
    chunk and publishes it under its final name."""
    final = "pairing_chunk_000001.npz"
    tmp = f"{final}.4242.tmp"

    def prepare(ckpt):
        os.replace(ckpt / final, ckpt / tmp)

    ckpt, calls = _rerun(streamed, tmp_path, prepare)
    assert calls == [(1,)]
    assert sorted(os.listdir(ckpt)) == ["pairing_chunk_000000.npz", final, tmp]
    with np.load(ckpt / final) as z:
        assert z["limbs"].tolist() == streamed[1][1].tolist()


def test_truncated_temporary_file_never_blocks_a_resume(streamed, tmp_path):
    """A write interrupted halfway leaves no file under the chunk's final
    name; a run killed mid-write leaves a truncated file under a temporary
    name, which the resume ignores: it reads the whole checkpoint beside it
    and computes only the chunk that has no final file."""
    cfg = streamed[0]
    interrupted = tmp_path / "interrupted"
    shutil.copytree(cfg.checkpoint_dir, interrupted)
    (interrupted / "pairing_chunk_000001.npz").unlink()
    savez = runner.np.savez

    def half_then_killed(f, **arrays):
        whole = io.BytesIO()
        savez(whole, **arrays)
        f.write(whole.getvalue()[: len(whole.getvalue()) // 2])
        raise KeyboardInterrupt

    runner.np.savez = half_then_killed
    try:
        with pytest.raises(KeyboardInterrupt):
            list(pairing_stream(G1S, G2S, dataclasses.replace(
                cfg, checkpoint_dir=str(interrupted))))
    finally:
        runner.np.savez = savez
    assert sorted(os.listdir(interrupted)) == ["pairing_chunk_000000.npz"]

    def prepare(ckpt):
        whole = (ckpt / "pairing_chunk_000001.npz").read_bytes()
        (ckpt / "pairing_chunk_000001.npz").unlink()
        (ckpt / "pairing_chunk_000001.npz.4242.tmp").write_bytes(whole[: len(whole) // 2])
        (ckpt / "pairing_chunk_000000.npz.4243.tmp").write_bytes(b"")

    ckpt, calls = _rerun(streamed, tmp_path, prepare)
    assert calls == [(1,)]
    with np.load(ckpt / "pairing_chunk_000001.npz") as z:
        assert z["limbs"].shape == (1, 12, 21)


def test_resume_computes_only_the_chunks_without_a_file(streamed, tmp_path):
    """A chunk with a checkpoint is read, never recomputed or rewritten; a
    chunk without one is computed and published by rename (no temporary
    file is left, and the new file is a new inode)."""
    published = []
    replace = runner.os.replace

    def recorded(src, dst):
        published.append((os.path.basename(src), os.path.basename(dst)))
        return replace(src, dst)

    def prepare(ckpt):
        (ckpt / "pairing_chunk_000001.npz").unlink()
        prepare.kept = os.stat(ckpt / "pairing_chunk_000000.npz")

    runner.os.replace = recorded
    try:
        ckpt, calls = _rerun(streamed, tmp_path, prepare)
    finally:
        runner.os.replace = replace
    assert calls == [(1,)]
    assert published == [(f"pairing_chunk_000001.npz.{os.getpid()}.tmp",
                          "pairing_chunk_000001.npz")]
    assert sorted(os.listdir(ckpt)) == ["pairing_chunk_000000.npz", "pairing_chunk_000001.npz"]
    now = os.stat(ckpt / "pairing_chunk_000000.npz")
    assert (now.st_ino, now.st_mtime_ns) == (prepare.kept.st_ino, prepare.kept.st_mtime_ns)
