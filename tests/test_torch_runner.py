"""The port's streaming runner (``parallel.runner.pairing_stream``) and its
config (``utils.config.PairingConfig``) on the CPU, as
tests/test_parallel.py holds the JAX package's: 3 pairs in chunks of 2 (a
full chunk and a ragged tail of 1, not padded), checkpointed, resumed from
the checkpoints, and refused against changed inputs. Two plain pairing
calls at batch 2 and 1, about 25 s on two threads.
"""

import dataclasses
import os

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
