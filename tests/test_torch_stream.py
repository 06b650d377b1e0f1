"""The port's streamed witness generation (``witness.stream.witness_stream``)
on the CPU, as tests/test_witness.py holds the JAX package's.

``witness_stream`` runs over the first two pairs of
``tests/data/torch_pairing_fixture.npz`` in chunks of 1: the chunk starts,
each chunk's ``out`` against the fixture's XLA ``pairing`` limbs and the
oracle, and chunk 0's host trace leaf for leaf against a direct
``pairing_witness`` of that lane. Then ``collect`` and ``fn``, an empty
batch and a ragged one. On CPU tensors every kernel takes its plain
version. Three plain witness calls at batch 1, about 40 s on two threads.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import pairing_tpu_torch as pt
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields.fp import Fp
from pairing_tpu_torch.fields.fp12 import fq12_to_canonical_limbs
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.utils.interop import fq12_from_leaves, map_limbs
from pairing_tpu_torch.witness import pairing_witness
from pairing_tpu_torch.witness import stream as S
from pairing_tpu_torch.witness.stream import make_stream_fn, witness_stream

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"
N = 2


@pytest.fixture(scope="module")
def points():
    data = np.load(DATA / "torch_pairing_fixture.npz")
    g1s = [tuple(TF.limbs_to_int(v) for v in row) for row in data["g1"][:N]]
    g2s = [((TF.limbs_to_int(r[0]), TF.limbs_to_int(r[1])),
            (TF.limbs_to_int(r[2]), TF.limbs_to_int(r[3]))) for r in data["g2"][:N]]
    return data, g1s, g2s, pt.g1_from_ints(g1s, "cpu"), pt.g2_from_ints(g2s, "cpu")


def lane(points_, i):
    return map_limbs(points_, lambda limbs: limbs[i:i + 1])


@pytest.fixture(scope="module")
def streamed(points):
    _, _, _, p, q = points
    return list(witness_stream(p, q, 1))


@pytest.fixture(scope="module")
def direct(points):
    _, _, _, p, q = points
    return pairing_witness(lane(p, 0), lane(q, 0))


def test_stream_starts_and_outputs_match_jax_and_oracle(points, streamed):
    data, g1s, g2s, _, _ = points
    assert [start for start, _, _ in streamed] == [0, 1]
    for start, out, _ in streamed:
        assert isinstance(out.s[0].c0, Fp)
        assert isinstance(out.s[0].c0.limbs, np.ndarray)
        leaves = [c.limbs for s in out.s for c in (s.c0, s.c1)]
        canon = fq12_to_canonical_limbs(fq12_from_leaves(leaves, "cpu")).numpy()
        assert canon.tolist() == data["pairing"][start:start + 1].tolist()
        assert pt.fq12_to_int_coeffs(fq12_from_leaves(leaves, "cpu")) == [
            o.pairing(g1s[start], g2s[start])]


def test_stream_trace_matches_direct_witness_leaf_for_leaf(streamed, direct):
    _, out, trace = streamed[0]
    assert not S.tensor_leaves((out, trace))  # every tensor is now a numpy array
    host, want = S.tensor_leaves((out, trace), np.ndarray), S.tensor_leaves(direct)
    assert len(host) == len(want) > 100
    for g, w in zip(host, want):
        assert isinstance(g, np.ndarray)
        assert g.shape == tuple(w.shape) and g.dtype == w.numpy().dtype
        np.testing.assert_array_equal(g, w.numpy())
    # the same structure: dicts, lists, named tuples and dataclasses
    assert set(trace) == set(direct[1]) and set(trace["miller"]) == set(direct[1]["miller"])
    exp_input = direct[1]["final_exp"]["exp_inputs"][0]
    assert type(trace["final_exp"]["exp_inputs"][0]) is type(exp_input)


def test_stream_chunks_do_not_share_memory(streamed):
    a, b = (S.tensor_leaves(ch[1:], np.ndarray) for ch in streamed)
    assert not any(np.shares_memory(x, y) for x in a[:12] for y in b[:12])


def test_copy_out_copies_views_of_one_buffer_once():
    base = torch.arange(2 * 3 * 4, dtype=torch.int32).reshape(2, 3, 4)
    tree = {"a": base[:, 0], "b": [base[:, 2], base[1]], "c": torch.arange(3).expand(2, 3)}
    host = S.copy_out(tree, non_blocking=False)
    for h, t in zip(S.tensor_leaves(host), S.tensor_leaves(tree)):
        assert torch.equal(h, t) and h.stride() == t.stride()
        assert h.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
    # the three views of base share one host copy, which spans only what they use
    ptrs = {h.untyped_storage().data_ptr() for h in S.tensor_leaves(host)[:3]}
    assert len(ptrs) == 1
    assert host["a"].untyped_storage().nbytes() == base.numel() * 4


def test_collect_is_honoured(points, direct, monkeypatch):
    _, _, _, p, q = points
    monkeypatch.setattr(S, "pairing_witness", lambda pc, qc: direct)
    got = list(witness_stream(lane(p, 0), lane(q, 0), 1,
                              collect=lambda out, trace: (out.s[0], trace["miller_out"])))
    assert len(got) == 1
    start, out, trace = got[0]
    assert start == 0
    np.testing.assert_array_equal(out.c0.limbs, direct[0].s[0].c0.limbs.numpy())
    np.testing.assert_array_equal(trace.s[5].c1.limbs,
                                  direct[1]["miller_out"].s[5].c1.limbs.numpy())
    out, trace = make_stream_fn()(lane(p, 0), lane(q, 0))
    assert out is direct[0] and trace is direct[1]


def test_fn_is_honoured_and_collect_ignored(points):
    _, _, _, p, q = points
    seen = []

    def fn(pc, qc):
        seen.append(pc.batch_shape)
        return pc.x.limbs + 1, {"y": qc.y.c1.limbs}

    got = list(witness_stream(p, q, 1, collect=lambda o_, t: 1 / 0, fn=fn))
    assert seen == [(1,), (1,)]
    for start, out, trace in got:
        np.testing.assert_array_equal(out, p.x.limbs[start:start + 1].numpy() + 1)
        np.testing.assert_array_equal(trace["y"], q.y.c1.limbs[start:start + 1].numpy())


def test_empty_batch_yields_nothing(points):
    _, _, _, p, q = points
    empty = (map_limbs(p, lambda limbs: limbs[:0]), map_limbs(q, lambda limbs: limbs[:0]))
    assert list(witness_stream(*empty, 1)) == []


def test_ragged_batch_raises(points):
    _, _, _, p, q = points
    with pytest.raises(ValueError, match="not divisible"):
        next(witness_stream(p, q, 3))
