"""The port's K-pair products: ``multi_miller_loop`` and ``multi_pairing``.

The JAX side comes from ``tests/data/torch_multi_fixture.npz``, written by
``tests/data/make_torch_multi_fixtures.py`` (the JAX package's jitted XLA
path at K = 2 and K = 4 pairs per product, inner batch 2; checked in, so no
JAX graph is compiled here). On CPU tensors every kernel takes its plain
version. Comparison is exact, on canonical limbs, and also against the
port's pure-integer oracle; a ragged inner batch of 3 is held against the
oracle alone.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import pairing_tpu_torch as pt
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields.fp12 import fq12_to_canonical_limbs
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.utils.interop import reshape_points

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def fixture():
    spec = importlib.util.spec_from_file_location(
        "make_torch_multi_fixtures", DATA / "make_torch_multi_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    data = np.load(DATA / "torch_multi_fixture.npz")
    g1s, g2s = mod.pairs()
    # the fixture was made from these very points
    assert [[TF.limbs_to_int(v) for v in row] for row in data["g1"]] == [list(p) for p in g1s]
    assert [[TF.limbs_to_int(v) for v in row] for row in data["g2"]] == [
        [x[0], x[1], y[0], y[1]] for x, y in g2s]
    return data, g1s, g2s


def kb_points(g1s, g2s, K, B):
    """The first K * B pairs as [K, B] batches (pair k of product b is k * B + b)."""
    n = K * B
    return (reshape_points(pt.g1_from_ints(g1s[:n], "cpu"), (K, B)),
            reshape_points(pt.g2_from_ints(g2s[:n], "cpu"), (K, B)))


def oracle_miller(g1s, g2s, K, B):
    return [o.multi_miller_loop([(g1s[k * B + b], g2s[k * B + b]) for k in range(K)])
            for b in range(B)]


@pytest.mark.parametrize("K", [2, 4])
def test_multi_miller_loop_matches_jax_and_oracle(fixture, K):
    data, g1s, g2s = fixture
    p, q = kb_points(g1s, g2s, K, 2)
    f = pt.multi_miller_loop(q, p)
    assert f.batch_shape == (2,)
    assert fq12_to_canonical_limbs(f).numpy().tolist() == data[f"miller_k{K}"].tolist()
    assert pt.fq12_to_int_coeffs(f) == oracle_miller(g1s, g2s, K, 2)


@pytest.mark.parametrize("K", [2, 4])
def test_multi_pairing_matches_jax_and_oracle(fixture, K):
    data, g1s, g2s = fixture
    p, q = kb_points(g1s, g2s, K, 2)
    e = pt.multi_pairing(p, q)
    assert fq12_to_canonical_limbs(e).numpy().tolist() == data[f"pairing_k{K}"].tolist()
    assert pt.fq12_to_int_coeffs(e) == [o.final_exp(m) for m in oracle_miller(g1s, g2s, K, 2)]


def test_multi_pairing_ragged_batch_matches_oracle(fixture):
    _, g1s, g2s = fixture
    K, B = 2, 3
    p, q = kb_points(g1s, g2s, K, B)
    e = pt.multi_pairing(p, q)
    assert e.batch_shape == (B,)
    assert pt.fq12_to_int_coeffs(e) == [o.final_exp(m) for m in oracle_miller(g1s, g2s, K, B)]


def test_multi_pairing_rejects_mismatched_points(fixture):
    _, g1s, g2s = fixture
    p, q = kb_points(g1s, g2s, 2, 2)
    with pytest.raises(ValueError):
        pt.multi_pairing(reshape_points(p, (4, 1)), q)
