"""The input generator: points along its progressions, the Groth16 proofs'
accept bits against the frozen oracle, seeds and sizes."""

import pytest

from bench_gpu import generate as G
from bench_gpu import harness
from bench_gpu.generators import groth16_proofs, pairs
from bench_gpu.reference import groth16 as R
from bench_gpu.reference import oracle as o

SEED = 2**40 + 12345  # more than 32 bits, as the benchmark's seeds are


def test_progressions_are_scalar_multiples():
    assert G.g1_progression(5, 7, 6) == [o.g1_mul(G.G1_GEN, 5 + 7 * i) for i in range(6)]
    assert G.g2_progression(5, 7, 4) == [o.g2_mul(G.G2_GEN, 5 + 7 * i) for i in range(4)]


def test_walk_adds_every_step():
    steps = [o.g1_mul(G.G1_GEN, k) for k in (3, 11, 2)]
    got = G.walk_g1(o.g1_mul(G.G1_GEN, 4), steps)
    assert got == [o.g1_mul(G.G1_GEN, k) for k in (4, 7, 18, 20)]


@pytest.fixture(scope="module")
def pool():
    return groth16_proofs.make(SEED, pool=16, bad_c_every=4, bad_b_every=8)


def test_pool_sizes_and_bad_proofs(pool):
    assert len(pool.a) == len(pool.b) == len(pool.c) == len(pool.vk_x) == 16
    assert len(pool.bad_c) == 4 and len(pool.bad_b) == 2
    assert not set(pool.bad_c) & set(pool.bad_b) and set(pool.moves) == set(pool.bad_c)
    again = groth16_proofs.make(SEED, pool=16, bad_c_every=4, bad_b_every=8)
    assert again.a == pool.a and again.b == pool.b and again.bad_b == pool.bad_b
    other = groth16_proofs.make(SEED + 1, pool=16, bad_c_every=4, bad_b_every=8)
    assert other.a != pool.a and len(other.bad_c) == 4 and len(other.bad_b) == 2


def test_accept_bits_match_the_oracle(pool):
    """A sound proof, a proof with C moved and a proof with B outside G2:
    the bits the reference derives from the scalars are the oracle's."""
    ref = R.expected(pool)
    sound = next(i for i in range(16) if i not in pool.bad_c and i not in pool.bad_b)
    for i in (sound, pool.bad_c[0], pool.bad_b[0]):
        in_g2 = o.g2_in_subgroup(pool.b[i])
        value = R.product(pool, i)
        assert ref["valid"][i] == in_g2
        assert ref["accept"][i] == (in_g2 and value == o.fq12_one())
        if ref["moved"][i]:
            assert value == o.pow_fq12(o.pairing(G.G1_GEN, pool.delta), pool.moves[i])
    assert sum(ref["accept"]) == 16 - 4 - 2


def test_pairs_are_distinct():
    ps, qs = pairs.make(SEED, pool=8, g2_pool=4)
    assert len(set(ps)) == 8 and len(set(qs)) == 4 and len(set(zip(ps, qs))) == 8
    assert qs[:4] == qs[4:]


def test_sample_is_seeded():
    a = G.sample(SEED, range(100), 5, salt=1)
    assert a == G.sample(SEED, range(100), 5, salt=1) and len(set(a)) == 5
    assert a != G.sample(SEED, range(100), 5, salt=2)


def test_a_mix_finds_its_kind_by_name():
    traffic = {"generator": "pairs", "why": "two pairs", "pool": 2, "g2_pool": 1}
    assert harness.make_inputs(traffic, SEED) == pairs.make(SEED, pool=2, g2_pool=1)
