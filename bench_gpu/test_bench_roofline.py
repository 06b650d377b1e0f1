"""The roofline counts: each kernel's field-level work equals the count of
``chip_smoke.py``'s model for the same schedule (at its 13-bit costs), the
32-bit word costs are as documented, and the bytes match the shapes the
port's wrappers allocate."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from bench_gpu import roofline as RL
from bench_gpu.roofline import exp_bits, miller_f_collect, miller_f_multi, pow_ladder_stream

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_word_costs():
    assert (RL.WORD32.product, RL.WORD32.square, RL.WORD32.reduction) == (128, 72, 136)
    assert RL.WORD32.product + RL.WORD32.reduction == 264
    assert RL.LIMB13.product + RL.LIMB13.reduction == 903
    assert RL.IMADS_PER_S == pytest.approx(16.73e12, rel=1e-3)


def test_tower_counts_are_chip_smokes(smoke):
    for ours, theirs in ((RL.FQ12_DENSE, smoke.FQ12_DENSE), (RL.FQ12_SQ, smoke.FQ12_SQ),
                         (RL.FQ12_SPARSE, smoke.FQ12_SPARSE), (RL.CYC_SQ, smoke.CYC_SQ)):
        assert ours.issues(RL.LIMB13) == theirs


@pytest.mark.parametrize("lanes", [1, 2048, 16384])
def test_kernel_counts_are_chip_smokes(smoke, lanes):
    from pairing_tpu_torch.ops import fused_kernels as FU
    from pairing_tpu_torch.pairing import miller_loop as ML

    n_loop, n_lines = ML.N_STEPS, ML.N_STEPS + ML.N_ADDS + 2
    for pairs in (1, 4):
        want = lanes * (n_loop * smoke.FQ12_SQ + pairs * n_lines * smoke.FQ12_SPARSE)
        assert miller_f_multi.work(lanes, pairs).issues(RL.LIMB13) == want
    assert miller_f_collect.work(lanes).issues(RL.LIMB13) == \
        lanes * (n_loop * smoke.FQ12_SQ + n_lines * smoke.FQ12_SPARSE)
    digits = FU.BN_X_W4_DIGITS
    assert pow_ladder_stream.work(lanes).issues(RL.LIMB13) == lanes * (
        (len(digits) - 1) * smoke.CYC_SQ + int(np.count_nonzero(digits[1:])) * smoke.FQ12_DENSE)
    bits = FU.BN_X_BITS_MSB
    assert exp_bits.work(lanes).issues(RL.LIMB13) == lanes * (
        len(bits) * smoke.CYC_SQ + int(bits.sum()) * smoke.FQ12_DENSE)
    # re-costed at 32-bit words: the same work, 0.25-0.35 of the issues
    for w in (miller_f_multi.work(lanes, 4), exp_bits.work(lanes)):
        assert 0.25 < w.issues() / w.issues(RL.LIMB13) < 0.35


def test_bytes_match_the_wrappers_shapes():
    import torch

    from pairing_tpu_torch.ops import fused_kernels as FU
    from pairing_tpu_torch.ops.fq12_kernels import random_kf12
    from pairing_tpu_torch.pairing import miller_loop as ML

    torch.set_num_threads(2)
    b, k = 3, 4
    i32 = 4
    lines = (ML.N_STEPS + ML.N_ADDS + 2) * 6 * 21 * k * b * i32
    sched = len(ML.MILLER_FLAGS) * 2 * i32
    assert miller_f_multi.n_bytes(b, k) == lines + sched + 12 * 21 * b * i32
    steps = len(ML.MILLER_FLAGS) * 12 * 21 * b * i32
    assert miller_f_collect.n_bytes(b) == lines // k + sched + 12 * 21 * b * i32 + steps
    bits = FU.BN_X_BITS_MSB
    assert exp_bits.n_bytes(b) == (1 + len(bits)) * 12 * 21 * b * i32 + len(bits) * i32
    m = random_kf12((12,), 1, torch.Generator().manual_seed(1))
    stream, rows = FU.pow_x_table(m)
    assert stream.shape[0] == pow_ladder_stream.TABLE_ROWS
    assert list(FU.BN_X_W4_DIGITS) == pow_ladder_stream.DIGITS
    assert pow_ladder_stream.n_bytes(b) == (stream.shape[0] + 1) * 12 * 21 * b * i32 \
        + len(rows) * 2 * i32


def test_least_seconds_takes_the_larger_bound():
    w = RL.Work(products=1000)
    assert RL.least_seconds(w, 0) == w.issues() / RL.IMADS_PER_S
    assert RL.least_seconds(RL.Work(), 3.35e12) == pytest.approx(1.0)
