"""Kernels K18 (``csrc/fq12_sq.cu``) and K15 (``csrc/hard_chain.cu``):
their arithmetic and schedule modelled in numpy and held against the plain
versions, the reference's fixture and the oracle.

* K18: the term table ``SQ_TERMS`` / ``SQ_SLOTS``, read from the source,
  covers each of the 21 unordered slot pairs i <= j once, in slot
  i + j mod 6, with ``B_FOLD`` exactly when i + j >= 6 and ``B_DBL`` exactly
  when i != j. One thread per output component sums its slot's terms into
  32-bit columns (kernel B's term model, ``test_torch_cyc_kernels``), a fold
  between terms, one reduction: the model must give ``fq12_sq_plain`` on
  random operands outside the cyclotomic subgroup and on the envelope's
  edges, the reference's square in ``tests/data/torch_final_exp_fixture.npz``
  and the oracle's; every column stays below 2^32, also at all-maximal
  digits.
* K15: ``HARD_CHAIN_PROG`` run component by component, every operation's 12
  components computed from the state before it and stored after (the
  kernel's barriers), its products by kernel A's thread model, its squares
  by B's and its slot maps by E's (``test_torch_slot_kernels``), must give
  ``hard_chain_plain``; so must a program that writes the registers it
  reads. The program checks of the C entry, mirrored by
  ``fused_kernels.check_chain_program``, refuse what the kernel cannot run.

Nothing here compiles a JAX graph.
"""

import re

import numpy as np
import pytest
import torch

from pairing_tpu_torch.fields import fp12 as TF12
from pairing_tpu_torch.ops import fq12_kernels as FK
from pairing_tpu_torch.ops import fused_kernels as FU
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.pairing.final_exp import easy_part_k
from pairing_tpu_torch.utils import bn254 as c
from test_torch_cyc_kernels import (as_kf12, b_tables, flagged, kernel_rows, model_cyc_sq,
                                    model_terms, settled_operand)
from test_torch_inv_kernels import (CSRC, NL, exact_mont, model_neg, value, w32_fold, w32_mac,
                                    w32_reduce)
from test_torch_slot_kernels import model_slotwise

torch.set_num_threads(2)

FIXTURE = CSRC.parents[1] / "tests" / "data" / "torch_final_exp_fixture.npz"


def sq_tables():
    return b_tables("fq12_sq.cu", "SQ_TERMS", "SQ_SLOTS")


def canon(a: torch.Tensor) -> torch.Tensor:
    assert FK.kf12_in_envelope(a)
    return FK.kf12_canonical(a)


def ints(a: torch.Tensor) -> list:
    return TF12.fq12_to_int_coeffs(FK.from_kernel_layout(a, (a.shape[-1],)))


# ---------------------------------------------------------------------------
# K18
# ---------------------------------------------------------------------------


def model_sq(rows, worst: bool = False) -> list:
    """Kernel K18 on carried digits rows[12] of [B, NL]: the 12 output digit
    arrays, each one exact Montgomery reduction of its thread's sum."""
    out = []
    for r, total in model_terms(rows, sq_tables(), worst):
        if not worst:
            assert value(r) == [exact_mont(t) for t in total]
            assert all(v < 2 * c.P for v in value(r))
        out.append(r)
    return out


def test_sq_table_covers_each_slot_pair_once():
    terms, slots, names = sq_tables()
    fold, dbl, sq = names["B_FOLD"], names["B_DBL"], names["B_SQ"]
    assert sorted((i, j) for i, j, _ in terms) == [(i, j) for i in range(6)
                                                   for j in range(i, 6)]
    assert sum(count for _, count in slots) == len(terms) == 21
    for s, (first, count) in enumerate(slots):
        assert first == sum(n for _, n in slots[:s])
        for i, j, flags in terms[first:first + count]:
            assert (i + j) % 6 == s
            assert bool(flags & fold) == (i + j >= 6)
            assert bool(flags & dbl) == (i != j)
            assert bool(flags & sq) == (i == j and i + j < 6)


@pytest.mark.parametrize("inputs", ["random", "settled"])
def test_sq_thread_model_matches_plain_and_oracle(inputs):
    """Random operands (not in the cyclotomic subgroup), and the envelope's
    edges: one lane of 2p - 1 in every component, one of limbs 2^13 and
    2^13 + 1."""
    rng = np.random.default_rng({"random": 1501, "settled": 1502}[inputs])
    if inputs == "random":
        a = FK.random_kf12((12,), 4, torch.Generator().manual_seed(1503))
    else:
        a = settled_operand(rng, 3)
    got = as_kf12(model_sq(kernel_rows(a)))
    assert torch.equal(canon(got), canon(FK.fq12_sq_plain(a)))
    assert ints(got) == [o.pow_fq12(x, 2) for x in ints(a)]


def test_sq_thread_model_matches_reference_fixture():
    data = np.load(FIXTURE)
    coeffs = TF12.fq12_limbs_to_int_coeffs(data["a"])
    a, _ = FK.to_kernel_layout(TF12.fq12_from_int_coeffs(coeffs, "cpu"))
    got = as_kf12(model_sq(kernel_rows(a)))
    assert FK.kf12_in_envelope(got)
    got = TF12.fq12_to_canonical_limbs(FK.from_kernel_layout(got, (got.shape[-1],)))
    assert got.numpy().tolist() == data["fq12_sq"].tolist()


def test_sq_columns_fit_at_all_maximal_digits():
    rows = [np.zeros((2, NL), np.uint64) for _ in range(12)]
    model_sq(rows, worst=True)  # every column below 2^32, asserted inside


# ---------------------------------------------------------------------------
# K15
# ---------------------------------------------------------------------------


def model_mul(a, b) -> list:
    """Kernel A's threads (a dense product) on carried digits: component
    k = 2s + comp sums a_i b_j over i, with j = s - i mod 6 and xi a_i where
    i > s, a fold between terms, one reduction."""
    names = b_tables()[2]
    out = []
    for k in range(12):
        s, comp = k >> 1, k & 1
        w = np.zeros((a[0].shape[0], 2 * NL), np.uint64)
        for i in range(6):
            if i:
                w32_fold(w)
            j = (s - i) % 6
            x0, x1 = flagged(a[2 * i], a[2 * i + 1], names["B_FOLD"] if i > s else 0, names)
            w32_mac(w, x0, b[2 * j + comp])
            w32_mac(w, x1, model_neg(b[2 * j + 1]) if comp == 0 else b[2 * j])
        r = w32_reduce(w)
        assert all(v < 2 * c.P for v in value(r))
        out.append(r)
    return out


def model_chain(xs, prog, out_reg: int) -> torch.Tensor:
    """The program on the kernel's schedule: registers 0-3 the carried
    inputs, 4-7 zero; each operation's components all computed from the
    state before it, then stored."""
    regs = [kernel_rows(x) for x in xs] + [[np.zeros_like(kernel_rows(xs[0])[0])] * 12] * 4
    for op, dst, a, b in prog:
        if op == FU.OPC_MUL:
            new = model_mul(regs[a], regs[b])
        elif op == FU.OPC_CYC:
            new = model_cyc_sq(regs[a])[0]
        else:
            new = model_slotwise(regs[a], FU.SLOT_POWERS[op - FU.OPC_CONJ])
        regs[dst] = new
    return as_kf12(regs[out_reg])


#: Every kind of operation writing a register it reads: a dense square as a
#: MUL, a MUL whose destination is its left or its right operand, a
#: cyclotomic square, the conjugate and p^2 in place.
IN_PLACE_PROG = ((FU.OPC_MUL, 3, 3, 3), (FU.OPC_F1, 4, 0, 0), (FU.OPC_MUL, 4, 4, 3),
                 (FU.OPC_CYC, 4, 4, 0), (FU.OPC_F2, 4, 4, 0), (FU.OPC_MUL, 5, 1, 4),
                 (FU.OPC_MUL, 5, 2, 5), (FU.OPC_CONJ, 6, 5, 0), (FU.OPC_CONJ, 6, 6, 0),
                 (FU.OPC_F3, 7, 6, 0), (FU.OPC_MUL, 7, 6, 7))


@pytest.mark.parametrize("program", ["hard_chain", "in_place"])
def test_chain_schedule_model_matches_plain(program):
    rng = np.random.default_rng({"hard_chain": 1511, "in_place": 1512}[program])
    xs = [easy_part_k(settled_operand(rng, 3)) for _ in range(4)]
    prog, out_reg = ((FU.HARD_CHAIN_PROG, FU.HARD_CHAIN_OUT) if program == "hard_chain"
                     else (IN_PLACE_PROG, 7))
    FU.check_chain_program(prog, out_reg)
    got = model_chain(xs, prog, out_reg)
    assert torch.equal(canon(got), canon(FU.hard_chain_plain(*xs, prog=prog, out_reg=out_reg)))


def test_chain_program_checks_mirror_the_c_entry():
    src = (CSRC / "hard_chain.cu").read_text()
    assert int(re.search(r"HC_INPUTS = (\d+);", src).group(1)) == FU.CHAIN_INPUT_REGS
    assert int(re.search(r"HC_MAX_OPS = (\d+);", src).group(1)) == FU.CHAIN_MAX_OPS
    assert int(re.search(r"HC_REGS = (\d+);", src).group(1)) == FU.HARD_CHAIN_NREG
    FU.check_chain_program(FU.HARD_CHAIN_PROG)
    FU.check_chain_program(IN_PLACE_PROG, 7)
    for prog, out_reg in (
            (((FU.OPC_MUL, 2, 3, 4),), 5),   # writes an input register
            (((FU.OPC_CYC, 4, 1, 0),), 5),   # squares an input register
            (((6, 4, 3, 0),), 5),            # no such opcode
            (((FU.OPC_MUL, 8, 3, 3),), 5),   # no such register
            (((FU.OPC_MUL, 3, 3, 3),) * (FU.CHAIN_MAX_OPS + 1), 5),
            (FU.HARD_CHAIN_PROG, 8)):
        with pytest.raises(ValueError):
            FU.check_chain_program(prog, out_reg)
