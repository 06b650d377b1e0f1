"""``k_canonical``'s host side and a numpy model of its reduction, on the CPU.

The kernel (``csrc/canonical.cu``) runs only on the card; its card cases are
in ``tests/test_torch_cuda.py`` (``-k canonical``). Here:

  * ``steps``: the long-division steps the wrapper derives from a bound;
  * ``strides``, ``table``: the operand table for contiguous, expanded,
    transposed, sliced and broadcast operands (in place where the batch
    axes fold into one stride, a contiguous copy otherwise);
  * ``model_digits``, ``model_compare``: the kernel's per-thread arithmetic
    in numpy (the signed carry into five 64-bit words, the long division by
    the source's own table of p 2^j) against ``canonical_plain``, the
    compare mode's plain version and the oracle, on ``edge_operands``
    (``tests/canon_edges.py``);
  * ``cpu_route``: the field library's compares on CPU tensors take the
    plain versions and launch nothing.
"""

import re

import numpy as np
import pytest
import torch
from canon_edges import EDGE_VALUES, edge_operands

from pairing_tpu_torch.fields import fp as F
from pairing_tpu_torch.fields import fp2 as F2
from pairing_tpu_torch.fields import fp12 as F12
from pairing_tpu_torch.fields.fp import Fp
from pairing_tpu_torch.ops import build, dispatch
from pairing_tpu_torch.ops import canon_kernels as CK
from pairing_tpu_torch.ops.fq12_kernels import kfp_view, random_kf12
from pairing_tpu_torch.utils.bn254 import P

torch.set_num_threads(2)

LANES = 48
WORDS = 5


def p_shift_table() -> np.ndarray:
    """``P_SHIFT`` as written in ``csrc/canon.cuh``: uint64 [20, 5]."""
    text = (build.CSRC / "canon.cuh").read_text()
    body = text.split("P_SHIFT[CANON_MAX_STEPS][CANON_WORDS] = {", 1)[1].split("};", 1)[0]
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{16})ull", body)]
    return np.array(words, dtype=np.uint64).reshape(CK.MAX_STEPS, WORDS)


def model_load(limbs: np.ndarray) -> np.ndarray:
    """``canon_load`` on rows int32 [n, 21]: uint64 words [n, 5]."""
    x = limbs.astype(np.int64)
    w = np.zeros((len(x), WORDS), np.uint64)
    carry = np.zeros(len(x), np.int64)
    for limb in range(F.NLIMBS):
        t = x[:, limb] + carry
        d = (t & F.MASK).astype(np.uint64)
        carry = t >> F.RADIX_BITS
        k, s = divmod(F.RADIX_BITS * limb, 64)
        w[:, k] |= d << np.uint64(s)
        if s + F.RADIX_BITS > 64:
            w[:, k + 1] |= d >> np.uint64(64 - s)
    w[:, WORDS - 1] |= carry.astype(np.uint64) << np.uint64(F.RADIX_BITS * F.NLIMBS - 256)
    return w


def model_reduce(w: np.ndarray, steps: int, table: np.ndarray) -> np.ndarray:
    """``canon_reduce``: for j = steps - 1 down to 0, subtract p 2^j where it
    fits, word by word with a borrow."""
    for j in range(steps - 1, -1, -1):
        d, borrow = np.empty_like(w), np.zeros(len(w), np.uint64)
        for k in range(WORDS):
            c = table[j, k]
            t = w[:, k] - c
            under = (w[:, k] < c).astype(np.uint64)
            d[:, k] = t - borrow
            borrow = under | (t < borrow).astype(np.uint64)
        w = np.where(borrow[:, None] != 0, w, d)
    return w


def model_digits(w: np.ndarray) -> np.ndarray:
    """The digits mode's store: words [n, 5] -> digits int32 [n, 21]."""
    out = np.zeros((len(w), F.NLIMBS), np.int32)
    for limb in range(F.NLIMBS):
        k, s = divmod(F.RADIX_BITS * limb, 64)
        v = w[:, k] >> np.uint64(s)
        if s + F.RADIX_BITS > 64:
            v |= w[:, k + 1] << np.uint64(64 - s)
        out[:, limb] = (v & np.uint64(F.MASK)).astype(np.int32)
    return out


def model_value(a: Fp, table: np.ndarray) -> np.ndarray:
    """One operand through the model: the reduced words [lanes, 5]."""
    rows = a.limbs.reshape(-1, F.NLIMBS).numpy()
    return model_reduce(model_load(rows), CK.subtraction_steps(a.bound), table)


def edges():
    g = torch.Generator()
    g.manual_seed(2023)
    return edge_operands(LANES, g), g


def partner(a: Fp, g: torch.Generator) -> Fp:
    """The value of ``a`` in another representation on even lanes, a + 1 on
    odd ones."""
    c = Fp(random_kf12((), LANES, g).t().contiguous(), 2 * P, F.SETTLED)
    same = F.fp_sub(F.fp_add(a, c), c)
    other = F.fp_add(a, F.fp_const_mont(1, (LANES,), "cpu"))
    return F.fp_select(torch.arange(LANES) % 2 == 0, same, other)


def case_steps():
    assert [CK.subtraction_steps(b) for b in (1, P, 2 * P)] == [1, 1, 1]
    assert [CK.subtraction_steps(b) for b in (2 * P + 1, 4 * P, 4 * P + 1)] == [2, 2, 3]
    assert CK.subtraction_steps(P << 19) == 19
    assert CK.subtraction_steps((P << 19) + 1) == CK.subtraction_steps(F.R_MONT) == 20
    assert CK.subtraction_steps(P << 20) == 20
    with pytest.raises(ValueError):
        CK.subtraction_steps((P << 20) + 1)
    ops, _ = edges()
    got = {name: CK.subtraction_steps(a.bound) for name, a in ops.items()}
    assert got == {"below_2p": 1, "lazy_sum": 3, "wide_limbs": 17, "most_steps": 20,
                   "difference": 2, "curve_rhs": 2, "signed": 1}


def case_strides():
    rows = torch.zeros((LANES, F.NLIMBS), dtype=F.DTYPE)
    assert CK.operand_strides(rows, (LANES,)) == (F.NLIMBS, 1)
    assert CK.operand_strides(rows.view(6, 8, F.NLIMBS), (6, 8)) == (F.NLIMBS, 1)
    const = F.fp_const(5, (LANES,), "cpu").limbs
    assert CK.operand_strides(const, (LANES,)) == (0, 1)
    assert CK.operand_strides(F.fp_const(5, (), "cpu").limbs, (6, 8)) == (0, 1)
    assert CK.operand_strides(F.fp_const(5, (6, 8), "cpu").limbs, (6, 8)) == (0, 1)
    view = kfp_view(torch.zeros((2, F.NLIMBS, LANES), dtype=F.DTYPE)[1]).limbs
    assert CK.operand_strides(view, (LANES,)) == (1, LANES)
    wide = torch.zeros((LANES, F.NLIMBS + 1), dtype=F.DTYPE)[:, :F.NLIMBS]
    assert CK.operand_strides(wide, (LANES,)) == (F.NLIMBS + 1, 1)
    assert CK.operand_strides(rows[:1], (1,)) == (F.NLIMBS, 1)
    assert CK.operand_strides(rows[:6].unsqueeze(1), (6, 8)) is None  # broadcast over lanes
    assert CK.operand_strides(rows[:8].unsqueeze(0), (6, 8)) is None  # broadcast over rows
    assert CK.operand_strides(rows.view(6, 8, F.NLIMBS)[:, ::2], (6, 4)) == (2 * F.NLIMBS, 1)
    assert CK.operand_strides(rows.view(6, 8, F.NLIMBS)[:, :4], (6, 4)) is None


def case_table():
    ops, g = edges()
    a, b = ops["below_2p"], ops["difference"]
    const = F.fp_const(3, (LANES,), "cpu")
    table, keep = CK.operand_table([a, b, const, None, ops["wide_limbs"], const], (LANES,))
    assert keep == []  # everything read in place
    assert table.dtype == torch.int64 and table.tolist() == [
        a.limbs.data_ptr(), F.NLIMBS, 1, 1, b.limbs.data_ptr(), F.NLIMBS + 1, 1, 2,
        const.limbs.data_ptr(), 0, 1, 1, 0, 0, 0, 0,
        ops["wide_limbs"].limbs.data_ptr(), F.NLIMBS, 1, 17, const.limbs.data_ptr(), 0, 1, 1]
    row = Fp(a.limbs[:8].unsqueeze(0), a.bound, a.limb_bound)  # [1, 8] against [6, 8]
    col = Fp(a.limbs[:6].unsqueeze(1), a.bound, a.limb_bound)
    table, keep = CK.operand_table([row, col], (6, 8))
    assert len(keep) == 2 and [k.shape for k in keep] == [(6, 8, F.NLIMBS)] * 2
    assert table.tolist() == [keep[0].data_ptr(), F.NLIMBS, 1, 1,
                              keep[1].data_ptr(), F.NLIMBS, 1, 1]
    assert torch.equal(keep[0][3], a.limbs[:8]) and torch.equal(keep[1][:, 5], a.limbs[:6])
    with pytest.raises(TypeError):
        CK.operand_table([Fp(a.limbs.long()), None], (LANES,))


def case_model_digits():
    table = p_shift_table()
    assert [sum(int(w) << (64 * k) for k, w in enumerate(row)) for row in table] == [
        P << j for j in range(CK.MAX_STEPS)]
    ops, _ = edges()
    for name, a in ops.items():
        got = model_digits(model_value(a, table))
        want = F.canonical_plain(a).limbs.numpy()
        assert np.array_equal(got, want), name
        values = [F.limbs_to_int(r) % P for r in a.limbs.numpy()]
        assert [F.limbs_to_int(r) for r in got] == values, name
    assert [F.limbs_to_int(r) for r in model_digits(model_value(ops["below_2p"], table))][
        :len(EDGE_VALUES)] == [v % P for v in EDGE_VALUES]


def case_model_compare():
    table = p_shift_table()
    ops, g = edges()
    for name, a in ops.items():
        b = partner(a, g)
        got = (model_value(a, table) == model_value(b, table)).all(axis=1)
        want = CK.all_equal_plain([(a, b)]).numpy()
        assert np.array_equal(got, want) and want[0::2].all() and not want[1::2].any(), name
        zero = (model_value(a, table) == 0).all(axis=1)
        assert np.array_equal(zero, CK.all_equal_plain([(a, None)]).numpy()), name
    assert np.flatnonzero(zero).tolist() == [0, 4]  # "signed" leads with 0, 1, p - 2, p - 1, p


def case_cpu_route():
    ops, g = edges()
    a = ops["lazy_sum"]
    b = partner(a, g)
    dispatch.reset_launch_counts()
    want = CK.all_equal_plain([(a, b)])
    assert torch.equal(F.fp_eq(a, b), want)
    assert torch.equal(F.fp_is_zero(a), CK.all_equal_plain([(a, None)]))
    assert torch.equal(F.canonical(a).limbs, F.canonical_plain(a).limbs)
    x, y = F2.Fp2(a, ops["curve_rhs"]), F2.Fp2(b, ops["curve_rhs"])
    assert torch.equal(F2.eq(x, y), want)
    one = F12.fq12_one((LANES,), "cpu")
    f = F12.Fq12((x,) + one.s[1:])
    assert torch.equal(F12.fq12_eq(f, F12.Fq12((y,) + one.s[1:])), want)
    assert not F12.fq12_eq(f, one).any()
    assert set(dispatch.launch_counts().values()) == {0}


CASES = {"steps": case_steps, "strides": case_strides, "table": case_table,
         "model_digits": case_model_digits, "model_compare": case_model_compare,
         "cpu_route": case_cpu_route}


@pytest.mark.parametrize("case", list(CASES))
def test_canonical_kernel_host_side_and_model(case):
    CASES[case]()
