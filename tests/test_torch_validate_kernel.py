"""``k_validate``'s host side and a model of its formulas, on the CPU.

The kernel (``csrc/validate.cu``) runs only on the card; its card cases are
in ``tests/test_torch_cuda.py`` (``-k validate_kernel``). Here:

  * ``constants``: ``VAL_CONST`` as written in the source against
    ``utils/bn254.py``'s 3, TWIST_B, TWIST_C2 and TWIST_C3 in the Montgomery
    domain, and ``VAL_OPERANDS`` against the wrappers' operand counts;
  * ``model``: each mode's formulas as the source writes them (the operands
    reduced mod p, Montgomery products, the constant rows each twist map
    names, the comparisons mod p) on Python integers, against the plain
    versions lane for lane on ``validate_edges``' lanes;
  * ``table``: the operand tables of the three modes read the public rows,
    row slices of a pool and ``expand``ed constants (as the Groth16
    benchmark passes them) and the end state's kernel layout in place, with
    steps from each bound, and refuse a bound above p 2^20;
  * ``cpu_route``: CPU tensors take the plain versions and launch nothing.
"""

import re

import pytest
import torch
from validate_edges import validate_case

import pairing_tpu_torch as pt
from pairing_tpu_torch.curves import g1 as TG1
from pairing_tpu_torch.curves import g2 as TG2
from pairing_tpu_torch.fields import fp as F
from pairing_tpu_torch.fields.fp import Fp
from pairing_tpu_torch.ops import build, dispatch
from pairing_tpu_torch.ops import curve_kernels as CK
from pairing_tpu_torch.ops.canon_kernels import operand_table
from pairing_tpu_torch.utils import bn254 as c

torch.set_num_threads(2)

P = c.P
RINV = pow(F.R_MONT, -1, P)
SOURCE = build.CSRC / "validate.cu"
ROW_NAMES = ("VC_THREE", "VC_B0", "VC_B1", "VC_C2_0", "VC_C2_1", "VC_C2_0N", "VC_C3_0",
             "VC_C3_1", "VC_C3_0N")
LANES = 48


def _mont(v: int) -> int:
    return v % P * F.R_MONT % P


def source_table():
    """VAL_CONST's rows as integers by name, and the rows (c0, c1, p - c0) of
    the two twist maps of the compare mode, psi(Q).x's first."""
    src = SOURCE.read_text()
    body = re.search(r"VAL_CONST\[9\]\[NL\] = \{(.*?)\n\};", src, re.S).group(1)
    rows = [[int(d) for d in r.split(",") if d.strip()] for r in re.findall(r"\{([^}]*)\}", body)]
    assert len(rows) == 9 and all(len(r) == F.NLIMBS for r in rows)
    assert all(0 <= d < F.RADIX for r in rows for d in r)
    enum = re.search(r"enum \{ (VC_THREE = 0[^}]*)\};", src).group(1)
    assert tuple(n.strip().split(" ")[0] for n in enum.split(",")) == ROW_NAMES
    values = {n: sum(d << (F.RADIX_BITS * i) for i, d in enumerate(r))
              for n, r in zip(ROW_NAMES, rows)}
    maps = re.findall(r"twist_conj<(\w+), (\w+), (\w+)>\(load_canon2\(t\.op(?: \+ (\d))?, lane",
                      src)
    assert [m[3] for m in maps] == ["", "2"]  # psi(Q).x of Q.x (op 0), psi(Q).y of Q.y (op 2)
    return values, [m[:3] for m in maps]


def case_constants():
    values, maps = source_table()
    want = {"VC_THREE": _mont(3), "VC_B0": _mont(c.TWIST_B[0]), "VC_B1": _mont(c.TWIST_B[1]),
            "VC_C2_0": _mont(c.TWIST_C2[0]), "VC_C2_1": _mont(c.TWIST_C2[1]),
            "VC_C2_0N": _mont(-c.TWIST_C2[0]), "VC_C3_0": _mont(c.TWIST_C3[0]),
            "VC_C3_1": _mont(c.TWIST_C3[1]), "VC_C3_0N": _mont(-c.TWIST_C3[0])}
    assert values == want
    assert maps == [("VC_C2_0", "VC_C2_1", "VC_C2_0N"), ("VC_C3_0", "VC_C3_1", "VC_C3_0N")]
    counts = re.search(r"VAL_OPERANDS\[3\] = \{(\d+), (\d+), (\d+)\}", SOURCE.read_text())
    assert tuple(map(int, counts.groups())) == (2, 4, 10)


def _ints(x: Fp):
    return [F.limbs_to_int(r) % P for r in x.limbs.reshape(-1, F.NLIMBS).tolist()]


def _model(values, maps):
    """The kernel's three modes on one lane's operand values (ints)."""
    def mul(a, b):
        return a * b * RINV % P

    def fp2_mul(a, b):
        return ((mul(a[0], b[0]) + mul(a[1], P - b[1])) % P,
                (mul(a[0], b[1]) + mul(a[1], b[0])) % P)

    def twist(v, rows):
        c0, c1, c0n = (values[n] for n in rows)
        return ((mul(v[0], c0) + mul(v[1], c1)) % P, (mul(v[0], c1) + mul(v[1], c0n)) % P)

    def g1(x, y):
        return mul(y, y) == (mul(mul(x, x), x) + values["VC_THREE"]) % P

    def g2(x, y):
        x3 = fp2_mul(fp2_mul(x, x), x)
        return fp2_mul(y, y) == ((x3[0] + values["VC_B0"]) % P, (x3[1] + values["VC_B1"]) % P)

    def compare(x, y, X, Y, Z):
        zz = fp2_mul(Z, Z)
        return (Z != (0, 0) and X == fp2_mul(twist(x, maps[0]), zz)
                and Y == fp2_mul(twist(y, maps[1]), fp2_mul(zz, Z)))

    return g1, g2, compare


def case_model():
    values, maps = source_table()
    g1, g2, compare = _model(values, maps)
    p, q, end, kinds = validate_case(LANES, "cpu")
    px, py = _ints(p.x), _ints(p.y)
    qc = [_ints(x) for x in (q.x.c0, q.x.c1, q.y.c0, q.y.c1)]
    acc = CK.jac_view(end)
    ec = [_ints(x) for x in (acc.X.c0, acc.X.c1, acc.Y.c0, acc.Y.c1, acc.Z.c0, acc.Z.c1)]
    got = {"g1": [], "g2": [], "compare": []}
    for i in range(LANES):
        x, y = (qc[0][i], qc[1][i]), (qc[2][i], qc[3][i])
        got["g1"].append(g1(px[i], py[i]))
        got["g2"].append(g2(x, y))
        got["compare"].append(compare(x, y, *((ec[k][i], ec[k + 1][i]) for k in (0, 2, 4))))
    assert got["g1"] == TG1.g1_on_curve_plain(p).tolist()
    assert got["g2"] == TG2.g2_on_curve_plain(q).tolist()
    assert got["compare"] == CK.g2_subgroup_compare_plain(q, end).tolist()
    assert got["g1"] == [k not in ("p_5_5", "p_0_0") for k in kinds]
    assert got["g2"] == [k != "off_twist" for k in kinds]
    assert got["compare"] == [k not in ("outside_g2", "z_zero") for k in kinds]


def case_table():
    p, q, end, _ = validate_case(2 * LANES, "cpu")
    n = LANES
    sl = [Fp(x.limbs[n:2 * n], x.bound, x.limb_bound) for x in (p.x, p.y)]  # row slices
    table, keep = operand_table(sl, (n,))
    assert keep == [] and table.tolist() == [
        p.x.limbs[n].data_ptr(), F.NLIMBS, 1, 2, p.y.limbs[n].data_ptr(), F.NLIMBS, 1, 2]
    wide = [Fp(x.limbs[:1].expand(n, F.NLIMBS), P, F.MASK) for x in (q.x.c0, q.x.c1)]
    acc = CK.jac_view(end[..., :n].contiguous())
    state = [acc.X.c0, acc.X.c1, acc.Y.c0, acc.Y.c1, acc.Z.c0, acc.Z.c1]
    table, keep = operand_table(wide + wide + state, (n,))
    rows = table.view(10, 4).tolist()
    assert keep == [] and [r[1:] for r in rows[:4]] == [[0, 1, 1]] * 4
    assert [r[1:] for r in rows[4:]] == [[1, n, 1]] * 6
    assert rows[9][0] == acc.Z.c1.limbs.data_ptr()
    with pytest.raises(ValueError):
        operand_table([Fp(p.x.limbs, (P << 20) + 1, F.MASK), p.y], (2 * n,))


def case_cpu_route():
    p, q, end, kinds = validate_case(LANES, "cpu")
    dispatch.reset_launch_counts()
    assert torch.equal(pt.g1_on_curve(p), TG1.g1_on_curve_plain(p))
    assert torch.equal(pt.g2_on_curve(q), TG2.g2_on_curve_plain(q))
    assert torch.equal(CK.g2_subgroup_compare(q, end), CK.g2_subgroup_compare_plain(q, end))
    assert pt.validate_inputs(p, q, subgroup_check=False).tolist() == [
        k not in ("p_5_5", "p_0_0", "off_twist") for k in kinds]
    assert set(dispatch.launch_counts().values()) == {0}


CASES = {"constants": case_constants, "model": case_model, "table": case_table,
         "cpu_route": case_cpu_route}


@pytest.mark.parametrize("case", list(CASES))
def test_validate_kernel_host_side_and_model(case):
    CASES[case]()
