"""The Miller loop's epilogue kernels (``csrc/miller_epilogue.cu``) on the CPU.

``ops.curve_kernels.epilogue_points`` and ``ops.line_kernels.epilogue_lines``
take their plain versions on CPU tensors. Those must be the Miller loop's
eager epilogue as it was written before the kernels (``twisted_frobenius``,
``neg_twisted_frobenius``, ``jac_mixed_add`` and ``jac_cap``, then the two
chords of ``pairing.lines.line_unequal`` through ``line_kernels.affine``),
limb for limb: q1, nq2, st91 and ep. The lanes hold multiples of the G2
generator, a point of the twist outside G2 and a point off the twist, with
H's real end state; the K = 4 case flattens four pairs a product pair-major
as ``multi_pairing`` does. ``tests/test_torch_pairing.py``,
``test_torch_multi_pairing.py`` and ``test_torch_witness.py`` hold the whole
loop against the JAX package and the oracle.

The kernel's own arithmetic is modelled here on Python integers: the
twist constants it keeps in constant memory (``EP_TWIST``), read from the
source, are TWIST_C2 and TWIST_C3 in the Montgomery domain and their
negatives, and the rows each Frobenius component pairs with its operand's
two components (``twist_part<...>``) give c2 conj(v), c3 conj(v) and
c3 neg_conj(v).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import pairing_tpu_torch as pt
from pairing_tpu_torch.curves.g2 import (G2, jac_cap, jac_mixed_add, neg_twisted_frobenius,
                                         twisted_frobenius)
from pairing_tpu_torch.fields import fp as F
from pairing_tpu_torch.fields import fp2 as F2
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.ops import curve_kernels as CK
from pairing_tpu_torch.ops import fq12_kernels as FK
from pairing_tpu_torch.ops import line_kernels as LK
from pairing_tpu_torch.pairing import lines
from pairing_tpu_torch.pairing import miller_loop as ML
from pairing_tpu_torch.utils import bn254 as c

torch.set_num_threads(2)

SOURCE = Path(ML.__file__).resolve().parents[1] / "csrc" / "miller_epilogue.cu"
G2GEN = (c.G2_GEN_X, c.G2_GEN_Y)


def _non_subgroup_point():
    """A point of the twist outside the r-torsion."""
    return next(pt for pt in (o.g2_point_from_x((x0, 1)) for x0 in range(1, 200))
                if pt is not None and not o.g2_in_subgroup(pt))


def _lanes(case: str):
    """(G1 points, G2 points) of the case's lanes, pair-major for K = 4."""
    rng = np.random.default_rng(2111)
    ks = [int(rng.integers(1, 2**62)) for _ in range(16)]
    if case == "g2_lanes":
        g2s = [o.g2_mul(G2GEN, k) for k in ks[:3]]
        g2s += [_non_subgroup_point(), ((3, 4), (5, 6))]  # outside G2; off the twist
    else:  # K = 4 pairs of 2 products, flattened pair-major (lane k * 2 + b)
        g2s = [o.g2_mul(G2GEN, k) for k in ks[:8]]
    g1s = [o.g1_mul(c.G1_GEN, k) for k in ks[8:8 + len(g2s)]]
    return g1s, g2s


def _eager_epilogue(q, px, py, end, zinv):
    """The Miller loop's epilogue as eager code on the capped affine Q, with
    zinv's rows 0 and 1 the inverse Z of end and end + Q1."""
    q1 = twisted_frobenius(q)
    nq2 = neg_twisted_frobenius(q1)
    st91 = CK.jac_rows(jac_cap(jac_mixed_add(CK.jac_view(end), q1)))

    def line(rows, zi, partner):
        x, y = LK.affine(rows, zi)
        out = lines.line_unequal(x, y, partner.x, partner.y, px, py)
        return FK.kstack([v for w in out for v in (w.c0, w.c1)])

    ep = torch.stack([line(end, zinv[0], q1), line(st91, zinv[1], nq2)])
    return CK.g2_rows(q1), CK.g2_rows(nq2), st91, ep


@pytest.mark.parametrize("case", ["g2_lanes", "k4_pairs"])
def test_epilogue_cpu_route_is_the_eager_code(case):
    g1s, g2s = _lanes(case)
    ps, qs = pt.g1_from_ints(g1s, "cpu"), pt.g2_from_ints(g2s, "cpu")
    q = G2(F2.cap(qs.x), F2.cap(qs.y))
    px, py = F._cap_2p(ps.x), F._cap_2p(ps.y)
    q_rows = FK.kstack([q.x.c0, q.x.c1, q.y.c0, q.y.c1])
    end = CK.trajectory_plain(q_rows, ML.STEP_DIGITS)[2]
    gen = torch.Generator().manual_seed(2112)
    zinv = FK.random_kf12((2, 2), len(g2s), gen)
    want = _eager_epilogue(q, px, py, end, zinv)

    q1, nq2, st91 = CK.epilogue_points(q_rows, end)
    pq = FK.kstack([px, py, q.x.c0, q.x.c1, q.y.c0, q.y.c1])
    ep = LK.epilogue_lines(end, st91, zinv, pq[0:2], q1, nq2)
    for name, got, w in zip(("q1", "nq2", "st91", "ep"), (q1, nq2, st91, ep), want):
        assert torch.equal(got, w), name
    # the witness trace's views of q1 and nq2 carry the eager points' values
    q1_eager = twisted_frobenius(q)
    for rows, point in ((q1, q1_eager), (nq2, neg_twisted_frobenius(q1_eager))):
        view = CK.g2_view(rows)
        assert F2.fp2_to_ints(view.x) == F2.fp2_to_ints(point.x)
        assert F2.fp2_to_ints(view.y) == F2.fp2_to_ints(point.y)


# ---------------------------------------------------------------------------
# The kernel's Frobenius constants and rows, on Python integers
# ---------------------------------------------------------------------------

RINV = pow(F.R_MONT, -1, c.P)
ROW_NAMES = ("TW_C2_0", "TW_C2_1", "TW_C2_0N", "TW_C3_0", "TW_C3_1", "TW_C3_0N", "TW_C3_1N")


def _mont(v: int) -> int:
    return v * F.R_MONT % c.P


def _source_table():
    """EP_TWIST's rows as integers, and each map's row names (A0, B0, A1, B1)."""
    src = SOURCE.read_text()
    body = re.search(r"EP_TWIST\[7\]\[NL\] = \{(.*?)\};", src, re.S).group(1)
    rows = [[int(d) for d in r.split(",") if d.strip()] for r in re.findall(r"\{([^}]*)\}", body)]
    assert len(rows) == 7 and all(len(r) == F.NLIMBS for r in rows)
    assert all(0 <= d < F.RADIX for r in rows for d in r)
    values = [sum(d << (F.RADIX_BITS * i) for i, d in enumerate(r)) for r in rows]
    enum = re.search(r"enum \{ (TW_C2_0 = 0[^}]*)\};", src).group(1)
    assert tuple(n.strip().split(" ")[0] for n in enum.split(",")) == ROW_NAMES
    maps = {}
    for name in ("c2_conj", "c3_conj", "c3_neg_conj"):
        m = re.search(r"Fp %s\(.*?twist_part<(\w+), (\w+), (\w+), (\w+)>" % name, src, re.S)
        maps[name] = tuple(ROW_NAMES.index(n) for n in m.groups())
    return values, maps


def test_epilogue_twist_constants_are_the_twists_in_montgomery_form():
    values, _ = _source_table()
    c2 = [_mont(v) for v in c.TWIST_C2]
    c3 = [_mont(v) for v in c.TWIST_C3]
    assert values == [c2[0], c2[1], c.P - c2[0], c3[0], c3[1], c.P - c3[0], c.P - c3[1]]
    assert all(v < c.P for v in values)


@pytest.mark.parametrize("name", ["c2_conj", "c3_conj", "c3_neg_conj"])
def test_epilogue_twist_rows_give_the_frobenius_maps(name):
    """Component h = v0 a_h + v1 b_h on Montgomery values (each product
    reduced, as the kernel's one accumulator and one reduction give) equals
    c conj(v), c neg_conj(v) by the oracle's Fq2 product."""
    values, maps = _source_table()
    a0, b0, a1, b1 = (values[i] for i in maps[name])
    const = c.TWIST_C2 if name == "c2_conj" else c.TWIST_C3
    rng = np.random.default_rng(2113)
    for _ in range(16):
        v = tuple(int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(2))
        vm = [_mont(x) for x in v]
        got = tuple((vm[0] * a + vm[1] * b) * RINV % c.P for a, b in ((a0, b0), (a1, b1)))
        w = (v[0], -v[1] % c.P) if name != "c3_neg_conj" else (-v[0] % c.P, v[1])
        want = tuple(_mont(x) for x in o.fq2_mul(tuple(const), w))
        assert got == want
