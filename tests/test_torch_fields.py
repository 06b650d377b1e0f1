"""The PyTorch port's field tower against the JAX package, exactly.

Same seeded inputs enter both packages (JAX limbs carried over through
``pairing_tpu_torch.utils.interop``); outputs are compared as canonical
integers with tolerance zero, and every port output is held to the static
envelope it claims (limbs in [0, limb_bound], value < bound).
Also: the port's constants equal the JAX package's limb arrays and the CUDA
header's tables, and the copied pure-Python modules equal their originals.
"""

import ast
import re
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from pairing_tpu.fields import fp as JF
from pairing_tpu.fields import fp2 as JF2
from pairing_tpu.fields import fp12 as JF12
from pairing_tpu.utils import bn254 as jc
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields import fp2 as TF2
from pairing_tpu_torch.fields import fp12 as TF12
from pairing_tpu_torch.utils import bn254 as tc
from pairing_tpu_torch.utils import interop

torch.set_num_threads(2)

P = jc.P
B = 4
REPO = Path(__file__).resolve().parent.parent


def rand_ints(rng, n):
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


def to_port(j: JF.Fp) -> TF.Fp:
    return interop.fp_from_numpy(np.asarray(j.limbs), "cpu", bound=j.bound, limb_bound=j.limb_bound)


def to_port2(j: JF2.Fp2) -> TF2.Fp2:
    return TF2.Fp2(to_port(j.c0), to_port(j.c1))


def to_port12(j: JF12.Fq12) -> TF12.Fq12:
    return TF12.Fq12(tuple(to_port2(s) for s in j.s))


def assert_envelope(a: TF.Fp):
    limbs = a.limbs.numpy()
    assert limbs.min() >= 0 and limbs.max() <= a.limb_bound <= 2**31
    for row in limbs.reshape(-1, TF.NLIMBS):
        assert TF.limbs_to_int(row) < a.bound


RINV = pow(TF.R_MONT, -1, P)


def mont_ints(limbs) -> list:
    """Montgomery limb rows [..., 21] -> values mod p, on the host (JAX's own
    canonical() recompiles a scan on every eager call)."""
    return [TF.limbs_to_int(r) * RINV % P for r in np.asarray(limbs).reshape(-1, TF.NLIMBS)]


def j_ints(a: JF.Fp):
    return mont_ints(a.limbs)


def j12_ints(a: JF12.Fq12):
    comps = [mont_ints(s.c0.limbs) for s in a.s] + [mont_ints(s.c1.limbs) for s in a.s]
    return [list(row) for row in zip(*comps)]


def t_ints(a: TF.Fp):
    assert_envelope(a)
    return [int(v) for v in TF.fp_to_ints(TF.canonical(TF.from_mont(a))).reshape(-1)]


def j_fp(rng):
    return JF.fp_from_ints_mont(rand_ints(rng, B))


def j_fp2(rng):
    return JF2.Fp2(j_fp(rng), j_fp(rng))


def j_fq12(rng):
    return JF12.fq12_from_int_coeffs([rand_ints(rng, 12) for _ in range(B)])


# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------

FP_OPS = {
    "add": (JF.fp_add, TF.fp_add, 2),
    "sub": (JF.fp_sub, TF.fp_sub, 2),
    "neg": (JF.fp_neg, TF.fp_neg, 1),
    "scale9": (lambda a: JF.fp_scale(a, 9), lambda a: TF.fp_scale(a, 9), 1),
    "mont_mul": (JF.mont_mul, TF.mont_mul, 2),
    "to_mont": (JF.to_mont, TF.to_mont, 1),
    "weak_reduce": (JF.weak_reduce, TF.weak_reduce, 1),
    "cap_2p": (lambda a: JF._cap_2p(JF.fp_scale(a, 7)),
               lambda a: TF._cap_2p(TF.fp_scale(a, 7)), 1),
    "pow_bits": (lambda a: JF.fp_pow_bits(a, 0b1011001), lambda a: TF.fp_pow_bits(a, 0b1011001), 1),
}


@pytest.mark.parametrize("name", sorted(FP_OPS))
def test_fp_op_matches_jax(name):
    jfn, tfn, arity = FP_OPS[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    args = [j_fp(rng) for _ in range(arity)]
    assert t_ints(tfn(*[to_port(a) for a in args])) == j_ints(jfn(*args))


def test_fp_inv_and_canonical_match_jax():
    rng = np.random.default_rng(1)
    a = j_fp(rng)
    assert t_ints(TF.fp_inv(to_port(a))) == j_ints(JF.fp_inv(a))
    c = TF.canonical(TF.fp_scale(to_port(a), 5))
    assert c.limbs.max() <= TF.MASK
    assert [TF.limbs_to_int(r) for r in c.limbs.numpy()] == [v * 5 * TF.R_MONT % P for v in j_ints(a)]


# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------

FP2_OPS = {
    "add": (JF2.add, TF2.add, 2),
    "sub": (JF2.sub, TF2.sub, 2),
    "neg": (JF2.neg, TF2.neg, 1),
    "conj": (JF2.conj, TF2.conj, 1),
    "neg_conj": (JF2.neg_conj, TF2.neg_conj, 1),
    "mul": (JF2.mul, TF2.mul, 2),
    "square": (JF2.square, TF2.square, 1),
    "mul_w6": (JF2.mul_w6, TF2.mul_w6, 1),
    "mul_fp": (lambda a, b: JF2.mul_fp(a, b.c0), lambda a, b: TF2.mul_fp(a, b.c0), 2),
    "inv": (JF2.inv, TF2.inv, 1),
}


@pytest.mark.parametrize("name", sorted(FP2_OPS))
def test_fp2_op_matches_jax(name):
    jfn, tfn, arity = FP2_OPS[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()) + 7)
    args = [j_fp2(rng) for _ in range(arity)]
    got = tfn(*[to_port2(a) for a in args])
    want = jfn(*args)
    assert t_ints(got.c0) == j_ints(want.c0)
    assert t_ints(got.c1) == j_ints(want.c1)


# ---------------------------------------------------------------------------
# Fq12
# ---------------------------------------------------------------------------


def assert_fq12_equal(got: TF12.Fq12, want: JF12.Fq12):
    for s in got.s:
        assert_envelope(s.c0)
        assert_envelope(s.c1)
    assert TF12.fq12_to_int_coeffs(got) == j12_ints(want)


def test_fq12_mul_and_square_match_jax():
    rng = np.random.default_rng(12)
    a, b = j_fq12(rng), j_fq12(rng)
    assert_fq12_equal(TF12.fq12_mul(to_port12(a), to_port12(b)), JF12.fq12_mul(a, b))
    assert_fq12_equal(TF12.fq12_sq(to_port12(a)), JF12.fq12_sq(a))


@pytest.mark.parametrize("slots", [(0, 3, 4), (2, 3, 5)])
def test_fq12_mul_sparse_matches_jax(slots):
    rng = np.random.default_rng(sum(slots))
    a = j_fq12(rng)
    line = {k: j_fp2(rng) for k in slots}
    got = TF12.fq12_mul_sparse(to_port12(a), {k: to_port2(v) for k, v in line.items()})
    assert_fq12_equal(got, JF12.fq12_mul_sparse(a, line))


def test_fq12_int_roundtrip_and_one():
    rng = np.random.default_rng(3)
    coeffs = [rand_ints(rng, 12) for _ in range(B)]
    assert TF12.fq12_to_int_coeffs(TF12.fq12_from_int_coeffs(coeffs, "cpu")) == coeffs
    assert TF12.fq12_to_int_coeffs(TF12.fq12_one((2,), "cpu")) == [[1] + [0] * 11] * 2


def test_interop_carries_jax_values_both_ways():
    import jax

    from pairing_tpu.curves import g1 as JG1
    from pairing_tpu.curves import g2 as JG2

    rng = np.random.default_rng(4)
    xs = rand_ints(rng, 6 * B)
    g1 = JG1.g1_from_ints(list(zip(xs[:B], xs[B:2 * B])))
    g2 = JG2.g2_from_ints([((a, b), (c_, d)) for a, b, c_, d in
                           zip(*(xs[k * B:(k + 1) * B] for k in range(2, 6)))])
    leaves1 = [np.asarray(v) for v in jax.tree.leaves(g1)]
    leaves2 = [np.asarray(v) for v in jax.tree.leaves(g2)]
    p = interop.g1_from_leaves(leaves1, "cpu", bound=P, limb_bound=TF.MASK)
    q = interop.g2_from_leaves(leaves2, "cpu", bound=P, limb_bound=TF.MASK)
    assert t_ints(p.x) + t_ints(p.y) == xs[:2 * B]
    assert t_ints(q.x.c0) + t_ints(q.x.c1) + t_ints(q.y.c0) + t_ints(q.y.c1) == xs[2 * B:]

    j = j_fq12(rng)
    port = interop.fq12_from_leaves([np.asarray(v) for v in jax.tree.leaves(j)], "cpu")
    assert TF12.fq12_to_int_coeffs(port) == j12_ints(j)
    back = jax.tree.unflatten(jax.tree.structure(j), interop.fq12_to_leaves(port))
    assert j12_ints(back) == j12_ints(j)


# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------


def test_limb_constants_match_jax():
    assert TF.P_LIMBS.tolist() == JF.P_LIMBS.tolist()
    assert TF.NPRIME_LIMBS.tolist() == JF.NPRIME_LIMBS.tolist()
    for name in ("RADIX_BITS", "NLIMBS", "R_MONT", "R2_MOD_P", "R_MOD_P", "NPRIME",
                 "SETTLED", "WIDE_NLIMBS", "MAX_MUL_INPUT"):
        assert getattr(TF, name) == getattr(JF, name), name
    assert TF._const_limbs(TF.R2_MOD_P).tolist() == JF._const_limbs(JF.R2_MOD_P).tolist()
    for power in (1, 2, 3, 6):
        for i in range(6):
            assert tc.frob_coeff_pow(power, i) == jc.frob_coeff_pow(power, i)
            got = TF2.fp2_from_ints(tc.frob_coeff_pow(power, i), (), "cpu")
            want = JF2.fp2_from_ints(jc.frob_coeff_pow(power, i), mont=True)
            assert got.c0.limbs.tolist() == np.asarray(want.c0.limbs).tolist()
            assert got.c1.limbs.tolist() == np.asarray(want.c1.limbs).tolist()


def test_cuda_header_constants():
    """The tables in csrc/field.cuh equal the values they stand for."""
    text = (REPO / "pairing_tpu_torch" / "csrc" / "field.cuh").read_text()
    body = text[text.index("KP[6][NL] = {"):]
    body = body[: body.index("};")]
    rows = [[int(v) for v in re.findall(r"\d+", r)] for r in re.findall(r"\{([^{}]*)\}", body)]
    want = [P, 2 * P, 4 * P, 8 * P, 16 * P, TF.R_MOD_P]
    assert [TF.limbs_to_int(r) for r in rows] == want
    assert all(len(r) == TF.NLIMBS and max(r) <= TF.MASK for r in rows)
    np0 = int(re.search(r"NP0 = (\d+);", text).group(1))
    assert (P * np0) % TF.RADIX == TF.RADIX - 1
    assert 480 * P * P < TF.R_MONT * P  # the header's lazy-sum bound


# ---------------------------------------------------------------------------
# The copied pure-Python modules
# ---------------------------------------------------------------------------


#: The differences a copy may have besides its docstrings: its imports and
#: these string constants, ours -> the original's (the native codec's cache
#: directory, apart from the JAX package's so the two never share a .so).
ALLOWED_STRINGS = {"native/__init__.py": {"pairing_tpu_torch": "pairing_tpu"}}


def _code_without_docstrings(path: Path, strings=None) -> str:
    strings = strings or {}
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.Constant) and node.value in strings:
            node.value = strings[node.value]
        if isinstance(node, ast.ImportFrom) and node.module:
            node.module = node.module.replace("pairing_tpu_torch", "pairing_tpu")
    return ast.dump(tree)


@pytest.mark.parametrize("rel", ["utils/bn254.py", "oracle/native.py",
                                 "witness/constraints.py", "witness/verify.py",
                                 "native/__init__.py"])
def test_copied_module_matches_original(rel):
    """The copies differ from the JAX package's modules in docstrings only,
    besides their imports and the strings of ALLOWED_STRINGS."""
    ours = _code_without_docstrings(REPO / "pairing_tpu_torch" / rel, ALLOWED_STRINGS.get(rel, {}))
    theirs = _code_without_docstrings(REPO / "pairing_tpu" / rel)
    assert ours == theirs


def test_copied_oracle_agrees_with_original():
    from pairing_tpu.oracle import native as jo
    from pairing_tpu_torch.oracle import native as to

    for name in ("P", "R_SCALAR", "BN_X", "XI_0", "TWIST_C2", "TWIST_C3", "TWIST_B",
                 "SIX_U_PLUS_2_NAF", "BN_X_NAF", "G2_GEN_X", "G2_GEN_Y", "FINAL_EXP_POWER"):
        assert getattr(tc, name) == getattr(jc, name), name
    rng = np.random.default_rng(5)
    k = int.from_bytes(rng.bytes(32), "little") % jc.R_SCALAR
    g1 = to.g1_mul(tc.G1_GEN, k)
    g2 = to.g2_mul((tc.G2_GEN_X, tc.G2_GEN_Y), k + 1)
    assert g1 == jo.g1_mul(jc.G1_GEN, k)
    assert g2 == jo.g2_mul((jc.G2_GEN_X, jc.G2_GEN_Y), k + 1)
    assert to.miller_loop(g2, g1) == jo.miller_loop(g2, g1)
