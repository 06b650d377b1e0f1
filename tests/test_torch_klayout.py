"""Kernel B's plain version and the plain layout ops, against the JAX package.

``ops.klayout.kcyc_sq`` on CPU tensors (its plain version) must equal
``pairing_tpu.fields.fp12.fq12_cyclotomic_sq`` on cyclotomic-subgroup inputs
(the oracle's easy part of random values); ``kconj``, ``kfrob`` and ``kinv``
must equal ``conjugate``, ``frobenius_map`` and ``fq12_inv``. Exact
(canonical) comparison; every output in the kernel envelope.
"""

import numpy as np
import pytest
import torch

from pairing_tpu.fields import fp12 as JF12
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields import fp2 as TF2
from pairing_tpu_torch.fields import fp12 as TF12
from pairing_tpu_torch.ops import fq12_kernels as FK
from pairing_tpu_torch.ops import klayout as KL
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.utils import bn254 as c
from pairing_tpu_torch.utils import interop

torch.set_num_threads(2)

RINV = pow(1 << 273, -1, c.P)


def j12_ints(a) -> list:
    """JAX Fq12 -> 12-int coefficient lists, converted on the host (JAX's own
    canonical() recompiles a scan on every eager call)."""
    def vals(limbs):
        rows = np.asarray(limbs).reshape(-1, 21).astype(object)
        return [int(sum(int(v) << (13 * i) for i, v in enumerate(r))) * RINV % c.P for r in rows]

    comps = [vals(s.c0.limbs) for s in a.s] + [vals(s.c1.limbs) for s in a.s]
    return [list(row) for row in zip(*comps)]


B = 3


def rand_coeffs(rng, n=B):
    return [[int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)] for _ in range(n)]


def both(coeffs):
    """The same values in both packages: JAX Fq12 and port KF12."""
    j = JF12.fq12_from_int_coeffs(coeffs)
    leaves = []
    for s in j.s:
        leaves += [np.asarray(s.c0.limbs), np.asarray(s.c1.limbs)]
    arr, _ = FK.to_kernel_layout(interop.fq12_from_leaves(leaves, "cpu"))
    return j, arr


def port_ints(arr):
    assert FK.kf12_in_envelope(arr)
    return TF12.fq12_to_int_coeffs(FK.from_kernel_layout(arr, (arr.shape[-1],)))


def test_kcyc_sq_plain_matches_jax_on_cyclotomic_inputs():
    rng = np.random.default_rng(201)
    coeffs = [o.easy_part(x) for x in rand_coeffs(rng)]
    j, arr = both(coeffs)
    want = j12_ints(JF12.fq12_cyclotomic_sq(j))
    assert port_ints(KL.kcyc_sq(arr)) == want
    assert want == [o.fq12_mul(x, x) for x in coeffs]  # a square on the subgroup


def test_kconj_matches_jax():
    j, arr = both(rand_coeffs(np.random.default_rng(202)))
    assert port_ints(KL.kconj(arr)) == j12_ints(JF12.conjugate(j))


@pytest.mark.parametrize("power", [1, 2, 3])
def test_kfrob_matches_jax(power):
    j, arr = both(rand_coeffs(np.random.default_rng(210 + power)))
    assert port_ints(KL.kfrob(arr, power)) == j12_ints(JF12.frobenius_map(j, power))


@pytest.mark.parametrize("power", [None, 1, 2, 3])
def test_slot_program_matches_jax(power):
    """Kernel E's per-slot program, applied op by op with the field library
    as the kernel applies it, equals conjugate / frobenius_map."""
    j, arr = both(rand_coeffs(np.random.default_rng(220 + (power or 0))))
    ops, consts = KL._slot_prog(power)
    x = FK.kf12_view(arr)
    slots = []
    for i, s in enumerate(x.s):
        c0, c1 = s.c0, s.c1
        if ops[i] & KL.NEG_C0:
            c0 = TF.fp_neg(c0)
        if ops[i] & KL.NEG_C1:
            c1 = TF.fp_neg(c1)
        s = TF2.Fp2(c0, c1)
        if ops[i] & KL.MUL_CONST:
            k = torch.as_tensor(consts[i])[:, None, :].expand(2, B, TF.NLIMBS)
            s = TF2.mul(s, TF2.Fp2(TF.Fp(k[0], c.P, TF.MASK), TF.Fp(k[1], c.P, TF.MASK)))
        slots.append(s)
    want = JF12.conjugate(j) if power is None else JF12.frobenius_map(j, power)
    assert port_ints(FK.kf12_from(TF12.Fq12(tuple(slots)))) == j12_ints(want)


def test_kinv_matches_jax():
    coeffs = rand_coeffs(np.random.default_rng(203))
    j, arr = both(coeffs)
    got = port_ints(KL.kinv(arr))
    assert got == j12_ints(JF12.fq12_inv(j))
    assert got == [o.fq12_inv(x) for x in coeffs]


def test_kmul_is_kernel_a():
    assert KL.kmul is FK.fq12_mul


def test_kmul_sparse_and_ksq_are_kernel_wrappers():
    assert KL.kmul_sparse is FK.fq12_mul_sparse
    assert KL.ksq is FK.fq12_sq


def test_fq12_level_product_and_inverse_match_oracle():
    """``dispatch.fq12_mul`` (kernel A) and ``inv_kernels.fq12_inv`` (kernel
    G) on public Fq12 values of batch shape (1, 2)."""
    from pairing_tpu_torch.ops import dispatch
    from pairing_tpu_torch.ops.inv_kernels import fq12_inv
    from pairing_tpu_torch.utils.interop import map_limbs

    rng = np.random.default_rng(230)
    xs, ys = rand_coeffs(rng, 2), rand_coeffs(rng, 2)
    shape = lambda limbs: limbs.reshape(1, 2, TF.NLIMBS)  # noqa: E731
    x = map_limbs(TF12.fq12_from_int_coeffs(xs, "cpu"), shape)
    y = map_limbs(TF12.fq12_from_int_coeffs(ys, "cpu"), shape)
    prod, inv = dispatch.fq12_mul(x, y), fq12_inv(x)
    assert prod.batch_shape == inv.batch_shape == (1, 2)
    assert TF12.fq12_to_int_coeffs(prod) == [o.fq12_mul(a, b) for a, b in zip(xs, ys)]
    assert TF12.fq12_to_int_coeffs(inv) == [o.fq12_inv(a) for a in xs]
