"""Kernel F's plain version (a^e in Fq) against the JAX package.

``ops.fp_kernels.fp_pow_bits`` on CPU tensors [21, B] takes its plain
version; it must equal ``pairing_tpu.fields.fp.fp_pow_bits`` exactly
(canonical values) and keep the kernel envelope. ``fp_kernels.fp_inv`` (the
Fermat inverse behind Phase N's one Fq2 inversion) must equal
``fields.fp.fp_inv`` on a batch of any shape.
"""

import numpy as np
import pytest
import torch

from pairing_tpu.fields import fp as JF
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.ops import fp_kernels as FPK
from pairing_tpu_torch.ops import fq12_kernels as FK
from pairing_tpu_torch.utils import bn254 as c
from pairing_tpu_torch.utils import interop

torch.set_num_threads(2)

B = 5
RINV = pow(TF.R_MONT, -1, c.P)


def mont_ints(limbs) -> list:
    return [TF.limbs_to_int(r) * RINV % c.P for r in np.asarray(limbs).reshape(-1, TF.NLIMBS)]


def j_fp(rng, n=B):
    return JF.fp_from_ints_mont([int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(n)])


@pytest.mark.parametrize("e", [1, 2, 0b1011001, c.P - 2])
def test_fp_pow_bits_plain_matches_jax(e):
    j = j_fp(np.random.default_rng(e % 1000))
    arr = torch.as_tensor(np.ascontiguousarray(np.asarray(j.limbs).T))  # [21, B]
    out = FPK.fp_pow_bits(arr, e)  # CPU tensor: plain version
    assert tuple(out.shape) == (TF.NLIMBS, B) and FK.kf12_in_envelope(out)
    got = mont_ints(out.T.numpy())
    assert got == mont_ints(JF.fp_pow_bits(j, e).limbs)
    assert got == [pow(v, e, c.P) for v in mont_ints(j.limbs)]


def test_fp_inv_through_kernel_f_matches_jax():
    j = j_fp(np.random.default_rng(17), 6)
    a = interop.fp_from_numpy(np.asarray(j.limbs).reshape(2, 3, TF.NLIMBS), "cpu")
    out = FPK.fp_inv(a)
    assert out.batch_shape == (2, 3)
    assert mont_ints(out.limbs.numpy()) == mont_ints(JF.fp_inv(j).limbs)


def test_exponent_words():
    words, top = FPK.exponent_words(0b1011001, torch.device("cpu"))
    assert words.dtype == torch.int32 and words.tolist() == [0b1011001] and top == 6
    words, top = FPK.exponent_words(1, torch.device("cpu"))
    assert words.tolist() == [1] and top == 0
    e = c.P - 2
    words, top = FPK.exponent_words(e, torch.device("cpu"))
    assert top == 253 and words.numel() == 8
    assert sum((w & 0xFFFFFFFF) << (32 * k) for k, w in enumerate(words.tolist())) == e
    assert FPK.exponent_words((1 << 32) - 1, torch.device("cpu"))[0].tolist() == [-1]
    assert FPK.exponent_words(1 << 32, torch.device("cpu"))[0].tolist() == [0, 1]
    assert FPK.exponent_words(1 << 600, torch.device("cpu"))[0].numel() == 19
    # the kernel reads every exponent's words from the operand's device
    for e in (1, c.P - 2, 1 << 600):
        assert FPK.exponent_words(e, torch.device("cpu"))[0].device == torch.device("cpu")
    with pytest.raises(ValueError):
        FPK.exponent_words(0, torch.device("cpu"))
