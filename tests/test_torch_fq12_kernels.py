"""Kernel A's plain version and the kernel layout, against the JAX package.

On CPU tensors ``ops.fq12_kernels.fq12_mul`` takes its plain PyTorch
version; it must equal ``pairing_tpu.fields.fp12.fq12_mul`` exactly
(canonical values) and keep the kernel output envelope (limbs in
[0, 2^13 + 1], values < 2p). Also covers the layout bridges, the dispatch
rules (CPU -> plain, anything else -> kernel or raise) and the build
inputs. The kernel itself runs on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from pairing_tpu.fields import fp12 as JF12
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields import fp12 as TF12
from pairing_tpu_torch.ops import build, dispatch
from pairing_tpu_torch.ops import fq12_kernels as FK
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


B = 5  # odd on purpose: the port has no lane padding


def rand_fq12(rng, n=B):
    return JF12.fq12_from_int_coeffs(
        [[int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)] for _ in range(n)]
    )


def leaves(j):
    out = []
    for s in j.s:
        out += [np.asarray(s.c0.limbs), np.asarray(s.c1.limbs)]
    return out


def kf12_of(j) -> torch.Tensor:
    arr, bs = FK.to_kernel_layout(interop.fq12_from_leaves(leaves(j), "cpu"))
    assert bs == (B,) and tuple(arr.shape) == (12, 21, B) and arr.is_contiguous()
    return arr


def test_fq12_mul_plain_matches_jax():
    rng = np.random.default_rng(101)
    ja, jb = rand_fq12(rng), rand_fq12(rng)
    out = FK.fq12_mul(kf12_of(ja), kf12_of(jb))  # CPU tensors: plain version
    assert FK.kf12_in_envelope(out)
    got = TF12.fq12_to_int_coeffs(FK.from_kernel_layout(out, (B,)))
    assert got == j12_ints(JF12.fq12_mul(ja, jb))


def test_kernel_layout_roundtrip_and_batch_shape():
    rng = np.random.default_rng(102)
    j = rand_fq12(rng)
    a = interop.fq12_from_leaves(leaves(j), "cpu")
    back = FK.from_kernel_layout(*FK.to_kernel_layout(a))
    assert TF12.fq12_to_int_coeffs(back) == j12_ints(j)
    # a [2, 3] batch flattens to 6 lanes and comes back in shape
    coeffs = [[int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)] for _ in range(6)]
    t = TF12.fq12_from_int_coeffs(coeffs, "cpu")
    t2 = TF12.Fq12(tuple(
        type(s)(type(s.c0)(s.c0.limbs.reshape(2, 3, 21), s.c0.bound, s.c0.limb_bound),
                type(s.c1)(s.c1.limbs.reshape(2, 3, 21), s.c1.bound, s.c1.limb_bound))
        for s in t.s))
    arr, bs = FK.to_kernel_layout(t2)
    assert bs == (2, 3) and tuple(arr.shape) == (12, 21, 6)
    back = FK.from_kernel_layout(arr, bs)
    assert back.batch_shape == (2, 3)
    assert TF12.fq12_to_int_coeffs(back) == coeffs


def test_envelope_and_canonical_helpers():
    x = torch.zeros((12, 21, 3), dtype=torch.int32)
    assert FK.kf12_in_envelope(x)
    x[0, 0, 1] = 8194
    assert not FK.kf12_in_envelope(x)
    two_p = torch.as_tensor(TF.int_to_limbs(2 * c.P))
    y = two_p[None, :, None].expand(12, 21, 3).contiguous()
    assert not FK.kf12_in_envelope(y)  # value == 2p is outside
    p = torch.as_tensor(TF.int_to_limbs(c.P))[None, :, None].expand(12, 21, 3)
    assert FK.kf12_in_envelope(p)
    assert int(FK.kf12_canonical(p).abs().max()) == 0  # p == 0 mod p


def test_random_kf12_covers_the_envelope():
    """The operands the card tests feed the kernels: every value < 2p,
    values in [p, 2p) present, settled limbs 2^13 and 2^13 + 1 present."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    x = FK.random_kf12((2,), 4096, gen)
    assert tuple(x.shape) == (2, 21, 4096) and x.is_contiguous()
    assert x.dtype == torch.int32
    assert FK.kf12_in_envelope(x)
    assert bool((x == TF.RADIX).any()) and bool((x == TF.SETTLED).any())
    vals = [TF.limbs_to_int(r) for r in x.transpose(-1, -2).reshape(-1, 21).numpy()]
    assert any(v >= c.P for v in vals) and any(v < c.P for v in vals)
    assert max(vals) < 2 * c.P


def test_dispatch_routes_by_device():
    cpu = torch.zeros((12, 21, 2), dtype=torch.int32)
    assert dispatch.on_cuda(cpu, cpu) is False
    meta = torch.empty((12, 21, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        dispatch.on_cuda(meta)
    with pytest.raises(ValueError):
        dispatch.on_cuda(cpu, meta)
    with pytest.raises(ValueError):
        FK.fq12_mul(meta, meta)  # no plain path and no kernel for this device


def test_operand_checks():
    good = torch.zeros((12, 21, 4), dtype=torch.int32)
    dispatch.check_operand(good, "a", (12,), 4)
    with pytest.raises(TypeError):
        dispatch.check_operand(good.long(), "a", (12,), 4)
    with pytest.raises(ValueError):
        dispatch.check_operand(good, "a", (12,), 5)
    with pytest.raises(ValueError):
        dispatch.check_operand(good.transpose(1, 2).contiguous().transpose(1, 2), "a", (12,), 4)


def test_build_inputs():
    names = [p.name for p in build.sources()]
    assert names == ["affine_export.cu", "canonical.cu", "cyc_sq.cu", "exp_bits.cu", "fp_pow.cu",
                     "fq12_inv.cu", "fq12_mul.cu", "fq12_sq.cu", "fq2_inv.cu", "hard_chain.cu",
                     "lines.cu", "miller_epilogue.cu", "miller_f.cu", "norm.cu", "pow_ladder.cu",
                     "pow_naf.cu", "pow_w4.cu", "slotwise.cu", "trajectory.cu", "validate.cu",
                     "canon.cuh", "field.cuh", "field32.cuh", "field_group.cuh", "fq12_terms.cuh",
                     "lines.cuh", "slot_table.cuh", "trajectory.cuh"]
    assert len(build.source_hash()) == 16
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert set(build.ENTRY_POINTS) == {k.entry for k in dispatch.KERNELS.values()}
    for src in build.sources():
        text = src.read_text()
        if src.suffix == ".cu":  # the TPU kernel it replaces, or that it replaces none
            assert "Replaces pairing_tpu/ops/" in text or "Replaces no TPU kernel:" in text
            assert "Bound on the H100" in text
    dispatch.reset_launch_counts()
    assert set(dispatch.launch_counts().values()) == {0}
