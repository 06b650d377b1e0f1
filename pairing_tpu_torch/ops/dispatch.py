"""Kernel dispatch: a CPU tensor takes the plain PyTorch version, a CUDA
tensor takes the hand-written kernel or raises.

There is no fallback: a wrapper given CUDA tensors launches its kernel
(building the library at first use) and raises if the launch fails; it never
moves work to the CPU. Each :class:`Kernel` counts its own launches in a
plain integer, so a run can show that its main path went through it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch

from ..fields.fp import NLIMBS
from . import build


class Host:
    """A host table handed to a C entry by its address: the entry reads it
    on the host before the launch (kernel E's and K15's programs, K13's
    segment table). It is not a device operand and takes no part in the
    choice of the device."""

    def __init__(self, t: torch.Tensor):
        if t.device.type != "cpu" or not t.is_contiguous():
            raise ValueError(f"a host table must be a contiguous CPU tensor, not {t.device}")
        self.tensor = t


class Kernel:
    """One C entry point of the kernel library, with its launch count."""

    def __init__(self, name: str, entry: str):
        self.name = name
        self.entry = entry
        self.launches = 0

    def __call__(self, *args) -> None:
        """Launch on the current stream of the device the tensor arguments
        are on, with that device current (so the C entry's
        ``cudaFuncSetAttribute`` calls apply to it too). ``args`` are tensors
        (device operands, passed as device pointers), :class:`Host` tables,
        ints, and None (a null pointer), in the C entry point's order.
        Raises ValueError unless every tensor argument is on one CUDA
        device."""
        devices = {a.device for a in args if isinstance(a, torch.Tensor)}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"{self.name}: operands on {sorted(map(str, devices))}, "
                             "want one CUDA device")
        (dev,) = devices
        lib, _ = build.load()
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else
                  a.tensor.data_ptr() if isinstance(a, Host) else
                  a if a is None else int(a) for a in args]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, self.entry)(*c_args, stream)
        if err != 0:
            msg = lib.pt_error_string(err).decode()
            raise RuntimeError(f"{self.name}: launch failed: CUDA error {err} ({msg})")
        self.launches += 1


#: Every kernel of the port, by name; the wrappers own one each. Modes of one
#: kernel share its entry point but count apart: kernel A's ``fq12_mul`` is
#: the dense product, ``fq12_mul_sparse`` the product by a line (some slots of
#: b absent); kernel C's ``miller_f`` is one pair per product without
#: collection, ``miller_f_multi`` several pairs per product,
#: ``miller_f_collect`` any launch that writes the per-step accumulator;
#: kernel H's ``trajectory`` stores every loop top and post-double,
#: ``trajectory_end`` the end state alone; ``k_canonical``'s ``canonical``
#: writes canonical digits, ``canonical_eq`` compares pairs of values;
#: ``k_validate``'s ``g1_on_curve``, ``g2_on_curve`` and
#: ``g2_subgroup_compare`` are the three checks of ``validate_inputs``.
KERNELS = {
    name: Kernel(name, entry)
    for name, entry in (
        ("fq12_mul", "pt_fq12_mul"),
        ("fq12_mul_sparse", "pt_fq12_mul"),
        ("fq12_sq", "pt_fq12_sq"),
        ("fq12_cyc_sq", "pt_fq12_cyc_sq"),
        ("miller_f", "pt_miller_f"),
        ("miller_f_multi", "pt_miller_f"),
        ("miller_f_collect", "pt_miller_f"),
        ("pow_ladder_stream", "pt_pow_ladder_stream"),
        ("fq12_slotwise", "pt_fq12_slotwise"),
        ("fp_pow_bits", "pt_fp_pow_bits"),
        ("fq2_inv", "pt_fq2_inv"),
        ("fq12_inv", "pt_fq12_inv"),
        ("trajectory", "pt_trajectory"),
        ("trajectory_end", "pt_trajectory"),
        ("prefix_products", "pt_prefix_products"),
        ("running_inverse", "pt_running_inverse"),
        ("lines", "pt_lines"),
        ("exp_bits", "pt_exp_bits"),
        ("affine_export", "pt_affine_export"),
        ("pow_ladder", "pt_pow_ladder"),
        ("pow_ladder_w4", "pt_pow_ladder_w4"),
        ("hard_chain", "pt_hard_chain"),
        ("epilogue_points", "pt_epilogue_points"),
        ("epilogue_lines", "pt_epilogue_lines"),
        ("canonical", "pt_canonical"),
        ("canonical_eq", "pt_canonical"),
        ("g1_on_curve", "pt_validate"),
        ("g2_on_curve", "pt_validate"),
        ("g2_subgroup_compare", "pt_validate"),
    )
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


@lru_cache(maxsize=None)
def device_table(values: tuple, device: torch.device) -> torch.Tensor:
    """A kernel's host constant as int32 on ``device``, of the shape of
    ``values``: a digit or bit string (ints: H's, K12's, K16's and K17's
    digits, F's exponent words), or a schedule (tuples of one length: C's
    and D's steps, K's chord table). Built once per (values, device), so a
    launch copies nothing from the host; every caller of a key shares the
    tensor, and the kernels only read it."""
    return torch.as_tensor(np.asarray(values, np.int32), device=device)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for tensors on one CUDA device, False for CPU tensors; raises on
    any other device or a mix."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    (dev,) = devices
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def check_operand(t: torch.Tensor, name: str, lead: Sequence[int], lanes: int) -> None:
    """A kernel operand must be int32, contiguous, shape [*lead, 21, lanes]."""
    want = tuple(lead) + (NLIMBS, lanes)
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, want torch.int32")
    if tuple(t.shape) != want:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {want}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def fq12_mul(a, b):
    """Dense Fq12 product of two Fq12 values (any batch shape) on kernel A:
    one conversion to the kernel layout each way."""
    from .fq12_kernels import fq12_mul as kmul
    from .fq12_kernels import from_kernel_layout, to_kernel_layout

    a_arr, bs = to_kernel_layout(a)
    b_arr, _ = to_kernel_layout(b)
    return from_kernel_layout(kmul(a_arr, b_arr), bs)


def fq12_mul_sparse(a, slots: dict):
    """a times the sparse Fq12 whose nonzero slots are ``slots`` {slot: Fp2}
    (a line: slots (0, 3, 4) or (2, 3, 5)), on kernel A's sparse mode. The
    absent slots of the kernel operand are zero and never read."""
    from ..fields import fp2 as F2
    from ..fields.fp12 import Fq12
    from .fq12_kernels import fq12_mul_sparse as kmul_sparse
    from .fq12_kernels import from_kernel_layout, to_kernel_layout

    a_arr, bs = to_kernel_layout(a)
    some = next(iter(slots.values())).c0.limbs
    zero = F2.zero(tuple(some.shape[:-1]), some.device)
    b = Fq12(tuple(slots.get(i, zero) for i in range(6)))
    b_arr, _ = to_kernel_layout(b)
    return from_kernel_layout(kmul_sparse(a_arr, tuple(slots), b_arr), bs)
