"""Kernel dispatch: a CPU tensor takes the plain PyTorch version, a CUDA
tensor takes the hand-written kernel or raises.

There is no fallback: a wrapper given CUDA tensors launches its kernel
(building the library at first use) and raises if the launch fails; it never
moves work to the CPU. Each :class:`Kernel` counts its own launches in a
plain integer, so a run can show that its main path went through it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..fields.fp import NLIMBS
from . import build


class Kernel:
    """One C entry point of the kernel library, with its launch count."""

    def __init__(self, name: str, entry: str):
        self.name = name
        self.entry = entry
        self.launches = 0

    def __call__(self, *args) -> None:
        """Launch on the current CUDA stream. ``args`` are tensors (passed
        as device pointers) and ints, in the C entry point's order."""
        lib, _ = build.load()
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a) for a in args]
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, self.entry)(*c_args, stream)
        if err != 0:
            msg = lib.pt_error_string(err).decode()
            raise RuntimeError(f"{self.name}: launch failed: CUDA error {err} ({msg})")
        self.launches += 1


#: Every kernel of the port, by name; the wrappers own one each. Kernel C's
#: modes share one entry point but count apart: ``miller_f`` is one pair per
#: product without collection, ``miller_f_multi`` several pairs per product,
#: ``miller_f_collect`` any launch that writes the per-step accumulator.
KERNELS = {
    name: Kernel(name, entry)
    for name, entry in (
        ("fq12_mul", "pt_fq12_mul"),
        ("fq12_cyc_sq", "pt_fq12_cyc_sq"),
        ("miller_f", "pt_miller_f"),
        ("miller_f_multi", "pt_miller_f"),
        ("miller_f_collect", "pt_miller_f"),
        ("pow_ladder_stream", "pt_pow_ladder_stream"),
        ("fq12_slotwise", "pt_fq12_slotwise"),
        ("fp_pow_bits", "pt_fp_pow_bits"),
        ("fq12_inv", "pt_fq12_inv"),
        ("trajectory", "pt_trajectory"),
        ("prefix_products", "pt_prefix_products"),
        ("running_inverse", "pt_running_inverse"),
        ("lines", "pt_lines"),
        ("exp_bits", "pt_exp_bits"),
        ("affine_export", "pt_affine_export"),
    )
}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


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
