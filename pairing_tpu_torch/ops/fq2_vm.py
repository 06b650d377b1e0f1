"""Kernel K13 — the witness path's affine export of the Miller trajectory.

The counterpart of ``pairing_tpu/ops/fq2_vm.py``'s ``vm_apply_stacked``.
On the TPU that is an Fq2 instruction interpreter run once per (stack entry,
batch tile); the witness path drives it with one program only,
``miller_loop._affine_export_program``: (X, Y, zi) -> (X zi^2, Y zi^3). The
interpreter existed to keep long Fq2 programs small in kernel IR; a GPU
thread runs straight-line code, and this program is four Fq2 operations, so
the kernel (``csrc/affine_export.cu``) is that program written out and the
general interpreter is not carried over. Kernel G (``klayout.kinv``) is the
other program the reference ran on it, likewise written out.
"""

from __future__ import annotations

import torch

from . import dispatch
from .fq12_kernels import kstack
from .line_kernels import affine

AFFINE_EXPORT = dispatch.KERNELS["affine_export"]

#: gridDim.y limit: one block row per stack state.
MAX_STATES = 65535


def affine_export_plain(xy: torch.Tensor, zinv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel K13."""
    x, y = affine(xy, zinv)
    return kstack([x.c0, x.c1, y.c0, y.c1]).transpose(0, 1).contiguous()


def affine_export(xy: torch.Tensor, zinv: torch.Tensor) -> torch.Tensor:
    """Affine coordinates of a stack of Jacobian states.

    xy: [S, 4, NLIMBS, B] (X.c0, X.c1, Y.c0, Y.c1 of each state); zinv:
    [S, 2, NLIMBS, B] (1 / Z). Returns [S, 4, NLIMBS, B] = (x.c0, x.c1,
    y.c0, y.c1) with x = X zi^2, y = Y zi^3."""
    if xy.shape[0] != zinv.shape[0]:
        raise ValueError(f"{xy.shape[0]} states but {zinv.shape[0]} inverses")
    if not dispatch.on_cuda(xy, zinv):
        return affine_export_plain(xy, zinv)
    n_states, lanes = xy.shape[0], xy.shape[-1]
    if n_states > MAX_STATES:
        raise ValueError(f"{n_states} states, at most {MAX_STATES}")
    dispatch.check_operand(xy, "xy", (n_states, 4), lanes)
    dispatch.check_operand(zinv, "zinv", (n_states, 2), lanes)
    out = torch.empty_like(xy)
    AFFINE_EXPORT(xy, zinv, n_states, out, lanes)
    return out

