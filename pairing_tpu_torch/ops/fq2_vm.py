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

from ..fields.fp import NLIMBS
from . import dispatch
from .fq12_kernels import kstack
from .line_kernels import affine

AFFINE_EXPORT = dispatch.KERNELS["affine_export"]

#: gridDim.y limit: one block row per stack state.
MAX_STATES = 65535
#: Segments the kernel takes (csrc/affine_export.cu, K13_MAX_SEGS).
MAX_SEGMENTS = 4


def _segments(xy) -> tuple:
    return (xy,) if isinstance(xy, torch.Tensor) else tuple(xy)


def affine_export_plain(xy, zinv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel K13."""
    x, y = affine(torch.cat(_segments(xy)), zinv)
    return kstack([x.c0, x.c1, y.c0, y.c1]).transpose(0, 1).contiguous()


def _segment_rows(t: torch.Tensor, name: str, lanes: int) -> int:
    """Component rows from one state of a segment [S_k, 4, NLIMBS, B] to the
    next; its rows must be whole rows of B words, as in a slice [:, 0:4] of
    a contiguous [S_k, R, NLIMBS, B]."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, want torch.int32")
    if t.dim() != 4 or tuple(t.shape[1:]) != (4, NLIMBS, lanes):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want [S, 4, {NLIMBS}, {lanes}]")
    row = NLIMBS * lanes
    if tuple(t.stride()[1:]) != (row, lanes, 1):
        raise ValueError(f"{name}: component rows not contiguous")
    if t.shape[0] == 1:
        return 4
    if t.stride(0) % row or t.stride(0) < 4 * row:
        raise ValueError(f"{name}: state stride {t.stride(0)} is not whole rows")
    return t.stride(0) // row


def affine_export(xy, zinv: torch.Tensor) -> torch.Tensor:
    """Affine coordinates of a stack of Jacobian states.

    xy: [S, 4, NLIMBS, B] (X.c0, X.c1, Y.c0, Y.c1 of each state), or the
    stack as up to MAX_SEGMENTS segments in order, each [S_k, 4, NLIMBS, B]
    and possibly a slice [:, 0:4] of a larger stack of rows (the kernel reads
    them where they lie); zinv: [S, 2, NLIMBS, B] (1 / Z). Returns
    [S, 4, NLIMBS, B] = (x.c0, x.c1, y.c0, y.c1) with x = X zi^2, y = Y zi^3."""
    segs = _segments(xy)
    n_states = sum(t.shape[0] for t in segs)
    if n_states != zinv.shape[0]:
        raise ValueError(f"{n_states} states but {zinv.shape[0]} inverses")
    if not dispatch.on_cuda(*segs, zinv):
        return affine_export_plain(segs, zinv)
    lanes = zinv.shape[-1]
    if n_states > MAX_STATES:
        raise ValueError(f"{n_states} states, at most {MAX_STATES}")
    if not 1 <= len(segs) <= MAX_SEGMENTS:
        raise ValueError(f"{len(segs)} segments, want 1 to {MAX_SEGMENTS}")
    table = torch.tensor([[t.data_ptr(), t.shape[0], _segment_rows(t, f"xy[{i}]", lanes)]
                          for i, t in enumerate(segs)], dtype=torch.int64)
    dispatch.check_operand(zinv, "zinv", (n_states, 2), lanes)
    out = torch.empty((n_states, 4, NLIMBS, lanes), dtype=torch.int32, device=zinv.device)
    AFFINE_EXPORT(dispatch.Host(table), len(segs), zinv, n_states, out, lanes)
    return out
