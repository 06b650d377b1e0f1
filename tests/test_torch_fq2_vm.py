"""Kernel K13's plain version (``ops.fq2_vm.affine_export_plain``, the
witness path's affine export) against the oracle's affine coordinates.

Jacobian states (X, Y, Z) = (x z^2, y z^3, z) of seeded G2 points with
seeded z go in with 1 / Z; (x, y) must come out, exactly, in the envelope.
"""

import numpy as np
import pytest
import torch

from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.ops import fq2_vm as VM
from pairing_tpu_torch.ops.fq12_kernels import kf12_in_envelope
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.utils import bn254 as c
from pairing_tpu_torch.utils.interop import limb_values

torch.set_num_threads(2)

S, B = 3, 2  # stack states, lanes
RINV = pow(TF.R_MONT, -1, c.P)


def _rows(fq2s):
    """[S][B] Fq2 ints -> Montgomery component rows [S, 2, 21, B]."""
    limbs = [[[TF.int_to_limbs(v * TF.R_MONT % c.P) for v in x] for x in row] for row in fq2s]
    return torch.as_tensor(np.ascontiguousarray(np.asarray(limbs).transpose(0, 2, 3, 1)))


def test_affine_export_plain_matches_oracle():
    rng = np.random.default_rng(401)

    def scalar():
        return int.from_bytes(rng.bytes(32), "little") % (c.R_SCALAR - 1) + 1

    pts = [[o.g2_mul((c.G2_GEN_X, c.G2_GEN_Y), scalar()) for _ in range(B)] for _ in range(S)]
    zs = [[(scalar(), scalar()) for _ in range(B)] for _ in range(S)]
    X = [[c.fq2_mul(pt[0], c.fq2_mul(z, z)) for pt, z in zip(r, zr)] for r, zr in zip(pts, zs)]
    Y = [[c.fq2_mul(pt[1], c.fq2_mul(z, c.fq2_mul(z, z))) for pt, z in zip(r, zr)]
         for r, zr in zip(pts, zs)]
    zinv = [[c.fq2_inv(z) for z in zr] for zr in zs]
    xy = torch.cat([_rows(X), _rows(Y)], dim=1)  # [S, 4, 21, B]
    out = VM.affine_export(xy, _rows(zinv))
    assert out.shape == (S, 4, 21, B) and kf12_in_envelope(out)
    vals = limb_values(out.permute(0, 3, 1, 2).numpy())  # [S, B, 4], Montgomery
    for s in range(S):
        for b in range(B):
            got = [v * RINV % c.P for v in vals[s, b]]
            (x0, x1), (y0, y1) = pts[s][b]
            assert got == [x0, x1, y0, y1], (s, b)


def test_affine_export_rejects_mismatched_stacks():
    with pytest.raises(ValueError):
        VM.affine_export(torch.zeros((3, 4, 21, 2), dtype=torch.int32),
                         torch.zeros((2, 2, 21, 2), dtype=torch.int32))
