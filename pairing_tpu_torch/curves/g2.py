"""Batched BN254 G2 (sextic twist E': y^2 = x^3 + 3/xi over Fq2).

PyTorch counterpart of ``pairing_tpu/curves/g2.py``. The Miller loop never
inverts per step: point trajectories run in Jacobian coordinates
(``jac_double`` / ``jac_mixed_add``, a=0 formulas) and are converted to
affine in bulk with one Fermat inversion per lane (``batch_to_affine``, on
Phase N's kernels I, F and J), value-identical to an affine chain because
affine coordinates are unique. ``g2_in_subgroup`` runs its [6x^2] Q ladder
on kernel H's end-only mode.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch.profiler import record_function

from ..utils.bn254 import BN_X, TWIST_B, TWIST_C2, TWIST_C3, get_naf
from ..fields import fp as F
from ..fields import fp2 as F2
from ..fields.fp2 import Fp2


@dataclasses.dataclass
class G2:
    """Affine point batch over Fq2 (Montgomery domain)."""

    x: Fp2
    y: Fp2

    @property
    def batch_shape(self):
        return self.x.batch_shape


@dataclasses.dataclass
class G2Jac:
    """Jacobian point batch: x = X/Z^2, y = Y/Z^3."""

    X: Fp2
    Y: Fp2
    Z: Fp2


def g2_from_ints(points: Sequence[Tuple[Tuple[int, int], Tuple[int, int]]],
                 device) -> G2:
    """[((x0,x1),(y0,y1)), ...] host ints -> G2 batch."""
    return G2(
        F2.fp2_stack_from_ints([p[0] for p in points], device),
        F2.fp2_stack_from_ints([p[1] for p in points], device),
    )


def g2_to_ints(p: G2):
    xs = F2.fp2_to_ints(p.x)
    ys = F2.fp2_to_ints(p.y)
    return [
        ((int(x[0]), int(x[1])), (int(y[0]), int(y[1]))) for x, y in zip(xs, ys)
    ]


def g2_neg(q: G2) -> G2:
    return G2(q.x, F2.neg(q.y))


def g2_select(mask, a: G2, b: G2) -> G2:
    return G2(F2.select(mask, a.x, b.x), F2.select(mask, a.y, b.y))


def g2_on_curve_plain(q: G2):
    """Plain PyTorch version of ``k_validate``'s G2 mode: y^2 == x^3 + 3/xi,
    bool [batch]."""
    y2 = F2.square(q.y)
    x3 = F2.mul(F2.square(q.x), q.x)
    rhs = F2.add(x3, F2.fp2_from_ints(TWIST_B, q.batch_shape, q.x.device))
    return F2.eq(y2, rhs)


def g2_on_curve(q: G2):
    """y^2 == x^3 + 3/xi: bool [batch]; a ``validate.g2_on_curve`` range
    holding one launch of ``k_validate``'s G2 mode on CUDA tensors
    (``ops.curve_kernels.g2_on_curve``), :func:`g2_on_curve_plain` on CPU
    ones."""
    from ..ops import curve_kernels as CK

    with record_function("validate.g2_on_curve"):
        return CK.g2_on_curve(q)


def g2_double_affine(q: G2) -> G2:
    """Affine doubling (one inversion): the reference-parity path."""
    lam = F2.mul(F2.scale(F2.square(q.x), 3), F2.inv(F2.scale(q.y, 2)))
    x3 = F2.sub(F2.square(lam), F2.scale(q.x, 2))
    y3 = F2.sub(F2.mul(lam, F2.sub(q.x, x3)), q.y)
    return G2(x3, y3)


def g2_add_affine(a: G2, b: G2) -> G2:
    """Affine unequal addition (one inversion)."""
    lam = F2.mul(F2.sub(b.y, a.y), F2.inv(F2.sub(b.x, a.x)))
    x3 = F2.sub(F2.sub(F2.square(lam), a.x), b.x)
    y3 = F2.sub(F2.mul(lam, F2.sub(a.x, x3)), a.y)
    return G2(x3, y3)


# ---------------------------------------------------------------------------
# Jacobian trajectory ops (a = 0 twist)
# ---------------------------------------------------------------------------


def jac_from_affine(q: G2) -> G2Jac:
    return G2Jac(q.x, q.y, F2.one_mont(q.batch_shape, q.x.device))


def jac_double(p: G2Jac) -> G2Jac:
    """dbl-2009-l (a=0): 2M + 5S."""
    A = F2.square(p.X)
    B = F2.square(p.Y)
    C = F2.square(B)
    t = F2.square(F2.add(p.X, B))
    D = F2.scale(F2.sub(F2.sub(t, A), C), 2)
    E = F2.scale(A, 3)
    Fv = F2.square(E)
    X3 = F2.sub(Fv, F2.scale(D, 2))
    Y3 = F2.sub(F2.mul(E, F2.sub(D, X3)), F2.scale(C, 8))
    Z3 = F2.scale(F2.mul(p.Y, p.Z), 2)
    return G2Jac(X3, Y3, Z3)


def jac_mixed_add(p: G2Jac, q: G2) -> G2Jac:
    """madd-2007-bl: Jacobian += affine; 7M + 4S.

    Assumes p != +-q (guaranteed along Miller trajectories of valid
    r-torsion inputs).
    """
    Z1Z1 = F2.square(p.Z)
    U2 = F2.mul(q.x, Z1Z1)
    S2 = F2.mul(F2.mul(q.y, p.Z), Z1Z1)
    H = F2.sub(U2, p.X)
    HH = F2.square(H)
    I = F2.scale(HH, 4)
    J = F2.mul(H, I)
    r = F2.scale(F2.sub(S2, p.Y), 2)
    V = F2.mul(p.X, I)
    X3 = F2.sub(F2.sub(F2.square(r), J), F2.scale(V, 2))
    Y3 = F2.sub(F2.mul(r, F2.sub(V, X3)), F2.scale(F2.mul(p.Y, J), 2))
    Z3 = F2.sub(F2.sub(F2.square(F2.add(p.Z, H)), Z1Z1), HH)
    return G2Jac(X3, Y3, Z3)


def jac_cap(p: G2Jac) -> G2Jac:
    return G2Jac(F2.cap(p.X), F2.cap(p.Y), F2.cap(p.Z))


def jac_select(mask, a: G2Jac, b: G2Jac) -> G2Jac:
    return G2Jac(
        F2.select(mask, a.X, b.X),
        F2.select(mask, a.Y, b.Y),
        F2.select(mask, a.Z, b.Z),
    )


def batch_to_affine(pts: G2Jac) -> G2:
    """Normalize a stack of Jacobian points (leading axis N: a trajectory,
    or any extra batch axis) to affine with one Fq inversion per lane.

    Montgomery's trick runs along axis 0 as Phase N of the Miller loop runs
    it: prefix products (kernel I), the Fq2 inverse of the total
    (``k_fq2_inv``), the running inverse (kernel J). CUDA tensors launch the
    kernels, CPU tensors take their plain versions."""
    from ..ops import fp_kernels as FPK
    from ..ops import norm_kernels as NK
    from ..ops.fq12_kernels import kfp2_view, kstack

    Z = F2.cap(pts.Z)
    n = Z.batch_shape[0]
    inner = Z.batch_shape[1:]
    flat = [F.Fp(c.limbs.reshape(n, -1, F.NLIMBS), c.bound, c.limb_bound) for c in (Z.c0, Z.c1)]
    z = kstack(flat).transpose(0, 1).contiguous()  # [N, 2, NLIMBS, B]
    prefix, total = NK.prefix_products(z)
    zinv_rows = NK.running_inverse(z, prefix, FPK.fp2_inv(total))
    view = kfp2_view(zinv_rows)  # batch [N, B]
    zinv = Fp2(*(F.Fp(c.limbs.reshape((n,) + tuple(inner) + (F.NLIMBS,)), c.bound, c.limb_bound)
                 for c in (view.c0, view.c1)))
    zinv2 = F2.square(zinv)
    zinv3 = F2.mul(zinv2, zinv)
    return G2(x=F2.mul(pts.X, zinv2), y=F2.mul(pts.Y, zinv3))


# ---------------------------------------------------------------------------
# Subgroup membership (input validation)
# ---------------------------------------------------------------------------

#: The signed digits of 6x^2, MSB first, the leading 1 consumed: the
#: [6x^2] Q ladder starts at Q (127 steps, 39 of them with an addition).
SUBGROUP_NAF = get_naf(6 * BN_X * BN_X)
assert SUBGROUP_NAF[-1] == 1
SUBGROUP_DIGITS = tuple(SUBGROUP_NAF[-2::-1])


def g2_in_subgroup(q: G2) -> torch.Tensor:
    """Exact r-torsion membership test: psi(Q) == [6x^2]Q, batched.

    The untwist-Frobenius endomorphism psi (``twisted_frobenius``) acts on
    G2 as multiplication by t-1 = 6x^2. Conversely any on-twist Q with
    psi(Q) = [6x^2]Q satisfies [(6x^2)^2 - t(6x^2) + p]Q = [p+1-t]Q =
    [#E(Fp)]Q = [r]Q = O (the BN G1 cofactor is 1), so the test accepts
    exactly the r-torsion.

    The ladder (double, then add +-Q on a nonzero digit, from Q) runs on
    kernel H's end-only mode (``ops.curve_kernels.trajectory_end``), the
    comparison X == psi(Q).x Z^2, Y == psi(Q).y Z^3, Z != 0 on
    ``k_validate``'s compare mode (``ops.curve_kernels.g2_subgroup_compare``,
    exact mod p) on CUDA tensors; CPU ones take their plain versions. The
    check is a ``validate.g2_subgroup`` range holding ``.ladder`` and
    ``.compare``.

    Preconditions: Q on the twist (``g2_on_curve``) and not infinity. For
    small-order Q the [6x^2] ladder can degenerate (mixed-add collision
    drives Z to 0); all such collapses are rejected by the Z != 0 term.
    Returns bool [batch].
    """
    from ..ops import curve_kernels as CK
    from ..ops.fq12_kernels import kstack

    with record_function("validate.g2_subgroup"):
        bs = q.batch_shape
        flat = [F.Fp(c.limbs.reshape(-1, F.NLIMBS), c.bound, c.limb_bound)
                for c in (q.x.c0, q.x.c1, q.y.c0, q.y.c1)]
        with record_function("validate.g2_subgroup.ladder"):
            end = CK.trajectory_end(kstack(flat), SUBGROUP_DIGITS)
        with record_function("validate.g2_subgroup.compare"):
            qf = G2(Fp2(flat[0], flat[1]), Fp2(flat[2], flat[3]))
            return CK.g2_subgroup_compare(qf, end).reshape(bs)


# ---------------------------------------------------------------------------
# Twisted Frobenius endomorphisms
# ---------------------------------------------------------------------------


def twisted_frobenius(q: G2) -> G2:
    """(c2 * conj(x), c3 * conj(y)) (miller_loop_native.rs:298-304)."""
    c2 = F2.fp2_from_ints(TWIST_C2, q.batch_shape, q.x.device)
    c3 = F2.fp2_from_ints(TWIST_C3, q.batch_shape, q.x.device)
    return G2(F2.mul(c2, F2.conj(q.x)), F2.mul(c3, F2.conj(q.y)))


def neg_twisted_frobenius(q: G2) -> G2:
    """(c2 * conj(x), c3 * neg_conj(y)) (miller_loop_native.rs:306-312)."""
    c2 = F2.fp2_from_ints(TWIST_C2, q.batch_shape, q.x.device)
    c3 = F2.fp2_from_ints(TWIST_C3, q.batch_shape, q.x.device)
    return G2(F2.mul(c2, F2.conj(q.x)), F2.mul(c3, F2.neg_conj(q.y)))
