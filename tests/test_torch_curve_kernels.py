"""Kernel H's plain version (the Miller loop's point trajectory, Phase B)
against the JAX package and the oracle.

``ops.curve_kernels.trajectory`` on CPU tensors takes its plain version. Its
loop tops, post-doubles and end state must equal those of the JAX package's
XLA-path ``miller_loop._trajectory`` exactly (canonical values; both run the
same Jacobian formulas, so even the projective representatives agree), and
the end state must be [6u + 2] Q by the oracle.
"""

import numpy as np
import pytest
import torch

from pairing_tpu.curves import g2 as JG2
from pairing_tpu.pairing import miller_loop as JML
from pairing_tpu_torch.curves import g2 as TG2
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields import fp2 as F2
from pairing_tpu_torch.ops import curve_kernels as CK
from pairing_tpu_torch.ops import fq12_kernels as FK
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.pairing import miller_loop as ML
from pairing_tpu_torch.utils import bn254 as c

torch.set_num_threads(2)

RINV = pow(TF.R_MONT, -1, c.P)


def rows_ints(arr: torch.Tensor) -> np.ndarray:
    """Rows [..., 21, B] -> ints mod p (out of Montgomery form), [..., B]."""
    can = FK.kf12_canonical(arr).transpose(-1, -2).contiguous()
    vals = [TF.limbs_to_int(r) * RINV % c.P for r in can.reshape(-1, TF.NLIMBS).numpy()]
    return np.asarray(vals, dtype=object).reshape(tuple(can.shape[:-1]))


def jax_jac_rows(jac) -> torch.Tensor:
    """JAX (X, Y, Z) limb pytree, each (c0, c1) [*lead, B, 21] -> [*lead, 6, 21, B]."""
    comps = np.stack([np.asarray(x) for coord in jac for x in coord], axis=-3)
    return torch.as_tensor(np.ascontiguousarray(np.swapaxes(comps, -1, -2)))


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(401)
    ks = [int.from_bytes(rng.bytes(32), "little") % (c.R_SCALAR - 1) + 1 for _ in range(3)]
    return [o.g2_mul((c.G2_GEN_X, c.G2_GEN_Y), k) for k in ks]


def test_trajectory_plain_matches_jax_and_oracle(points):
    q = TG2.g2_from_ints(points, "cpu")
    q_rows = FK.kstack([q.x.c0, q.x.c1, q.y.c0, q.y.c1])
    tops, dbls, end = CK.trajectory(q_rows, ML.STEP_DIGITS)  # CPU tensors: plain
    B = len(points)
    assert tuple(tops.shape) == tuple(dbls.shape) == (ML.N_STEPS, 6, TF.NLIMBS, B)
    assert tuple(end.shape) == (6, TF.NLIMBS, B)
    for arr in (tops, dbls, end):
        assert FK.kf12_in_envelope(arr)

    jtops, jdbls, jend = JML._trajectory(JG2.g2_from_ints(points))
    assert (rows_ints(tops) == rows_ints(jax_jac_rows(jtops))).all()
    assert (rows_ints(dbls) == rows_ints(jax_jac_rows(jdbls))).all()
    assert (rows_ints(end) == rows_ints(jax_jac_rows(jend))).all()

    # end = [6u + 2] Q: x = X / Z^2, y = Y / Z^3
    e = rows_ints(end)
    six_u_plus_2 = sum(d << i for i, d in enumerate(c.SIX_U_PLUS_2_NAF))
    for lane, pt in enumerate(points):
        X, Y, Z = ((e[2 * k, lane], e[2 * k + 1, lane]) for k in range(3))
        zi = c.fq2_inv(Z)
        zi2 = c.fq2_mul(zi, zi)
        want = o.g2_mul(pt, six_u_plus_2)
        assert (c.fq2_mul(X, zi2), c.fq2_mul(Y, c.fq2_mul(zi2, zi))) == want


def test_jac_rows_roundtrip():
    q = TG2.g2_from_ints([((1, 2), (3, 4)), ((5, 6), (7, 8))], "cpu")
    rows = CK.jac_rows(TG2.jac_from_affine(q))
    assert tuple(rows.shape) == (6, TF.NLIMBS, 2)
    back = CK.jac_view(rows)
    assert torch.equal(CK.jac_rows(back), rows)
    assert rows_ints(rows)[:, 0].tolist() == [1, 2, 3, 4, 1, 0]


# ---------------------------------------------------------------------------
# The two-thread split of kernel H (csrc/trajectory.cu), modelled with the
# field library. The kernel gives each lane two threads, ranks h = 0, 1;
# rank h computes component h of every Fq2 value of a step: of a product,
# its two Fq limb products summed unreduced and reduced once; of a square,
# one product; of a linear operation, the operation on component h alone.
# A value that a later product or square reads whole is published (both
# components) at a barrier; a value that only its own component's
# arithmetic reads stays with its rank. Here each rank's components are
# computed on their own, in the kernel's stages, and only published values
# (whole Fp2) reach a product or square, so the model checks the algebra of
# the partition and what each stage reads, not the kernel's shared-memory
# slots or its 32-bit columns: the card tests hold the kernel itself to
# trajectory_plain, and the kernel's source gives the bound that keeps its
# columns below 2^32.
# ---------------------------------------------------------------------------

RANKS = (0, 1)


def mul_part(a, b, h: int):
    """Component h of F2.mul(a, b): c0 = a0 b0 + a1 (-b1), c1 = a0 b1 + a1
    b0, two limb products summed and reduced once."""
    ys = (b.c0, TF.fp_neg(b.c1)) if h == 0 else (b.c1, b.c0)
    return TF.mont_reduce(TF.wide_add(TF.mul_wide(a.c0, ys[0]), TF.mul_wide(a.c1, ys[1])))


def sq_part(a, h: int):
    """Component h of F2.square(a): (a0 + a1)(a0 - a1), or (2 a0) a1."""
    if h == 0:
        return TF.mont_reduce(TF.mul_wide(TF.fp_add(a.c0, a.c1), TF.fp_sub(a.c0, a.c1)))
    return TF.mont_reduce(TF.mul_wide(TF.fp_scale(a.c0, 2), a.c1))


def comp(a, h: int):
    return a.c1 if h else a.c0


def publish(parts):
    """Both ranks' components of one value, after a barrier."""
    return F2.Fp2(*parts)


def double_by_ranks(p: TG2.G2Jac) -> TG2.G2Jac:
    """jac_double in the kernel's three stages."""
    X, Y, Z = p.X, p.Y, p.Z
    # stage 1: A, E = 3A, B = Y^2, Z3 = 2 Y Z; B and E published
    A = [sq_part(X, h) for h in RANKS]
    E = publish([TF.fp_scale(A[h], 3) for h in RANKS])
    B = publish([sq_part(Y, h) for h in RANKS])
    Z3 = [TF.fp_scale(mul_part(Y, Z, h), 2) for h in RANKS]
    # stage 2: C = B^2, D = 2((X + B)^2 - A - C), X3 = E^2 - 2D; W = D - X3 published
    C = [sq_part(B, h) for h in RANKS]
    XB = F2.add(X, B)  # each rank adds both components before its square
    D = [TF.fp_scale(TF.fp_sub(TF.fp_sub(sq_part(XB, h), A[h]), C[h]), 2) for h in RANKS]
    X3 = [TF.fp_sub(sq_part(E, h), TF.fp_scale(D[h], 2)) for h in RANKS]
    W = publish([TF.fp_sub(D[h], X3[h]) for h in RANKS])
    # stage 3: Y3 = E W - 8C
    Y3 = [TF.fp_sub(mul_part(E, W, h), TF.fp_scale(C[h], 8)) for h in RANKS]
    return TG2.G2Jac(publish(X3), publish(Y3), publish(Z3))


def mixed_add_by_ranks(p: TG2.G2Jac, q: TG2.G2) -> TG2.G2Jac:
    """jac_mixed_add in the kernel's five stages; Q is read whole from
    device memory."""
    X, Y, Z = p.X, p.Y, p.Z
    # stage 1: Z1Z1 = Z^2, T = qy Z, both published
    Z1Z1 = publish([sq_part(Z, h) for h in RANKS])
    T = publish([mul_part(q.y, Z, h) for h in RANKS])
    # stage 2: H = qx Z1Z1 - X, rr = 2(T Z1Z1 - Y), both published
    H = publish([TF.fp_sub(mul_part(q.x, Z1Z1, h), comp(X, h)) for h in RANKS])
    rr = publish([TF.fp_scale(TF.fp_sub(mul_part(T, Z1Z1, h), comp(Y, h)), 2) for h in RANKS])
    # stage 3: Z3 = (Z + H)^2 - Z1Z1 - HH; I = 4 HH published; rr^2 kept
    ZH = F2.add(Z, H)
    HH = [sq_part(H, h) for h in RANKS]
    Z3 = [TF.fp_sub(TF.fp_sub(sq_part(ZH, h), comp(Z1Z1, h)), HH[h]) for h in RANKS]
    I = publish([TF.fp_scale(HH[h], 4) for h in RANKS])
    rr2 = [sq_part(rr, h) for h in RANKS]
    # stage 4: J = H I published, V = X I; X3 = rr^2 - J - 2V; W = V - X3 published
    J = publish([mul_part(H, I, h) for h in RANKS])
    V = [mul_part(X, I, h) for h in RANKS]
    X3 = [TF.fp_sub(TF.fp_sub(rr2[h], comp(J, h)), TF.fp_scale(V[h], 2)) for h in RANKS]
    W = publish([TF.fp_sub(V[h], X3[h]) for h in RANKS])
    # stage 5: Y3 = rr W - 2 Y J
    Y3 = [TF.fp_sub(mul_part(rr, W, h), TF.fp_scale(mul_part(Y, J, h), 2)) for h in RANKS]
    return TG2.G2Jac(publish(X3), publish(Y3), publish(Z3))


def trajectory_by_ranks(q_arr: torch.Tensor, digits):
    """trajectory_plain's loop over the two-rank model of each step."""
    q = TG2.G2(FK.kfp2_view(q_arr[0:2]), FK.kfp2_view(q_arr[2:4]))
    nq = TG2.G2(q.x, F2.cap(F2.neg(q.y)))
    cur = TG2.jac_cap(TG2.jac_from_affine(q))
    tops, dbls = [], []
    for d in digits:
        tops.append(CK.jac_rows(cur))
        dbl = TG2.jac_cap(double_by_ranks(cur))
        dbls.append(CK.jac_rows(dbl))
        cur = TG2.jac_cap(mixed_add_by_ranks(dbl, q if d > 0 else nq)) if d else dbl
    return torch.stack(tops), torch.stack(dbls), CK.jac_rows(cur)


#: A digit string with runs of +-1 and of 0, beside the Miller loop's own.
RUN_DIGITS = [1, 1, -1, -1, 0, 0, 0, 1, -1, 0, 1, 1, 1, 0, -1, -1, -1, 0, 0, 1]


@pytest.mark.parametrize("case", ["miller_points", "runs_random"])
def test_two_rank_split_matches_trajectory_plain(points, case):
    """Kernel H's split of every step over two ranks, limb for limb against
    trajectory_plain (held to the JAX package's _trajectory above): the
    Miller loop's 64 steps on seeded G2 points, and a digit string with
    runs of +-1 and 0 on seeded operands below 2p with settled limbs."""
    if case == "miller_points":
        q = TG2.g2_from_ints(points, "cpu")
        q_rows, digits = FK.kstack([q.x.c0, q.x.c1, q.y.c0, q.y.c1]), list(ML.STEP_DIGITS)
    else:
        gen = torch.Generator().manual_seed(402)
        q_rows, digits = FK.random_kf12((4,), 5, gen), RUN_DIGITS
    got = trajectory_by_ranks(q_rows, digits)
    want = CK.trajectory_plain(q_rows, digits)
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
