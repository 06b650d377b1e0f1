"""Write ``torch_validate_fixture.npz``: the JAX package's validation
helpers on seeded inputs, for the PyTorch port's tests
(tests/test_torch_validate.py).

The inputs (``seeded_inputs``, which the test calls too) are four lanes:
Fq values a, b, c and a mask; Fq2 values x, y; Fq12 values f, g; G1 points
(two on the curve, (5, 5), (0, 0)) and G2 points (on the twist in G2, on
the twist outside it, two more in G2), as tests/test_validate.py chooses
them. They go through the JAX package's field, curve and API helpers on its
XLA path (on the CPU; the scans jitted): ``fp_select``, ``fp_eq``,
``fp_is_zero``, ``batch_inv``; Fq2 ``select``, ``eq``; ``fq12_from_sparse``,
``fq12_select``, ``fq12_eq``, ``fq12_div``; ``g1_neg``, ``g1_on_curve``;
``g2_select``, ``g2_on_curve``, ``g2_double_affine``, ``g2_add_affine``,
``jac_select``, ``batch_to_affine`` (over three Jacobian states a lane:
Q, 2Q, 2Q + Q), ``g2_in_subgroup`` and ``validate_inputs`` with and
without the subgroup check.

Each field result is kept twice: ``<name>`` the canonical digits of its
value (fully reduced, still Montgomery), and ``raw_<name>`` the limbs the
XLA path left. Layouts: an Fq [B, 21]; an Fq2 [2, B, 21] (c0, c1); an
Fq12 [12, B, 21] (slot 0's c0, c1, slot 1's ...); a G2 point [4, B, 21];
a G1 point [2, B, 21]; a Jacobian G2 point [6, ..., B, 21]. Masks are
bool [B]. The inputs are kept the same way as ``in_<name>``.

Regenerate from the repository root with:

    JAX_PLATFORMS=cpu python tests/data/make_torch_validate_fixtures.py

(about two minutes of CPU, most of it compiling the scans).
"""

from __future__ import annotations

import os
import sys

import numpy as np

SEED = 20261018
N_LANES = 4
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_validate_fixture.npz")


def seeded_inputs(seed: int = SEED, n: int = N_LANES) -> dict:
    """Host ints of every input (the test calls this too): ``fp_*`` lists
    of n ints, ``mask`` n bools, ``fp2_*`` n (c0, c1) pairs, ``fq12_*`` n
    lists of 12 coefficients, ``g1`` / ``g2`` n points. b equals a in
    lanes 0 and 2, c is 0 in lane 3, y equals x and g equals f in lane 0."""
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.utils import bn254 as c

    rng = np.random.default_rng(seed)

    def fq():
        return int.from_bytes(rng.bytes(40), "little") % c.P

    def scalar():
        return int.from_bytes(rng.bytes(32), "little") % (c.R_SCALAR - 1) + 1

    a = [fq() for _ in range(n)]
    b = [a[i] if i % 2 == 0 else fq() for i in range(n)]  # see fp_b_limbs
    cc = [fq() for _ in range(n - 1)] + [0]
    x = [(fq(), fq()) for _ in range(n)]
    y = [x[0]] + [(fq(), fq()) for _ in range(n - 1)]
    f = [[fq() for _ in range(12)] for _ in range(n)]
    g = [f[0]] + [[fq() for _ in range(12)] for _ in range(n - 1)]
    g2gen = (c.G2_GEN_X, c.G2_GEN_Y)
    bad_q = next(pt for pt in (o.g2_point_from_x((x0, 1)) for x0 in range(1, 200))
                 if pt is not None and not o.g2_in_subgroup(pt))
    good_g1 = [o.g1_mul(c.G1_GEN, scalar()) for _ in range(2)]
    good_g2 = [o.g2_mul(g2gen, scalar()) for _ in range(3)]
    return {
        "fp_a": a, "fp_b": b, "fp_c": cc, "mask": [True, False, False, True][:n],
        "fp2_x": x, "fp2_y": y, "fq12_f": f, "fq12_g": g,
        "g1": [good_g1[0], good_g1[1], (5, 5), (0, 0)][:n],
        "g2": [good_g2[0], bad_q, good_g2[1], good_g2[2]][:n],
    }


def fp_b_limbs(ins) -> np.ndarray:
    """b's limbs [n, 21]: Montgomery canonical digits, plus p in the lanes
    where b equals a (another representative below 2p). The test calls
    this too."""
    from pairing_tpu_torch.fields.fp import R_MONT, int_to_limbs
    from pairing_tpu_torch.utils.bn254 import P

    return np.stack([int_to_limbs(v * R_MONT % P + (P if i % 2 == 0 else 0))
                     for i, v in enumerate(ins["fp_b"])])


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(OUT))))
    import jax
    import jax.numpy as jnp

    from pairing_tpu.curves import g1 as G1m
    from pairing_tpu.curves import g2 as G2m
    from pairing_tpu.fields import fp as F
    from pairing_tpu.fields import fp2 as F2
    from pairing_tpu.fields import fp12 as F12
    from pairing_tpu.fields.fp2 import Fp2
    from pairing_tpu.pairing import api

    jax.config.update("jax_platforms", "cpu")
    ins = seeded_inputs()
    out = {}

    def rows_of(v):
        if isinstance(v, F.Fp):
            return [v]
        if isinstance(v, Fp2):
            return [v.c0, v.c1]
        if isinstance(v, F12.Fq12):
            return [c for s in v.s for c in (s.c0, s.c1)]
        if isinstance(v, G1m.G1):
            return [v.x, v.y]
        if isinstance(v, G2m.G2):
            return [c for w in (v.x, v.y) for c in (w.c0, w.c1)]
        return [c for w in (v.X, v.Y, v.Z) for c in (w.c0, w.c1)]

    def keep(name, v, raw=True):
        rows = rows_of(v)
        out[name] = np.stack([np.asarray(F.canonical(r).limbs) for r in rows])
        if raw:
            out["raw_" + name] = np.stack([np.asarray(r.limbs) for r in rows])
        return v

    a = keep("in_fp_a", F.fp_from_ints_mont(ins["fp_a"]))
    b = keep("in_fp_b", F.Fp(jnp.asarray(fp_b_limbs(ins)), 2 * F.P, F.MASK))
    c = keep("in_fp_c", F.fp_from_ints_mont(ins["fp_c"]))
    mask = jnp.asarray(ins["mask"])
    keep("fp_select", F.fp_select(mask, a, b))
    out["fp_eq"] = np.asarray(F.fp_eq(a, b))
    out["fp_is_zero"] = np.asarray(F.fp_is_zero(c))
    for i, v in enumerate(jax.jit(F.batch_inv)((a, b, F.fp_select(mask, a, b)))):
        keep(f"batch_inv_{i}", v, raw=False)

    x = keep("in_fp2_x", F2.fp2_stack_from_ints(ins["fp2_x"]))
    y = keep("in_fp2_y", F2.fp2_stack_from_ints(ins["fp2_y"]))
    keep("fp2_select", F2.select(mask, x, y))
    out["fp2_eq"] = np.asarray(F2.eq(x, y))

    f = keep("in_fq12_f", F12.fq12_from_int_coeffs(ins["fq12_f"]))
    g = keep("in_fq12_g", F12.fq12_from_int_coeffs(ins["fq12_g"]))
    keep("fq12_from_sparse", F12.fq12_from_sparse({0: x, 3: y, 4: x}, x.batch_shape))
    keep("fq12_select", F12.fq12_select(mask, f, g))
    out["fq12_eq"] = np.asarray(F12.fq12_eq(f, g))
    keep("fq12_div", jax.jit(F12.fq12_div)(f, g), raw=False)

    p = keep("in_g1", G1m.g1_from_ints(ins["g1"]))
    q = keep("in_g2", G2m.g2_from_ints(ins["g2"]))
    keep("g1_neg", G1m.g1_neg(p))
    out["g1_on_curve"] = np.asarray(G1m.g1_on_curve(p))
    keep("g2_select", G2m.g2_select(mask, q, G2m.g2_neg(q)))
    out["g2_on_curve"] = np.asarray(G2m.g2_on_curve(q))
    keep("g2_double_affine", jax.jit(G2m.g2_double_affine)(q), raw=False)
    q_rot = G2m.g2_from_ints(ins["g2"][1:] + ins["g2"][:1])
    keep("g2_add_affine", jax.jit(G2m.g2_add_affine)(q, q_rot), raw=False)

    r0 = G2m.jac_from_affine(q)
    r1 = G2m.jac_double(r0)
    r2 = G2m.jac_mixed_add(r1, q)
    keep("jac_select", G2m.jac_select(mask, r1, r2))
    stack = G2m.G2Jac(*(
        Fp2(*(F.Fp(jnp.stack([getattr(getattr(r, w), cc).limbs for r in (r0, r1, r2)]),
                   max(getattr(getattr(r, w), cc).bound for r in (r0, r1, r2)),
                   max(getattr(getattr(r, w), cc).limb_bound for r in (r0, r1, r2)))
              for cc in ("c0", "c1")))
        for w in ("X", "Y", "Z")))
    keep("in_jac_stack", stack)
    keep("batch_to_affine", jax.jit(G2m.batch_to_affine)(stack), raw=False)
    out["g2_in_subgroup"] = np.asarray(jax.jit(G2m.g2_in_subgroup)(q))
    out["validate_inputs"] = np.asarray(jax.jit(api.validate_inputs)(p, q))
    out["validate_inputs_no_subgroup"] = np.asarray(
        jax.jit(lambda p, q: api.validate_inputs(p, q, subgroup_check=False))(p, q))
    np.savez_compressed(OUT, seed=np.int64(SEED), **out)
    print(f"wrote {OUT}: {sorted(out)}")


if __name__ == "__main__":
    main()
