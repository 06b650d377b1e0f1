"""Write ``torch_final_exp_fixture.npz``: the JAX package's final
exponentiation pieces and Fq12 powers, for the PyTorch port's tests
(tests/test_torch_final_exp.py).

Four seeded lanes of a random Fq12 ``a`` (coefficients drawn from
``numpy.random.default_rng(SEED)``) and two random lines go through the JAX
package's XLA path (jitted, on the CPU): ``easy_part(a)``; with m that
result, ``pow_x_cyclotomic(m)`` and ``hard_part(m)``; ``final_exp(a)``;
``fq12_sq(a)``, ``fq12_pow(a, POW_E)`` and ``fq12_mul_sparse`` of ``a`` by
the line of each shape, (0, 3, 4) and (2, 3, 5). Every value is kept as
canonical (fully reduced, non-Montgomery) 13-bit limbs [4, 12, 21], so the
test needs no JAX compile, and also as the XLA path left them,
``raw_<name>``: the Montgomery-domain limbs of its own representative, not
reduced to canonical form, in the same [4, 12, 21] order (row i slot i's
c0, row i + 6 its c1), for the raw-limb comparisons of the port's functions
that run the same operation sequence.

Regenerate from the repository root with:

    JAX_PLATFORMS=cpu python tests/data/make_torch_final_exp_fixtures.py

(a few minutes of CPU, nearly all of it compiling the JAX functions).
"""

from __future__ import annotations

import os
import sys

import numpy as np

SEED = 20261017
N_LANES = 4
POW_E = 0b101101110101  # its NAF has -1 digits
LINE_SHAPES = {"034": (0, 3, 4), "235": (2, 3, 5)}
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_final_exp_fixture.npz")


def seeded_inputs(seed: int = SEED, n: int = N_LANES):
    """(a, lines): n random Fq12 coefficient lists, and per line shape n
    lists of 12 coefficients that are zero outside the shape's slots (slot
    j is coefficients j and j + 6). The test calls this too."""
    from pairing_tpu.utils.bn254 import P

    rng = np.random.default_rng(seed)

    def coeff():
        return int.from_bytes(rng.bytes(40), "little") % P

    a = [[coeff() for _ in range(12)] for _ in range(n)]
    lines = {}
    for name, slots in LINE_SHAPES.items():
        rows = []
        for _ in range(n):
            row = [0] * 12
            for j in slots:
                row[j], row[j + 6] = coeff(), coeff()
            rows.append(row)
        lines[name] = rows
    return a, lines


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(OUT))))
    import jax

    from pairing_tpu.fields import fp12 as F12
    from pairing_tpu.pairing import final_exp as FE

    jax.config.update("jax_platforms", "cpu")
    a_ints, lines = seeded_inputs()
    a = F12.fq12_from_int_coeffs(a_ints)
    out = {}

    def keep(name, x):
        out[name] = np.asarray(F12.fq12_to_canonical_limbs(x))
        out["raw_" + name] = np.stack(
            [np.asarray(s.c0.limbs) for s in x.s] + [np.asarray(s.c1.limbs) for s in x.s],
            axis=-2)
        return x

    keep("a", a)
    m = keep("easy_part", jax.jit(FE.easy_part)(a))
    keep("pow_x_cyclotomic", jax.jit(FE.pow_x_cyclotomic)(m))
    keep("hard_part", jax.jit(FE.hard_part)(m))
    keep("final_exp", jax.jit(FE.final_exp)(a))
    keep("fq12_sq", jax.jit(F12.fq12_sq)(a))
    keep("fq12_pow", jax.jit(lambda x: FE.fq12_pow(x, POW_E))(a))
    for name, slots in LINE_SHAPES.items():
        line = keep("line_" + name, F12.fq12_from_int_coeffs(lines[name]))
        prod = jax.jit(lambda x, y, s=slots: F12.fq12_mul_sparse(x, {j: y.s[j] for j in s}))
        keep("mul_sparse_" + name, prod(a, line))
    np.savez_compressed(OUT, seed=np.int64(SEED), pow_e=np.int64(POW_E), **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
