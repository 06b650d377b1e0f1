"""Write the JAX side of the port's K-pair and witness tests.

Two files, both from the JAX package's XLA path (jitted, on the CPU):

* ``torch_multi_fixture.npz`` — ``multi_miller_loop`` and ``multi_pairing``
  at K = 2 and K = 4 pairs per product with an inner batch of 2, for the
  port's tests/test_torch_multi_pairing.py. Inputs and outputs are kept as
  canonical (fully reduced, non-Montgomery) 13-bit limbs.
* ``torch_witness_k2.npz`` — exactly what the JAX ``save_pairing_witness``
  writes for ``multi_pairing_witness`` at K = 2, inner batch 1, for
  tests/test_torch_witness.py.

The pairs are ``make_torch_fixtures.seeded_pairs`` (oracle multiples of the
generators by scalars from ``numpy.random.default_rng``), laid out
pair-major: pair ``k * B + b`` is pair k of product b. Regenerate from the
repository root with:

    JAX_PLATFORMS=cpu python tests/data/make_torch_multi_fixtures.py

(about ten minutes of CPU, nearly all of it compiling the JAX graphs).
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MULTI_OUT = os.path.join(HERE, "torch_multi_fixture.npz")
WITNESS_OUT = os.path.join(HERE, "torch_witness_k2.npz")
#: (K, inner batch) of each multi_pairing case.
MULTI_CASES = ((2, 2), (4, 2))
WITNESS_K, WITNESS_B = 2, 1
#: Every case takes the first K * B of these pairs.
N_PAIRS = max(K * B for K, B in MULTI_CASES)


def _pairs_module():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", os.path.join(HERE, "make_torch_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pairs():
    """The N_PAIRS seeded (G1, G2) pairs; the tests call this too."""
    mod = _pairs_module()
    return mod.seeded_pairs(mod.SEED, N_PAIRS)


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import jax

    jax.config.update("jax_platforms", "cpu")

    from pairing_tpu.curves import g1 as G1m
    from pairing_tpu.curves import g2 as G2m
    from pairing_tpu.fields import fp as F
    from pairing_tpu.fields import fp12 as F12
    from pairing_tpu.pairing import api, miller_loop
    from pairing_tpu.witness import save_pairing_witness
    from pairing_tpu.witness.trace import multi_pairing_witness

    def kb(tree, K, B):
        """batch [K*B] (pair-major) -> [K, B]"""
        return jax.tree.map(lambda a: a.reshape((K, B) + a.shape[1:]), tree)

    g1s, g2s = pairs()
    out = {
        "g1": np.stack([[F.int_to_limbs(x), F.int_to_limbs(y)] for x, y in g1s]),
        "g2": np.stack([[F.int_to_limbs(v) for v in (x[0], x[1], y[0], y[1])]
                        for x, y in g2s]),
    }
    for K, B in MULTI_CASES:
        n = K * B
        p = kb(G1m.g1_from_ints(g1s[:n]), K, B)
        q = kb(G2m.g2_from_ints(g2s[:n]), K, B)
        f = jax.jit(miller_loop.multi_miller_loop)(q, p)
        e = jax.jit(api.multi_pairing)(p, q)
        out[f"miller_k{K}"] = np.asarray(F12.fq12_to_canonical_limbs(f))
        out[f"pairing_k{K}"] = np.asarray(F12.fq12_to_canonical_limbs(e))
        print(f"K = {K}: done", flush=True)
    np.savez_compressed(MULTI_OUT, **out)
    print(f"wrote {MULTI_OUT}", flush=True)

    n = WITNESS_K * WITNESS_B
    p = kb(G1m.g1_from_ints(g1s[:n]), WITNESS_K, WITNESS_B)
    q = kb(G2m.g2_from_ints(g2s[:n]), WITNESS_K, WITNESS_B)
    res, trace = jax.jit(multi_pairing_witness)(p, q)
    save_pairing_witness(WITNESS_OUT, p, q, res, trace)
    print(f"wrote {WITNESS_OUT}", flush=True)


if __name__ == "__main__":
    main()
