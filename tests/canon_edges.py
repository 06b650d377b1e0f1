"""Seeded edge operands for holding ``k_canonical`` (``csrc/canonical.cu``)
to its plain versions; shared by ``test_torch_canon_kernels.py`` (the numpy
model, on the CPU) and ``test_torch_cuda.py`` (the card)."""

from typing import Dict

import numpy as np
import torch

from pairing_tpu_torch.fields import fp as F
from pairing_tpu_torch.fields.fp import Fp
from pairing_tpu_torch.ops.fq12_kernels import random_kf12
from pairing_tpu_torch.utils.bn254 import P


#: Values the first lanes of :func:`edge_operands`' families hold (below 2p).
EDGE_VALUES = (0, 1, P - 2, P - 1, P, P + 1, 2 * P - 2, 2 * P - 1)


def edge_operands(lanes: int, generator: torch.Generator) -> Dict[str, Fp]:
    """Seeded operands of batch [lanes] on the generator's device, for
    holding ``k_canonical`` to its plain version, by family:

      ``below_2p``    values below 2p with settled limbs (2^13 and 2^13 + 1
                      occur; ``fq12_kernels.random_kf12``), the first lanes
                      :data:`EDGE_VALUES`;
      ``lazy_sum``    sums of four such values: bound 8p, limbs above 2^13 + 1;
      ``wide_limbs``  such values times 65,000, not carried: limbs up to
                      5.3e8, bound 130,000 p (17 steps);
      ``most_steps``  their digits times 2^18 + 1, carried: bound above
                      p 2^19 (20 steps);
      ``difference``  ``fp_sub`` of two such values (bound 4p);
      ``curve_rhs``   x^3 + 3 as ``g1_on_curve`` forms it (bound above 2p);
      ``signed``      ``below_2p`` with one limb a lane lowered by 2^13 and
                      the limb above raised by 1 (the same value): negative
                      limbs, which the signed carry resolves.
    """
    def below_2p() -> Fp:
        return Fp(random_kf12((), lanes, generator).transpose(0, 1).contiguous(), 2 * P,
                  F.SETTLED)

    base = below_2p()
    k = min(lanes, len(EDGE_VALUES))
    edges = np.stack([F.int_to_limbs(v) for v in EDGE_VALUES[:k]])
    base.limbs[:k] = torch.as_tensor(edges, device=generator.device)
    digits = Fp(F._ripple_carry(base.limbs)[0], 2 * P, F.MASK)
    lazy = base
    for _ in range(3):
        lazy = F.fp_add(lazy, below_2p())
    cube = F.mont_mul(F.mont_mul(base, base), base)
    pos = torch.randint(0, F.NLIMBS - 1, (lanes, 1), generator=generator, device=generator.device)
    idx = torch.arange(F.NLIMBS, device=generator.device)
    signed = base.limbs - F.RADIX * (idx == pos).to(F.DTYPE) + (idx == pos + 1).to(F.DTYPE)
    return {
        "below_2p": base,
        "lazy_sum": lazy,
        "wide_limbs": F.fp_scale(base, 65000),
        "most_steps": F.fp_scale(digits, (1 << 18) + 1),
        "difference": F.fp_sub(base, below_2p()),
        "curve_rhs": F.fp_add(cube, F.fp_const_mont(3, (lanes,), generator.device)),
        "signed": Fp(signed, 2 * P, F.SETTLED + 1),
    }
