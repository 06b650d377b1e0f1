"""The final exponentiation's other routes and the Fq12 powers, on the CPU.

The JAX side comes from ``tests/data/torch_final_exp_fixture.npz``, written
by ``tests/data/make_torch_final_exp_fixtures.py`` (the JAX package's jitted
XLA path on 4 seeded lanes; a few minutes of CPU to regenerate, so it is
checked in). On CPU tensors every kernel takes its plain version: K17 under
``pow_x_cyclotomic`` and ``hard_part``, K16, K15 (``hard_chain_plain``), K18
under ``fq12_sq`` and ``fq12_pow``, kernel A's sparse mode, G under
``easy_part``. Comparison is exact on canonical limbs, against the fixture
and the port's pure-integer oracle, and on raw limbs against the fixture's
``raw_*`` arrays: the Montgomery-domain limbs that the XLA path left, before
any reduction to canonical form. Every function here runs the XLA path's
operation sequence on the CPU (the kernels' plain versions repeat the field
library's lazy sums), so the representatives agree limb for limb, not only
the values. Where the two legitimately differ:

* the CUDA kernels reduce every Fq sum and difference below 2p
  (``csrc/field.cuh``: ``fp_add`` and ``fp_sub`` subtract 2p when the
  result reaches it), where the field library keeps them lazy, below 4p
  or more, and reduces only in the Montgomery reduction; a Montgomery
  product of two representatives of one value may then differ by p. So
  the card's tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py``
  compare canonical values;
* ``fq12_pow`` for e = 2, 5, 7 and the fused chain's inputs have no XLA
  fixture: they are held to the oracle (canonical) and, for e = 1 and the
  fused chain, to the port's own raw limbs.

A plain ladder costs seconds even on one lane, so the ladder tests take one
lane, ``hard_part``'s test lets the oracle stand in for its three ladders,
and the whole final exponentiation runs on one lane.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from pairing_tpu_torch.fields import fp2 as TF2
from pairing_tpu_torch.fields import fp12 as TF12
from pairing_tpu_torch.fields.fp12 import fq12_to_canonical_limbs
from pairing_tpu_torch.ops import dispatch
from pairing_tpu_torch.ops import fq12_kernels as FK
from pairing_tpu_torch.ops import fused_kernels as FU
from pairing_tpu_torch.ops import klayout as KL
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.pairing import final_exp as FE
from pairing_tpu_torch.utils import bn254 as c

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(scope="module")
def fx():
    spec = importlib.util.spec_from_file_location(
        "make_torch_final_exp_fixtures", DATA / "make_torch_final_exp_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    data = dict(np.load(DATA / "torch_final_exp_fixture.npz"))
    assert int(data["seed"]) == mod.SEED and int(data["pow_e"]) == mod.POW_E
    a_ints, lines = mod.seeded_inputs()
    # the fixture was made from these very values
    assert TF12.fq12_limbs_to_int_coeffs(data["a"]) == a_ints
    for name in mod.LINE_SHAPES:
        assert TF12.fq12_limbs_to_int_coeffs(data["line_" + name]) == lines[name]
        assert raw(port(lines[name])) == data["raw_line_" + name].tolist()
    assert raw(port(a_ints)) == data["raw_a"].tolist()
    return mod, data, a_ints, lines


def ints(arr) -> list:
    return TF12.fq12_limbs_to_int_coeffs(arr)


def canon(x: TF12.Fq12) -> list:
    """Canonical limbs of an Fq12 in the (2p, settled) envelope."""
    for s in x.s:
        for comp in (s.c0, s.c1):
            assert int(comp.limbs.min()) >= 0 and int(comp.limbs.max()) <= 8193
    return fq12_to_canonical_limbs(x).numpy().tolist()


def raw(x: TF12.Fq12) -> list:
    """Raw Montgomery-domain limbs [B, 12, 21] in the fixture's order: row i
    slot i's c0, row i + 6 its c1."""
    comps = [s.c0.limbs for s in x.s] + [s.c1.limbs for s in x.s]
    return torch.stack(torch.broadcast_tensors(*comps), dim=-2).numpy().tolist()


def kf12_raw(arr: torch.Tensor) -> list:
    return raw(FK.from_kernel_layout(arr, (arr.shape[-1],)))


def port(coeffs) -> TF12.Fq12:
    return TF12.fq12_from_int_coeffs(coeffs, "cpu")


def kf12(coeffs) -> torch.Tensor:
    return FK.to_kernel_layout(port(coeffs))[0]


def kf12_canon(arr: torch.Tensor) -> list:
    assert FK.kf12_in_envelope(arr)
    return canon(FK.from_kernel_layout(arr, (arr.shape[-1],)))


def test_easy_part_matches_jax_and_oracle(fx):
    _, data, a, _ = fx
    got = FE.easy_part(port(a[:2]))
    assert canon(got) == data["easy_part"][:2].tolist()
    assert raw(got) == data["raw_easy_part"][:2].tolist()
    assert TF12.fq12_to_int_coeffs(got) == [o.easy_part(x) for x in a[:2]]


def test_pow_x_cyclotomic_is_k17_and_matches_jax(fx, monkeypatch):
    _, data, _, _ = fx
    m = ints(data["easy_part"][:1])
    calls = []

    def spy(arr, digits):
        calls.append(list(digits))
        return FU.pow_ladder_w4(arr, digits)

    monkeypatch.setattr(FE, "pow_ladder_w4", spy)
    got = FE.pow_x_cyclotomic(port(m))
    assert calls == [FU.BN_X_W4_DIGITS.tolist()]
    assert canon(got) == data["pow_x_cyclotomic"][:1].tolist()
    assert raw(got) == data["raw_pow_x_cyclotomic"][:1].tolist()
    assert TF12.fq12_to_int_coeffs(got) == [o.pow_fq12(x, c.BN_X) for x in m]


def test_hard_part_matches_jax_and_oracle(fx, monkeypatch):
    """hard_part's three K17 ladders, chained, then the chain. K17's plain
    version is held to m^BN_X above; here the oracle stands in for it (a
    plain ladder costs seconds), so the test checks the wiring: three
    ladders over BN_X_W4_DIGITS, each fed the one before."""
    _, data, _, _ = fx
    m = ints(data["easy_part"][:2])
    fed = []

    def oracle_ladder(arr, digits):
        assert list(digits) == FU.BN_X_W4_DIGITS.tolist()
        x = ints(kf12_canon(arr))
        fed.append(x)
        return kf12([o.pow_fq12(v, c.BN_X) for v in x])

    monkeypatch.setattr(FE, "pow_ladder_w4", oracle_ladder)
    got = FE.hard_part(port(m))
    powers = [m]
    for _ in range(2):
        powers.append([o.pow_fq12(v, c.BN_X) for v in powers[-1]])
    assert fed == powers
    assert canon(got) == data["hard_part"][:2].tolist()
    # the oracle's powers enter as canonical representatives; on these lanes
    # the XLA ladders' outputs lead the chain to the same limbs
    assert raw(got) == data["raw_hard_part"][:2].tolist()
    assert TF12.fq12_to_int_coeffs(got) == [o.hard_part(x) for x in m]
    # the split final exponentiation is the final exponentiation
    assert data["hard_part"].tolist() == data["final_exp"].tolist()


def test_pow_ladder_plain_naf_matches_jax(fx):
    """K16 over BN_X's NAF: m^BN_X, as the JAX package's pow_x_cyclotomic."""
    _, data, _, _ = fx
    m = kf12(ints(data["easy_part"][1:2]))
    got = FU.pow_ladder(m, KL.kconj(m), FU.BN_X_LADDER_DIGITS)
    assert kf12_canon(got) == data["pow_x_cyclotomic"][1:2].tolist()
    assert kf12_raw(got) == data["raw_pow_x_cyclotomic"][1:2].tolist()


def test_hard_chain_plain_equals_unfused_chain(monkeypatch):
    """K15's register program against the 29-operation chain, on
    cyclotomic-subgroup inputs; ``fused`` picks the form, and on CPU
    operands PAIRING_FUSED_CHAIN is ignored."""
    rng = np.random.default_rng(401)
    xs = [kf12([o.easy_part([int.from_bytes(rng.bytes(40), "little") % c.P
                             for _ in range(12)]) for _ in range(2)]) for _ in range(4)]
    unfused = FE.hard_part_chain_k(*xs, fused=False)
    fused = FE.hard_part_chain_k(*xs, fused=True)  # K15's plain version on CPU operands
    assert kf12_canon(fused) == kf12_canon(unfused)
    assert torch.equal(fused, unfused)  # raw limbs: the same operation sequence

    calls = []
    monkeypatch.setattr(FE, "hard_chain", lambda *a: calls.append("fused"))
    monkeypatch.setattr(FE, "_hard_chain_launches", lambda *a: calls.append("unfused"))
    monkeypatch.setenv("PAIRING_FUSED_CHAIN", "1")
    FE.hard_part_chain_k(*xs)
    FE.hard_part_chain_k(*xs, fused=True)
    FE.hard_part_chain_k(*xs, fused=False)
    assert calls == ["unfused", "fused", "unfused"]


def test_fq12_sq_plain_matches_jax_and_oracle(fx):
    _, data, a, _ = fx
    got = KL.ksq(kf12(a))
    assert kf12_canon(got) == data["fq12_sq"].tolist()
    assert kf12_raw(got) == data["raw_fq12_sq"].tolist()
    assert ints(kf12_canon(got)) == [o.fq12_mul(x, x) for x in a]


def _oracle_line(row, slots):
    return [(row[j], row[j + 6]) if j in slots else None for j in range(6)]


@pytest.mark.parametrize("shape", ["034", "235"])
def test_mul_sparse_plain_matches_jax_and_oracle(fx, shape):
    mod, data, a, lines = fx
    slots = mod.LINE_SHAPES[shape]
    want = [o.sparse_fp12_multiply(x, _oracle_line(y, slots)) for x, y in zip(a, lines[shape])]
    assert ints(data["mul_sparse_" + shape]) == want
    line = kf12(lines[shape])
    got = KL.kmul_sparse(kf12(a), slots, line)
    assert kf12_canon(got) == data["mul_sparse_" + shape].tolist()
    assert kf12_raw(got) == data["raw_mul_sparse_" + shape].tolist()
    # absent slots of b are never read
    junk = line.clone()
    for j in set(range(6)) - set(slots):
        junk[2 * j: 2 * j + 2] = 8193
    assert torch.equal(KL.kmul_sparse(kf12(a), slots, junk), got)
    # the Fq12-level wrapper builds the operand from its slots alone
    lv = port(lines[shape])
    got12 = dispatch.fq12_mul_sparse(port(a), {j: lv.s[j] for j in slots})
    assert canon(got12) == data["mul_sparse_" + shape].tolist()
    assert raw(got12) == data["raw_mul_sparse_" + shape].tolist()


@pytest.mark.parametrize("present", [(), (0, 0, 3), (6,), (-1, 2)])
def test_mul_sparse_rejects_bad_slots(present):
    a = torch.zeros((12, 21, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        FK.fq12_mul_sparse(a, present, a)


def test_fq12_pow_matches_jax_and_oracle(fx, monkeypatch):
    mod, data, a, _ = fx
    inverses = []
    monkeypatch.setattr(KL, "kinv", lambda x: inverses.append(1) or KL.kinv_plain(x))
    got = FE.fq12_pow(port(a), mod.POW_E)
    assert inverses == [1]  # its NAF has -1 digits: one inverse
    assert canon(got) == data["fq12_pow"].tolist()
    assert raw(got) == data["raw_fq12_pow"].tolist()
    assert TF12.fq12_to_int_coeffs(got) == [o.pow_fq12(x, mod.POW_E) for x in a]


def test_final_exp_raw_limbs_match_jax(fx):
    """The whole final exponentiation on one lane (easy part, three K17
    ladders, the 29-operation chain, every kernel on its plain version):
    the XLA path's raw limbs, and the oracle."""
    _, data, a, _ = fx
    got = FE.final_exp(port(a[3:]))
    assert raw(got) == data["raw_final_exp"][3:].tolist()
    assert canon(got) == data["final_exp"][3:].tolist()
    assert TF12.fq12_to_int_coeffs(got) == [o.final_exp(a[3])]


@pytest.mark.parametrize("e", [1, 2, 5, 7])
def test_fq12_pow_small_exponents(e, monkeypatch):
    """On an unsettled input (each slot added to itself: digits up to
    16382, values below 4p): e = 1 has a one-digit NAF and returns a capped
    to the (2p, settled) envelope, limb for limb as the reference's
    ``fq12_cap``; 2 and 5 have no -1 digit and take no inverse; 7 = 8 - 1
    takes one."""
    rng = np.random.default_rng(402 + e)
    coeffs = [[int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)]
              for _ in range(2)]
    a = TF12.Fq12(tuple(TF2.add(s, s) for s in port(coeffs).s))
    assert max(int(comp.limbs.max()) for s in a.s for comp in (s.c0, s.c1)) > 8193
    inverses = []
    monkeypatch.setattr(KL, "kinv", lambda x: inverses.append(1) or KL.kinv_plain(x))
    got = FE.fq12_pow(a, e)
    if e == 1:
        want = TF12.fq12_cap(a)
        assert all(torch.equal(g.limbs, w.limbs)
                   for gs, ws in zip(got.s, want.s) for g, w in ((gs.c0, ws.c0), (gs.c1, ws.c1)))
    assert len(inverses) == (1 if -1 in c.get_naf(e) else 0)
    doubled = [[2 * x % c.P for x in row] for row in coeffs]
    assert TF12.fq12_to_int_coeffs(got) == [o.pow_fq12(x, e) for x in doubled]
