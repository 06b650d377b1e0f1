"""The port's witness generation, npz format and checkers.

``tests/data/torch_witness_k2.npz`` is what the JAX package's
``save_pairing_witness`` writes for ``multi_pairing_witness`` at K = 2 pairs,
inner batch 1 (from ``tests/data/make_torch_multi_fixtures.py``, the XLA
path, checked in). The port's witness for the same pairs, on CPU tensors
(every kernel takes its plain version), must write an npz with the same
entry names, shapes, dtypes and ``meta`` and, entry by entry, the same
canonical values, aux columns included; both packages' checkers must accept
it and reject a perturbed limb. Comparison is exact.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import pairing_tpu_torch as pt
from pairing_tpu.witness import check_pairing_constraints as jax_check_constraints
from pairing_tpu.witness import verify_pairing_witness as jax_verify
from pairing_tpu_torch import witness as W
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields import fp2 as TF2
from pairing_tpu_torch.fields import fp12 as TF12
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.utils import bn254 as c
from pairing_tpu_torch.utils.interop import limb_values, reshape_points
from pairing_tpu_torch.witness.aux import settle
from pairing_tpu_torch.witness import trace as T

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"
K, B = 2, 1


def _fixture_module():
    spec = importlib.util.spec_from_file_location(
        "make_torch_multi_fixtures", DATA / "make_torch_multi_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def port_witness(tmp_path_factory):
    mod = _fixture_module()
    assert (mod.WITNESS_K, mod.WITNESS_B) == (K, B)
    g1s, g2s = mod.pairs()
    g1s, g2s = g1s[:K * B], g2s[:K * B]
    p = reshape_points(pt.g1_from_ints(g1s, "cpu"), (K, B))
    q = reshape_points(pt.g2_from_ints(g2s, "cpu"), (K, B))
    out, trace = W.multi_pairing_witness(p, q)
    path = tmp_path_factory.mktemp("wit") / "port_k2.npz"
    W.save_pairing_witness(str(path), p, q, out, trace)
    meta, data = W.load_pairing_witness(str(path))
    return g1s, g2s, p, q, out, trace, meta, data


def test_witness_output_is_the_multi_pairing(port_witness):
    g1s, g2s, _, _, out, trace, _, _ = port_witness
    m = o.multi_miller_loop(list(zip(g1s, g2s)))
    assert pt.fq12_to_int_coeffs(trace["miller_out"]) == [m]
    assert pt.fq12_to_int_coeffs(out) == [o.final_exp(m)]


def test_npz_matches_jax_writer(port_witness):
    meta, data = port_witness[-2:]
    jmeta, jdata = W.load_pairing_witness(str(DATA / "torch_witness_k2.npz"))
    assert meta == jmeta
    assert sorted(data) == sorted(jdata)
    for name, want in jdata.items():
        got = data[name]
        assert (got.shape, got.dtype) == (want.shape, want.dtype), name
        if name == "exp_bits":
            assert got.tolist() == want.tolist()
        else:
            assert (limb_values(got) == limb_values(want)).all(), name


def test_both_packages_checkers_accept(port_witness):
    meta, data = port_witness[-2:]
    for check in (W.check_pairing_constraints, jax_check_constraints):
        report = check(meta, data)
        assert report["fq12_mul.s0.c0"] > 0 and report["traj_add.1.slope.c0"] > 0
    for verify in (W.verify_pairing_witness, jax_verify):
        report = verify(meta, data)
        assert report["f_step"] == 64 and report["final_out"] == 1


@pytest.mark.parametrize("entry, index, primary", [
    ("f_steps", (40, 0, 3, 5), True),
    ("r_affine_x", (70, 1, 0, 0, 2), True),
    ("exp_rows", (1, 20, 0, 7, 1), True),
    ("f_mid", (50, 0, 8, 2), False),  # an aux wire: only the AIR checker reads it
])
def test_perturbed_limb_rejected(port_witness, entry, index, primary):
    meta, data = port_witness[-2:]
    data = dict(data)
    data[entry] = data[entry].copy()
    data[entry][index] += 1
    with pytest.raises(W.ConstraintError):
        W.check_pairing_constraints(meta, data)
    if primary:
        with pytest.raises(W.WitnessError):
            W.verify_pairing_witness(meta, data)


def test_writer_settles_a_limb_of_8193(port_witness, tmp_path):
    """Kernel outputs may carry limbs of 2^13 + 1, which the checker's range
    check refuses; the writer settles every column without changing a value."""
    _, _, p, q, out, trace, meta, data = port_witness
    # a digit 1 followed by a nonzero digit in some ladder row component:
    # moving one unit down gives the same value with a limb of 8193
    hits = []
    for ladder in trace["final_exp"]["exp_trace_rows"]:
        for rows in (comp for slot in ladder for comp in slot):  # [64, B, L]
            digits = settle(rows)
            hit = ((digits[..., :-1] == 1) & (digits[..., 1:] > 0)).nonzero()
            hits += [(rows, digits, h.tolist()) for h in hit]
    assert hits, "no position to move a carry in this trace"
    rows, digits, (*lead, i) = hits[0]
    raw = digits.clone()
    raw[(*lead, i)] += TF.RADIX
    raw[(*lead, i + 1)] -= 1
    assert int(raw.max()) == TF.RADIX + 1
    assert (limb_values(raw.numpy()) == limb_values(rows.numpy())).all()
    rows.copy_(raw)  # the trace now holds a limb of 8193

    path = tmp_path / "settled.npz"
    W.save_pairing_witness(str(path), p, q, out, trace)
    meta2, data2 = W.load_pairing_witness(str(path))
    assert int(data2["exp_rows"].max()) < TF.RADIX
    assert (limb_values(data2["exp_rows"]) == limb_values(data["exp_rows"])).all()
    W.check_pairing_constraints(meta2, data2)
    jax_check_constraints(meta2, data2)


def test_fq12_exp_u64_matches_oracle():
    rng = np.random.default_rng(41)
    xs = [o.easy_part([int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)])
          for _ in range(2)]
    offs = [[int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)] for _ in range(2)]
    exps = [int.from_bytes(rng.bytes(8), "little"), 0b1011]
    inp = T.ExpU64Input(TF12.fq12_from_int_coeffs(xs, "cpu"), TF12.fq12_from_int_coeffs(offs, "cpu"),
                        T.exp_bits_from_u64(exps, "cpu"))
    out, rows = T.fq12_exp_u64(inp, collect_trace=True)
    assert pt.fq12_to_int_coeffs(out) == [
        o.fq12_mul(f, o.pow_fq12(x, e)) for f, x, e in zip(offs, xs, exps)]
    assert rows[0][0].shape == (64, 2, TF.NLIMBS)
    last = TF12.Fq12(tuple(TF2.from_limbs((c0[-1], c1[-1])) for c0, c1 in rows))
    assert pt.fq12_to_int_coeffs(last) == [o.pow_fq12(x, e) for x, e in zip(xs, exps)]
