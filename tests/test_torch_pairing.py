"""The port's whole slice: ``miller_loop`` and ``pairing`` on 4 seeded pairs.

The JAX side comes from ``tests/data/torch_pairing_fixture.npz``, written by
``tests/data/make_torch_fixtures.py`` (the JAX package's jitted XLA-path
``miller_loop`` and ``pairing``; about two minutes of CPU to regenerate, so
it is checked in). On CPU tensors every kernel takes its plain version.
Comparison is exact, on canonical limbs, and also against the port's
pure-integer oracle.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pairing_tpu_torch as pt
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields.fp12 import fq12_to_canonical_limbs
from pairing_tpu_torch.oracle import native as o

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"
REPO = DATA.parent.parent


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_torch_fixtures", DATA / "make_torch_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fixture():
    mod = _fixture_script()
    data = np.load(DATA / "torch_pairing_fixture.npz")
    assert int(data["seed"]) == mod.SEED
    g1s, g2s = mod.seeded_pairs()
    # the fixture was made from these very points
    assert [[TF.limbs_to_int(v) for v in row] for row in data["g1"]] == [list(p) for p in g1s]
    assert [[TF.limbs_to_int(v) for v in row] for row in data["g2"]] == [
        [x[0], x[1], y[0], y[1]] for x, y in g2s]
    p = pt.g1_from_ints(g1s, "cpu")
    q = pt.g2_from_ints(g2s, "cpu")
    return data, g1s, g2s, p, q


def _check_envelope(f):
    for s in f.s:
        for comp in (s.c0, s.c1):
            limbs = comp.limbs
            assert limbs.shape == (4, 21)
            assert int(limbs.min()) >= 0 and int(limbs.max()) <= TF.SETTLED
            assert all(TF.limbs_to_int(r) < 2 * TF.P for r in limbs.numpy())


def test_miller_loop_matches_jax_and_oracle(fixture):
    data, g1s, g2s, p, q = fixture
    f = pt.miller_loop(q, p)
    _check_envelope(f)
    assert fq12_to_canonical_limbs(f).numpy().tolist() == data["miller"].tolist()
    assert pt.fq12_to_int_coeffs(f) == [o.miller_loop(qq, pp) for pp, qq in zip(g1s, g2s)]


def test_pairing_matches_jax_and_oracle(fixture):
    data, g1s, g2s, p, q = fixture
    e = pt.pairing(p, q)
    _check_envelope(e)
    assert fq12_to_canonical_limbs(e).numpy().tolist() == data["pairing"].tolist()
    assert pt.fq12_to_int_coeffs(e) == [o.pairing(pp, qq) for pp, qq in zip(g1s, g2s)]


def test_import_needs_no_jax_nvcc_or_triton():
    code = (
        "import sys, pairing_tpu_torch, pairing_tpu_torch.ops.fused_kernels, "
        "pairing_tpu_torch.ops.build, pairing_tpu_torch.ops.fq2_vm, "
        "pairing_tpu_torch.utils.interop, pairing_tpu_torch.witness\n"
        "bad = [m for m in ('jax', 'pairing_tpu', 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO)}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)
