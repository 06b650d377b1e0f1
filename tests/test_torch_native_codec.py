"""The port's native host codec (``pairing_tpu_torch.native``), a copy of
the JAX package's, against Python ground truth: every entry point, on
adversarial values (0, 1, p-1, p, 2p-1, R-1, random redundant encodings),
as tests/test_native_codec.py holds the original. Its C source is the
original's byte for byte, and the field constructors return the same limbs
with and without it.
"""

import random
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import pairing_tpu_torch as pt
from pairing_tpu_torch import native
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields.fp import NLIMBS, RADIX_BITS, int_to_limbs
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.utils import bn254 as c
from pairing_tpu_torch.utils.bn254 import P

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
R = 1 << (RADIX_BITS * NLIMBS)
R_INV = pow(R, -1, P)
RNG = random.Random(43)


def limbs_of(v: int) -> np.ndarray:
    return np.asarray(int_to_limbs(v), np.int32)


def val_of(limbs) -> int:
    return sum(int(x) << (RADIX_BITS * i) for i, x in enumerate(limbs))


EDGE = [0, 1, P - 1, P, P + 1, 2 * P - 1, R - 1]
RANDOM = [RNG.randrange(0, 2 * P) for _ in range(64)]


def test_codec_source_is_the_original_byte_for_byte():
    ours = (REPO / "pairing_tpu_torch" / "native" / "limbcodec.c").read_bytes()
    assert ours == (REPO / "pairing_tpu" / "native" / "limbcodec.c").read_bytes()


def test_codec_cache_is_its_own(tmp_path, monkeypatch):
    """The library is built under the port's own cache directory."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert native._cache_dir() == str(tmp_path / "pairing_tpu_torch")


NO_TOOLCHAIN = pytest.mark.skipif(
    not any(shutil.which(cc) for cc in ("cc", "gcc", "clang", "g++")),
    reason="no C toolchain; pure-Python fallback is the valid backend",
)


@NO_TOOLCHAIN
def test_backend_reported():
    assert native.available(), "C toolchain present but codec not built"


@pytest.mark.parametrize("from_mont", [False, True])
def test_canon_limbs(from_mont):
    vals = EDGE + RANDOM
    out = native.canon_limbs(np.stack([limbs_of(v) for v in vals]), from_mont=from_mont)
    for v, row in zip(vals, out):
        assert val_of(row) == ((v * R_INV) % P if from_mont else v % P)


def test_pack_unpack_roundtrip():
    vals = [v % P for v in EDGE + RANDOM]
    arr = np.stack([limbs_of(v) for v in vals])
    packed = native.pack_canonical(arr)
    assert packed.shape == (len(vals), 32)
    for v, row in zip(vals, packed):
        assert int.from_bytes(row.tobytes(), "little") == v
    assert np.array_equal(native.unpack_bytes(packed), arr)


@pytest.mark.parametrize("from_mont", [False, True])
def test_canon_pack_matches_two_step(from_mont):
    arr = np.stack([limbs_of(v) for v in EDGE + RANDOM])
    one = native.canon_pack(arr, from_mont=from_mont)
    two = native.pack_canonical(native.canon_limbs(arr, from_mont=from_mont))
    assert np.array_equal(one, two)


def test_unpack_mont_enters_domain():
    vals = [v % P for v in EDGE + RANDOM]
    packed = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in vals])
    for v, row in zip(vals, native.unpack_mont(packed)):
        assert val_of(row) == (v * R) % P


def test_ints_from_limbs_matches_python():
    vals = (EDGE + RANDOM)[:64]
    arr = np.stack([limbs_of(v) for v in vals]).reshape(2, -1, NLIMBS)
    assert native.ints_from_limbs(arr, from_mont=True) == [(v * R_INV) % P for v in vals]


@pytest.mark.parametrize("from_mont", [False, True])
def test_unsettled_redundant_inputs(from_mont):
    """Limbs above the radix canonicalize by value, including values >= R."""
    rows = [np.full((NLIMBS,), (1 << 17) - 1, np.int32),
            np.asarray([0] * (NLIMBS - 1) + [1 << 17], np.int32)]
    rows += [np.asarray([RNG.randrange(0, (1 << 17) + 1) for _ in range(NLIMBS)], np.int32)
             for _ in range(16)]
    out = native.canon_limbs(np.stack(rows), from_mont=from_mont)
    for r, row in zip(rows, out):
        v = val_of(r)
        assert val_of(row) == ((v * R_INV) % P if from_mont else v % P)


@pytest.mark.parametrize("from_mont", [False, True])
def test_settled_limb_budget_boundary(from_mont):
    row = np.full((NLIMBS,), 1 << 18, np.int32)
    v = val_of(row)
    out = native.canon_limbs(row[None], from_mont=from_mont)[0]
    assert val_of(out) == ((v * R_INV) % P if from_mont else v % P)


@pytest.mark.parametrize("fn", ["canon_limbs", "canon_pack"])
def test_settled_limb_budget_rejected(fn):
    too_big = np.full((1, NLIMBS), (1 << 18) + 1, np.int32)
    negative = np.zeros((1, NLIMBS), np.int32)
    negative[0, 0] = -1
    for bad in (too_big, negative):
        with pytest.raises(ValueError, match="settled-limb contract"):
            getattr(native, fn)(bad, from_mont=True)


def test_python_fallback_paths_agree(monkeypatch):
    vals = EDGE + RANDOM[:8]
    arr = np.stack([limbs_of(v) for v in vals])
    native_canon = native.canon_limbs(arr, from_mont=True)
    native_pack = native.pack_canonical(native_canon)
    native_mont = native.unpack_mont(native_pack)
    monkeypatch.setattr(native, "_lib", lambda: None)
    assert np.array_equal(native.canon_limbs(arr, True), native_canon)
    assert np.array_equal(native.pack_canonical(native_canon), native_pack)
    assert np.array_equal(native.unpack_mont(native_pack), native_mont)
    assert np.array_equal(native.unpack_bytes(native_pack), native_canon)


@NO_TOOLCHAIN
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_constructors_same_limbs_with_and_without_codec(monkeypatch, group):
    """fp_from_ints_mont's two routes give the same canonical Montgomery
    digits, so g1_from_ints / g2_from_ints return the same limbs."""
    rng = np.random.default_rng(44)
    ks = [int.from_bytes(rng.bytes(32), "little") % (c.R_SCALAR - 1) + 1 for _ in range(3)]
    if group == "g1":
        pts, make = [o.g1_mul(c.G1_GEN, k) for k in ks] + [(0, 0), (P - 1, 1)], pt.g1_from_ints
        coords = lambda v: [v.x, v.y]  # noqa: E731
    else:
        pts = [o.g2_mul((c.G2_GEN_X, c.G2_GEN_Y), k) for k in ks] + [((0, P - 1), (1, 0))]
        make = pt.g2_from_ints
        coords = lambda v: [v.x.c0, v.x.c1, v.y.c0, v.y.c1]  # noqa: E731
    assert native.available()
    with_codec = [x.limbs for x in coords(make(pts, "cpu"))]
    monkeypatch.setattr(native, "available", lambda: False)
    without = [x.limbs for x in coords(make(pts, "cpu"))]
    for a, b in zip(with_codec, without):
        assert a.dtype == b.dtype == torch.int32 and torch.equal(a, b)
        assert int(a.max()) <= TF.MASK  # canonical digits
