"""The validation surface of the port on the CPU: ``validate_inputs``, the
G2 subgroup check on kernel H's end-only mode, and the field and curve
helpers under them, against the port's pure-integer oracle and the JAX
package.

The JAX side comes from ``tests/data/torch_validate_fixture.npz``, written
by ``tests/data/make_torch_validate_fixtures.py`` from the JAX package's XLA
path on four seeded lanes (about two minutes of CPU to regenerate, so it is
checked in; no JAX graph is compiled here). Values are compared on their
canonical digits; raw limbs too where the port's CPU route runs the XLA
path's operations in the same order (the selects, negations, sparse
embedding and the inputs' constructors). The inversions differ in their
representatives: the XLA path's Fermat scan multiplies by one on clear
bits, the port's ladder skips them.

Kernel H's end-only mode runs its plain version here (CPU tensors);
``Kernel.__call__``'s choice of device and stream is checked with stand-ins
for the library and for ``torch.cuda``.
"""

import importlib.util
import random
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import pairing_tpu_torch as pt
from pairing_tpu_torch.curves import g1 as TG1
from pairing_tpu_torch.curves import g2 as TG2
from pairing_tpu_torch.fields import fp as TF
from pairing_tpu_torch.fields import fp2 as TF2
from pairing_tpu_torch.fields import fp12 as TF12
from pairing_tpu_torch.fields.fp2 import Fp2
from pairing_tpu_torch.ops import curve_kernels as CK
from pairing_tpu_torch.ops import dispatch
from pairing_tpu_torch.ops import fq12_kernels as FK
from pairing_tpu_torch.oracle import native as o
from pairing_tpu_torch.pairing import miller_loop as ML
from pairing_tpu_torch.utils import bn254 as c

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data"
RINV = pow(TF.R_MONT, -1, c.P)
G2GEN = (c.G2_GEN_X, c.G2_GEN_Y)
RUN_DIGITS = [1, 1, -1, -1, 0, 0, 0, 1, -1, 0, 1, 1, 1, 0, -1, -1, -1, 0, 0, 1]


def _non_subgroup_point():
    """tests/test_validate.py's on-twist point outside the r-torsion."""
    for x0 in range(1, 200):
        q = o.g2_point_from_x((x0, 1))
        if q is not None and not o.g2_in_subgroup(q):
            return q
    raise AssertionError("no non-subgroup point found")


# ---------------------------------------------------------------------------
# tests/test_validate.py's device cases, on the port
# ---------------------------------------------------------------------------


def test_validate_inputs_four_lanes():
    rng = random.Random(2024)
    good_g1 = [o.g1_mul(c.G1_GEN, rng.randrange(1, c.R_SCALAR)) for _ in range(2)]
    good_g2 = [o.g2_mul(G2GEN, rng.randrange(1, c.R_SCALAR)) for _ in range(2)]
    bad_q = _non_subgroup_point()
    assert c._on_twist(*bad_q)
    # lanes: [good, good-with-non-subgroup-Q, off-curve P, infinity-encoded P]
    p = pt.g1_from_ints([good_g1[0], good_g1[1], (5, 5), (0, 0)], "cpu")
    q = pt.g2_from_ints([good_g2[0], bad_q, good_g2[1], good_g2[1]], "cpu")
    mask = pt.validate_inputs(p, q)
    assert mask.dtype == torch.bool and mask.tolist() == [True, False, False, False]
    assert pt.validate_inputs(p, q, subgroup_check=False).tolist() == [True, True, False, False]


def test_g2_in_subgroup_small_multiples():
    qs = pt.g2_from_ints([o.g2_mul(G2GEN, k) for k in (1, 2, 3)], "cpu")
    assert pt.g2_in_subgroup(qs).tolist() == [True, True, True]


def test_subgroup_digits_are_the_reference_ladders():
    """127 steps, 39 additions: get_naf(6 x^2) MSB first, top digit consumed."""
    naf = c.get_naf(6 * c.BN_X ** 2)
    assert TG2.SUBGROUP_DIGITS == tuple(naf[-2::-1])
    assert len(TG2.SUBGROUP_DIGITS) == 127
    assert sum(1 for d in TG2.SUBGROUP_DIGITS if d) == 39


@pytest.mark.parametrize("case", ["miller_points", "runs_random"])
def test_trajectory_end_plain_equals_trajectory_plain(case):
    """The end-only mode's plain version is the end of the full plain
    trajectory, limb for limb."""
    if case == "miller_points":
        rng = np.random.default_rng(402)
        ks = [int.from_bytes(rng.bytes(32), "little") % (c.R_SCALAR - 1) + 1 for _ in range(3)]
        q = TG2.g2_from_ints([o.g2_mul(G2GEN, k) for k in ks], "cpu")
        q_rows, digits = FK.kstack([q.x.c0, q.x.c1, q.y.c0, q.y.c1]), list(ML.STEP_DIGITS)
    else:
        gen = torch.Generator().manual_seed(17)
        q_rows, digits = FK.random_kf12((4,), 5, gen), RUN_DIGITS
    end = CK.trajectory_end(q_rows, digits)  # CPU tensors: plain
    assert torch.equal(end, CK.trajectory_plain(q_rows, digits)[2])
    assert torch.equal(end, CK.trajectory_end_plain(q_rows, digits))


# ---------------------------------------------------------------------------
# Every helper against the oracle and the JAX fixture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fx():
    spec = importlib.util.spec_from_file_location(
        "make_torch_validate_fixtures", DATA / "make_torch_validate_fixtures.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with np.load(DATA / "torch_validate_fixture.npz") as z:
        data = dict(z)
    assert int(data["seed"]) == mod.SEED
    return mod, data


def rows_of(v):
    """The fixture's row order of a value's Fq components."""
    if isinstance(v, TF.Fp):
        return [v]
    if isinstance(v, Fp2):
        return [v.c0, v.c1]
    if isinstance(v, TF12.Fq12):
        return [x for s in v.s for x in (s.c0, s.c1)]
    if isinstance(v, TG1.G1):
        return [v.x, v.y]
    if isinstance(v, TG2.G2):
        return [x for w in (v.x, v.y) for x in (w.c0, w.c1)]
    return [x for w in (v.X, v.Y, v.Z) for x in (w.c0, w.c1)]


def canon(v) -> np.ndarray:
    return np.stack([TF.canonical(r).limbs.numpy() for r in rows_of(v)])


def raw(v) -> np.ndarray:
    return np.stack([r.limbs.numpy() for r in rows_of(v)])


def ints(v) -> list:
    """Values mod p out of Montgomery form, per row and lane."""
    return [[TF.limbs_to_int(x) * RINV % c.P for x in row.reshape(-1, TF.NLIMBS)]
            for row in canon(v)]


def fq12_ints(v) -> list:
    """Per lane, the oracle's 12 coefficients."""
    rows = ints(v)
    return [[rows[2 * i][b] for i in range(6)] + [rows[2 * i + 1][b] for i in range(6)]
            for b in range(len(rows[0]))]


def g2_pts(v) -> list:
    r = ints(v)
    return [((r[0][b], r[1][b]), (r[2][b], r[3][b])) for b in range(len(r[0]))]


@pytest.fixture(scope="module")
def port(fx):
    """The port's inputs and every helper's result, built once."""
    mod, data = fx
    ins = mod.seeded_inputs()
    a = TF.fp_from_ints_mont(ins["fp_a"], "cpu")
    b = TF.Fp(torch.as_tensor(mod.fp_b_limbs(ins)), 2 * c.P, TF.MASK)
    cc = TF.fp_from_ints_mont(ins["fp_c"], "cpu")
    mask = torch.as_tensor(ins["mask"])
    x = TF2.fp2_stack_from_ints(ins["fp2_x"], "cpu")
    y = TF2.fp2_stack_from_ints(ins["fp2_y"], "cpu")
    f = TF12.fq12_from_int_coeffs(ins["fq12_f"], "cpu")
    g = TF12.fq12_from_int_coeffs(ins["fq12_g"], "cpu")
    p = pt.g1_from_ints(ins["g1"], "cpu")
    q = pt.g2_from_ints(ins["g2"], "cpu")
    q_rot = pt.g2_from_ints(ins["g2"][1:] + ins["g2"][:1], "cpu")
    r0 = TG2.jac_from_affine(q)
    r1 = TG2.jac_double(r0)
    r2 = TG2.jac_mixed_add(r1, q)

    def stacked(w, comp):
        parts = [getattr(getattr(r, w), comp) for r in (r0, r1, r2)]
        return TF.Fp(torch.stack([t.limbs for t in parts]),
                     max(t.bound for t in parts), max(t.limb_bound for t in parts))

    jac = TG2.G2Jac(*(Fp2(stacked(w, "c0"), stacked(w, "c1")) for w in ("X", "Y", "Z")))
    out = {
        "in_fp_a": a, "in_fp_b": b, "in_fp_c": cc, "in_fp2_x": x, "in_fp2_y": y,
        "in_fq12_f": f, "in_fq12_g": g, "in_g1": p, "in_g2": q, "in_jac_stack": jac,
        "fp_select": TF.fp_select(mask, a, b), "fp_eq": TF.fp_eq(a, b),
        "fp_is_zero": TF.fp_is_zero(cc),
        "fp2_select": TF2.select(mask, x, y), "fp2_eq": TF2.eq(x, y),
        "fq12_from_sparse": TF12.fq12_from_sparse({0: x, 3: y, 4: x}, x.batch_shape, "cpu"),
        "fq12_select": TF12.fq12_select(mask, f, g), "fq12_eq": TF12.fq12_eq(f, g),
        "fq12_div": TF12.fq12_div(f, g),
        "g1_neg": pt.g1_neg(p), "g1_on_curve": pt.g1_on_curve(p),
        "g2_select": TG2.g2_select(mask, q, pt.g2_neg(q)), "g2_on_curve": pt.g2_on_curve(q),
        "g2_double_affine": TG2.g2_double_affine(q), "g2_add_affine": TG2.g2_add_affine(q, q_rot),
        "jac_select": TG2.jac_select(mask, r1, r2), "batch_to_affine": TG2.batch_to_affine(jac),
        "g2_in_subgroup": pt.g2_in_subgroup(q), "validate_inputs": pt.validate_inputs(p, q),
        "validate_inputs_no_subgroup": pt.validate_inputs(p, q, subgroup_check=False),
    }
    for i, v in enumerate(TF.batch_inv((a, b, TF.fp_select(mask, a, b)))):
        out[f"batch_inv_{i}"] = v
    return ins, out


#: The inputs, as the port's constructors make them (b and the Jacobian
#: stack from the fixture's recipe).
INPUTS = ("in_fp_a", "in_fp_b", "in_fp_c", "in_fp2_x", "in_fp2_y", "in_fq12_f", "in_fq12_g",
          "in_g1", "in_g2", "in_jac_stack")
#: Results that the port computes with the XLA path's operations in its
#: order: raw limbs equal too.
SAME_OPS = ("fp_select", "fp2_select", "fq12_from_sparse", "fq12_select", "g1_neg",
            "g2_select", "jac_select")
#: Results compared on canonical digits only.
VALUES_ONLY = ("batch_inv_0", "batch_inv_1", "batch_inv_2", "fq12_div", "g2_double_affine",
               "g2_add_affine", "batch_to_affine")
MASKS = ("fp_eq", "fp_is_zero", "fp2_eq", "fq12_eq", "g1_on_curve", "g2_on_curve",
         "g2_in_subgroup", "validate_inputs", "validate_inputs_no_subgroup")


@pytest.mark.parametrize("name", INPUTS + SAME_OPS + VALUES_ONLY + MASKS)
def test_helper_matches_jax_fixture(port, fx, name):
    _, data = fx
    got = port[1][name]
    if name in MASKS:
        assert got.dtype == torch.bool and got.tolist() == data[name].tolist()
        return
    assert np.array_equal(canon(got), data[name])
    if name not in VALUES_ONLY:
        assert np.array_equal(raw(got), data["raw_" + name])


def _oracle_fq(ins, name):
    a, b, cc, mask = ins["fp_a"], ins["fp_b"], ins["fp_c"], ins["mask"]
    sel = [u if m else v for u, v, m in zip(a, b, mask)]
    return {"fp_select": sel, "fp_eq": [u == v for u, v in zip(a, b)],
            "fp_is_zero": [v == 0 for v in cc],
            "batch_inv_0": [pow(v, -1, c.P) for v in a],
            "batch_inv_1": [pow(v, -1, c.P) for v in b],
            "batch_inv_2": [pow(v, -1, c.P) for v in sel]}[name]


@pytest.mark.parametrize("name", ["fp_select", "fp_eq", "fp_is_zero", "batch_inv_0",
                                  "batch_inv_1", "batch_inv_2"])
def test_fp_helper_matches_oracle(port, name):
    ins, out = port
    want = _oracle_fq(ins, name)
    got = out[name]
    assert (got.tolist() if name in MASKS else ints(got)[0]) == want


def test_fp2_and_fq12_helpers_match_oracle(port):
    ins, out = port
    x, y, f, g, mask = ins["fp2_x"], ins["fp2_y"], ins["fq12_f"], ins["fq12_g"], ins["mask"]
    assert TF2.fp2_to_ints(port[1]["in_fp2_x"]) == x
    assert [tuple(p) for p in zip(*ints(out["fp2_select"]))] == [
        u if m else v for u, v, m in zip(x, y, mask)]
    assert out["fp2_eq"].tolist() == [u == v for u, v in zip(x, y)]
    assert fq12_ints(out["fq12_select"]) == [u if m else v for u, v, m in zip(f, g, mask)]
    assert out["fq12_eq"].tolist() == [u == v for u, v in zip(f, g)]
    assert fq12_ints(out["fq12_div"]) == [o.fq12_div(u, v) for u, v in zip(f, g)]
    sparse = [o.fq12_from_fq2_slots([u, None, None, v, u, None]) for u, v in zip(x, y)]
    assert fq12_ints(out["fq12_from_sparse"]) == sparse


def test_curve_helpers_match_oracle(port):
    ins, out = port
    g1s, g2s, mask = ins["g1"], ins["g2"], ins["mask"]
    rot = g2s[1:] + g2s[:1]
    assert pt.g1_to_ints(out["in_g1"]) == [tuple(v) for v in g1s]
    assert pt.g2_to_ints(out["in_g2"]) == [tuple(map(tuple, v)) for v in g2s]
    assert pt.g1_to_ints(out["g1_neg"]) == [(x, (-y) % c.P) for x, y in g1s]
    assert out["g1_on_curve"].tolist() == [(y * y - x ** 3 - 3) % c.P == 0 for x, y in g1s]
    assert out["g2_on_curve"].tolist() == [c._on_twist(*v) for v in g2s]
    assert g2_pts(out["g2_select"]) == [v if m else o.g2_neg(v) for v, m in zip(g2s, mask)]
    assert g2_pts(out["g2_double_affine"]) == [o.g2_double(v) for v in g2s]
    assert g2_pts(out["g2_add_affine"]) == [o.g2_add(u, v) for u, v in zip(g2s, rot)]
    assert out["g2_in_subgroup"].tolist() == [o.g2_in_subgroup(v) for v in g2s]
    aff = g2_pts(out["batch_to_affine"])  # rows [N = 3, B = 4] flattened state-major
    want = [v for k in (1, 2, 3) for v in (o.g2_mul(w, k) for w in g2s)]
    assert aff == want


def test_jac_select_matches_oracle(port):
    ins, out = port
    mask = ins["mask"]
    sel = TG2.batch_to_affine(TG2.G2Jac(*(Fp2(*(TF.Fp(v.limbs.unsqueeze(0), v.bound, v.limb_bound)
                                                  for v in (w.c0, w.c1)))
                                           for w in (out["jac_select"].X, out["jac_select"].Y,
                                                     out["jac_select"].Z))))
    assert g2_pts(sel) == [o.g2_mul(v, 2 if m else 3) for v, m in zip(ins["g2"], mask)]


# ---------------------------------------------------------------------------
# Kernel.__call__: the operands' device and its stream
# ---------------------------------------------------------------------------


class _FakeTensor:
    """A tensor stand-in: a device and an address."""

    def __init__(self, device: str, ptr: int):
        self.device = torch.device(device)
        self._ptr = ptr

    def data_ptr(self) -> int:
        return self._ptr


def _stand_ins(monkeypatch):
    """dispatch's torch.cuda and library replaced by recorders; device 0 is
    current."""
    log = {"current": 0, "entered": [], "streams": [], "calls": []}

    class _Device:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            log["entered"].append(self.dev)
            self.prev, log["current"] = log["current"], self.dev.index
            return self

        def __exit__(self, *exc):
            log["current"] = self.prev

    def current_stream(dev=None):
        idx = log["current"] if dev is None else torch.device(dev).index
        log["streams"].append(idx)
        return types.SimpleNamespace(cuda_stream=1000 + idx)

    def entry(*args):
        log["calls"].append((args, log["current"]))
        return 0

    fake_torch = types.SimpleNamespace(
        Tensor=_FakeTensor, cuda=types.SimpleNamespace(device=_Device,
                                                       current_stream=current_stream))
    lib = types.SimpleNamespace(pt_fake=entry)
    monkeypatch.setattr(dispatch, "torch", fake_torch)
    monkeypatch.setattr(dispatch.build, "load", lambda: (lib, None))
    return log


def test_kernel_launches_on_its_operands_device_and_stream(monkeypatch):
    log = _stand_ins(monkeypatch)
    k = dispatch.Kernel("fake", "pt_fake")
    table = torch.zeros(3, dtype=torch.int64)  # a host table: passed by address, no device
    k(_FakeTensor("cuda:1", 64), dispatch.Host(table), _FakeTensor("cuda:1", 128), None, 7)
    assert k.launches == 1
    assert log["entered"] == [torch.device("cuda:1")] and log["streams"] == [1]
    # the entry ran with device 1 current, on device 1's stream; device 0 is
    # current again after
    assert log["calls"] == [((64, table.data_ptr(), 128, None, 7, 1001), 1)]
    assert log["current"] == 0


@pytest.mark.parametrize("devices", [("cuda:0", "cuda:1"), ("cuda:0", "cpu"), ("cpu", "cpu"), ()])
def test_kernel_refuses_operands_off_one_cuda_device(monkeypatch, devices):
    log = _stand_ins(monkeypatch)
    k = dispatch.Kernel("fake", "pt_fake")
    with pytest.raises(ValueError, match="one CUDA device"):
        k(*(_FakeTensor(d, 64 * i) for i, d in enumerate(devices)), 3)
    assert k.launches == 0 and not log["calls"] and not log["entered"]


def test_host_table_must_be_a_cpu_tensor():
    with pytest.raises(ValueError, match="host table"):
        dispatch.Host(torch.zeros((4, 2), dtype=torch.int32).t())
