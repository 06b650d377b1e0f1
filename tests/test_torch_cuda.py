"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; every test skips without a CUDA device (the decision is
taken inside a fixture, never at import). On a machine with the card and
nvcc, from the repository root (the repository's conftest imports JAX,
which that machine does not need):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Comparison is exact on canonical values; outputs must keep the envelope
(limbs in [0, 2^13 + 1], values < 2p). Lane counts include ragged ones:
the kernels mask the edge themselves.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

#: The kernels of ``pairing`` (one pair per lane), the main path.
PAIRING_KERNELS = ("fq12_mul", "fq12_cyc_sq", "miller_f", "pow_ladder_stream", "fq12_slotwise",
                   "fp_pow_bits", "fq12_inv", "trajectory", "prefix_products",
                   "running_inverse", "lines")


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; runs on the card (see the module docstring)")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    return g


def rand_kf12(lead, lanes, gen):
    """Operands below 2p with settled limbs (``fq12_kernels.random_kf12``)."""
    from pairing_tpu_torch.ops.fq12_kernels import random_kf12

    return random_kf12(lead, lanes, gen)


def assert_same(got, want):
    """Kernel output(s) equal to the plain version's, in the envelope."""
    from pairing_tpu_torch.ops.fq12_kernels import kf12_canonical, kf12_in_envelope

    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert kf12_in_envelope(g)
        assert torch.equal(kf12_canonical(g), kf12_canonical(w))


#: Kernel A runs 32 lanes a block, one warp per output component: these
#: lane counts cut a block at the edge (16391 = 512 blocks and 7 lanes).
FQ12_MUL_LANE_COUNTS = [1, 31, 32, 33, 129, 2048, 16391]


@pytest.mark.parametrize("lanes", FQ12_MUL_LANE_COUNTS)
def test_fq12_mul_kernel_matches_plain(gen, lanes):
    from pairing_tpu_torch.ops import fq12_kernels as FK

    a, b = rand_kf12((12,), lanes, gen), rand_kf12((12,), lanes, gen)
    before = FK.FQ12_MUL.launches
    assert_same(FK.fq12_mul(a, b), FK.fq12_mul_plain(a, b))
    assert FK.FQ12_MUL.launches == before + 1


#: Kernel B runs kernel A's blocks of 32 lanes, one warp per output
#: component: these lane counts cut a block at the edge.
CYC_SQ_LANE_COUNTS = [1, 31, 32, 33, 129, 2048, 16391]


@pytest.mark.parametrize("inputs", ["cyclotomic", "random"])
@pytest.mark.parametrize("lanes", CYC_SQ_LANE_COUNTS)
def test_cyc_sq_kernel_matches_plain(gen, lanes, inputs):
    """Kernel B on the easy part's outputs and on random operands with the
    edge lanes of kernel G's cases (zero, one, limbs of 2^13 and 2^13 + 1,
    values just below 2p): equal to kcyc_sq_plain on canonical values."""
    from pairing_tpu_torch.ops import klayout as KL
    from pairing_tpu_torch.pairing.final_exp import easy_part_k

    a = fq12_inv_edge_operand(lanes, gen)
    m = easy_part_k(a) if inputs == "cyclotomic" else a
    before = KL.FQ12_CYC_SQ.launches
    got = KL.kcyc_sq(m)
    assert KL.FQ12_CYC_SQ.launches == before + 1
    assert_same(got, KL.kcyc_sq_plain(m))


#: Kernels C, D and K12 run six threads per lane, five lanes per warp, 20
#: lanes per block: these lane counts cut a warp's group and a block at the
#: edge.
GROUP_LANE_COUNTS = [1, 4, 5, 6, 31, 33, 1029, 2048]


@pytest.mark.parametrize("lanes", GROUP_LANE_COUNTS)
def test_miller_f_kernel_matches_plain(gen, lanes):
    from pairing_tpu_torch.ops import fused_kernels as FU
    from pairing_tpu_torch.pairing import miller_loop as ML

    tg = rand_kf12((ML.N_STEPS, 6), lanes, gen)
    ch = rand_kf12((ML.N_ADDS, 6), lanes, gen)
    ep = rand_kf12((2, 6), lanes, gen)
    sched = FU.miller_schedule(ML.MILLER_FLAGS, ML.CHORD_ROWS)
    before = FU.MILLER_F.launches
    got = FU.miller_f(tg, ch, ep, ML.MILLER_FLAGS, ML.CHORD_ROWS)
    assert FU.MILLER_F.launches == before + 1
    assert_same(got, FU.miller_f_plain(tg, ch, ep, sched))


#: chip_smoke.POW_E, whose w = 4 digits include a negative one.
POW_E = 0b101101110101


@pytest.mark.parametrize("e", ["bn_x", POW_E])
@pytest.mark.parametrize("lanes", GROUP_LANE_COUNTS)
def test_pow_ladder_kernel_matches_plain(gen, lanes, e):
    from pairing_tpu_torch.ops import fused_kernels as FU
    from pairing_tpu_torch.pairing.final_exp import easy_part_k

    m = easy_part_k(rand_kf12((12,), lanes, gen))
    digits = FU.BN_X_W4_DIGITS if e == "bn_x" else FU.wnaf_msb(e, 4)
    stream, rows = FU.pow_x_table(m, digits)
    before = FU.POW_LADDER_STREAM.launches
    got = FU.pow_ladder_stream(stream, digits, rows)
    assert FU.POW_LADDER_STREAM.launches == before + 1
    assert_same(got, FU.pow_ladder_stream_plain(stream, digits, rows))


#: Kernel E runs blocks of 128 lanes of one output component: these lane
#: counts cut a block at the edge; 16384 is the main path's.
SLOTWISE_LANE_COUNTS = [1, 129, 2048, 16384]


@pytest.mark.parametrize("lanes", SLOTWISE_LANE_COUNTS)
@pytest.mark.parametrize("power", [None, 1, 2, 3, 6])
def test_slotwise_kernel_matches_plain(gen, lanes, power):
    """Kernel E on random operands with G's edge lanes (zero, one, limbs of
    2^13 and 2^13 + 1, values just below 2p): equal to slotwise_plain on
    canonical values, one launch a call."""
    from pairing_tpu_torch.ops import klayout as KL

    a = fq12_inv_edge_operand(lanes, gen)
    before = KL.FQ12_SLOTWISE.launches
    got = KL.slotwise(a, power)
    assert KL.FQ12_SLOTWISE.launches == before + 1
    assert_same(got, KL.slotwise_plain(a, power))


#: Kernel F runs one lane a thread, 128 lanes a block: these lane counts cut
#: a block at the edge (65,539 = the K = 4 path's lanes and three).
FP_POW_LANE_COUNTS = [1, 127, 128, 129, 16391, 65539]
#: The short exponents (e < 16 is the window's top digit alone), one digit
#: and the next, a 7-bit one, p - 2, one longer than p and one of 19 words.
FP_POW_EXPONENTS = ["1", "2", "15", "16", "17", "0b1011001", "p-2", "300-bit", "600-bit"]
LONG_EXPONENT_SEEDS = {300: 1130, 600: 1140}


def fp_pow_exponent(name: str) -> int:
    from pairing_tpu_torch.utils.bn254 import P

    if name == "p-2":
        return P - 2
    if name.endswith("-bit"):
        bits = int(name[:-4])
        rng = np.random.default_rng(LONG_EXPONENT_SEEDS[bits])
        return int.from_bytes(rng.bytes(bits // 8 + 1), "little") % (1 << (bits - 1)) | (
            1 << (bits - 1))
    return int(name, 0)


@pytest.mark.parametrize("e", FP_POW_EXPONENTS)
@pytest.mark.parametrize("lanes", FP_POW_LANE_COUNTS)
def test_fp_pow_bits_kernel_matches_plain(gen, lanes, e):
    """Kernel F equal to fp_pow_bits_plain on canonical values, in the
    envelope, with kernel G's edge lanes (zero, one, settled limbs, values
    just below 2p) in component 0: zero stays zero and one stays one."""
    from pairing_tpu_torch.ops import fp_kernels as FPK
    from pairing_tpu_torch.ops.fq12_kernels import kf12_canonical

    a = fq12_inv_edge_operand(lanes, gen)[0].contiguous()
    e = fp_pow_exponent(e)
    before = FPK.FP_POW_BITS.launches
    got = FPK.fp_pow_bits(a, e)
    assert FPK.FP_POW_BITS.launches == before + 1
    assert_same(got, FPK.fp_pow_bits_plain(a, e))
    canon = kf12_canonical(got)
    assert bool((canon[:, 0] == 0).all())
    if lanes > 1:
        assert torch.equal(canon[:, 1], kf12_canonical(a)[:, 1])


@pytest.mark.parametrize("lanes", [33, 1024])
def test_fq12_inv_kernel_matches_plain(gen, lanes):
    from pairing_tpu_torch.ops import klayout as KL

    a = rand_kf12((12,), lanes, gen)
    assert_same(KL.kinv(a), KL.kinv_plain(a))


#: Kernel G's tower runs 32 lanes a block (one warp per output component),
#: its chain 128 lanes a block: lane counts that cut both at the edge.
FQ12_INV_LANE_COUNTS = [1, 31, 32, 33, 129, 2048, 16391]


def fq12_inv_edge_operand(lanes, gen):
    """Random operands, where the lanes exist: lane 0 zero, lane 1 one, lane
    2 limbs of 2^13 and 2^13 + 1 in every even limb below 19, lane 3 values
    just below 2p."""
    from pairing_tpu_torch.fields import fp as F

    a = rand_kf12((12,), lanes, gen)
    rows = []
    if lanes > 0:
        rows.append(np.zeros((12, 21), np.int64))
    if lanes > 1:
        one = np.zeros((12, 21), np.int64)
        one[0] = F.int_to_limbs(F.R_MONT % F.P)
        rows.append(one)
    if lanes > 2:
        rng = np.random.default_rng(lanes)
        settled = rng.integers(0, 4000, (12, 21))
        settled[:, 0:19:2] = 8192 + rng.integers(0, 2, (12, 10))
        settled[:, 19], settled[:, 20] = rng.integers(0, 100, 12), 0  # the value stays below 2p
        rows.append(settled)
    if lanes > 3:
        rows.append(np.stack([F.int_to_limbs(2 * F.P - 1 - k) for k in range(12)]))
    for lane, row in enumerate(rows):
        a[:, :, lane] = torch.as_tensor(row, dtype=torch.int32, device=a.device)
    return a


@pytest.mark.parametrize("lanes", FQ12_INV_LANE_COUNTS)
def test_fq12_inv_kernel_edge_lanes(gen, lanes):
    """Kernel G (three launches, one count) equal to kinv_plain on canonical
    values, in the envelope; a zero lane gives zero and a one lane one."""
    from pairing_tpu_torch.ops import klayout as KL
    from pairing_tpu_torch.ops.fq12_kernels import kf12_canonical, kf12_in_envelope

    a = fq12_inv_edge_operand(lanes, gen)
    assert kf12_in_envelope(a)
    before = KL.FQ12_INV.launches
    got = KL.kinv(a)
    assert KL.FQ12_INV.launches == before + 1
    assert_same(got, KL.kinv_plain(a))
    canon = kf12_canonical(got)
    assert bool((canon[..., 0] == 0).all())
    if lanes > 1:
        assert torch.equal(canon[..., 1:2], kf12_canonical(a[..., 1:2]))


#: Lane counts that cut kernel H's 16-lane warps and 64-lane blocks.
TRAJECTORY_LANE_COUNTS = [1, 15, 16, 17, 33, 63, 65, 1024, 1029, 2048]
#: A digit string with runs of +-1 and of 0, beside the Miller loop's own.
RUN_DIGITS = [1, 1, -1, -1, 0, 0, 0, 1, -1, 0, 1, 1, 1, 0, -1, -1, -1, 0, 0, 1]


@pytest.mark.parametrize("digits", ["miller", "runs"])
@pytest.mark.parametrize("lanes", TRAJECTORY_LANE_COUNTS)
def test_trajectory_kernel_matches_plain(gen, lanes, digits):
    from pairing_tpu_torch.ops import curve_kernels as CK
    from pairing_tpu_torch.pairing import miller_loop as ML

    steps = list(ML.STEP_DIGITS) if digits == "miller" else RUN_DIGITS
    q = rand_kf12((4,), lanes, gen)
    assert_same(CK.trajectory(q, steps), CK.trajectory_plain(q, steps))


@pytest.mark.parametrize("digits", ["subgroup", "runs"])
@pytest.mark.parametrize("lanes", TRAJECTORY_LANE_COUNTS)
def test_trajectory_end_kernel_matches_plain(gen, lanes, digits):
    """Kernel H's end-only mode: one launch, counted apart, equal to its
    plain version on the G2 subgroup check's 127 digits and on RUN_DIGITS."""
    from pairing_tpu_torch.curves.g2 import SUBGROUP_DIGITS
    from pairing_tpu_torch.ops import curve_kernels as CK

    steps = list(SUBGROUP_DIGITS) if digits == "subgroup" else RUN_DIGITS
    q = rand_kf12((4,), lanes, gen)
    before, before_full = CK.TRAJECTORY_END.launches, CK.TRAJECTORY.launches
    got = CK.trajectory_end(q, steps)
    assert (CK.TRAJECTORY_END.launches, CK.TRAJECTORY.launches) == (before + 1, before_full)
    assert_same(got, CK.trajectory_end_plain(q, steps))


def _validation_lanes():
    """tests/test_validate.py's four lanes: good, Q outside G2, P off the
    curve, P = (0, 0)."""
    import random

    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.utils import bn254 as c

    rng = random.Random(2024)
    g2gen = (c.G2_GEN_X, c.G2_GEN_Y)
    good_g1 = [o.g1_mul(c.G1_GEN, rng.randrange(1, c.R_SCALAR)) for _ in range(2)]
    good_g2 = [o.g2_mul(g2gen, rng.randrange(1, c.R_SCALAR)) for _ in range(2)]
    bad_q = next(pt for pt in (o.g2_point_from_x((x0, 1)) for x0 in range(1, 200))
                 if pt is not None and not o.g2_in_subgroup(pt))
    return ([good_g1[0], good_g1[1], (5, 5), (0, 0)],
            [good_g2[0], bad_q, good_g2[1], good_g2[1]])


def test_validate_inputs_on_card_matches_oracle(gen):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.ops import dispatch
    from pairing_tpu_torch.utils import bn254 as c

    g1s, g2s = _validation_lanes()
    p, q = pt.g1_from_ints(g1s, "cuda"), pt.g2_from_ints(g2s, "cuda")
    dispatch.reset_launch_counts()
    mask = pt.validate_inputs(p, q)
    assert dispatch.launch_counts()["trajectory_end"] == 1
    assert mask.is_cuda and mask.tolist() == [True, False, False, False]
    assert pt.validate_inputs(p, q, subgroup_check=False).tolist() == [True, True, False, False]
    ks = pt.g2_from_ints([o.g2_mul((c.G2_GEN_X, c.G2_GEN_Y), k) for k in (1, 2, 3)], "cuda")
    assert pt.g2_in_subgroup(ks).tolist() == [True, True, True]


def test_batch_to_affine_on_card_matches_cpu_route(gen):
    """Phase N's kernels I, F and J under batch_to_affine: equal to the CPU
    route (their plain versions) on canonical values, and to the oracle."""
    from pairing_tpu_torch.curves import g2 as TG2
    from pairing_tpu_torch.fields import fp2 as F2
    from pairing_tpu_torch.ops import dispatch
    from pairing_tpu_torch.ops.curve_kernels import trajectory
    from pairing_tpu_torch.ops.fq12_kernels import kfp2_view, kstack

    _, g2s = _seeded_points(5, 14)
    outs = {}
    for dev in ("cpu", "cuda"):
        q = TG2.g2_from_ints(g2s, dev)
        tops, _, _ = trajectory(kstack([q.x.c0, q.x.c1, q.y.c0, q.y.c1]), RUN_DIGITS)
        dispatch.reset_launch_counts()
        aff = TG2.batch_to_affine(TG2.G2Jac(*(kfp2_view(tops[:, i:i + 2]) for i in (0, 2, 4))))
        if dev == "cuda":
            counts = dispatch.launch_counts()
            assert all(counts[k] == 1 for k in ("prefix_products", "fp_pow_bits",
                                                "running_inverse")), counts
        outs[dev] = [F2.fp2_to_ints(aff.x), F2.fp2_to_ints(aff.y)]
    assert outs["cuda"] == outs["cpu"]


def test_pairing_stream_on_card(gen, tmp_path):
    from pairing_tpu_torch.fields.fp12 import fq12_limbs_to_int_coeffs
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.parallel.runner import pairing_stream
    from pairing_tpu_torch.utils.config import PairingConfig

    g1s, g2s = _seeded_points(3, 15)
    cfg = PairingConfig(device="cuda", chunk_size=2, checkpoint_dir=str(tmp_path))
    out = list(pairing_stream(g1s, g2s, cfg))
    assert [len(ch) for ch in out] == [2, 1]
    got = [v for ch in out for v in fq12_limbs_to_int_coeffs(ch)]
    assert got == [o.pairing(p, q) for p, q in zip(g1s, g2s)]
    again = list(pairing_stream(g1s, g2s, cfg))
    assert all(np.array_equal(a, b) for a, b in zip(out, again))


def test_kernel_launches_on_its_operands_device(gen):
    """With cuda:0 current, a launch on cuda:0 operands runs there (the
    machine has one card, so another device cannot be tried); operands on
    the CPU and the card together are refused before any launch."""
    from pairing_tpu_torch.ops import fq12_kernels as FK

    a = rand_kf12((12,), 33, gen)
    with torch.cuda.device(0):
        before = FK.FQ12_MUL.launches
        assert_same(FK.fq12_mul(a, a), FK.fq12_mul_plain(a, a))
        assert FK.FQ12_MUL.launches == before + 1
        out = torch.empty_like(a)
        with pytest.raises(ValueError, match="one CUDA device"):
            FK.FQ12_MUL(a, a.cpu(), FK.DENSE, out, 33)
        assert FK.FQ12_MUL.launches == before + 1


@pytest.mark.parametrize("lanes", [33, 1024])
def test_batch_inversion_kernels_match_plain(gen, lanes):
    from pairing_tpu_torch.ops import norm_kernels as NK

    z = rand_kf12((2 * 64 + 2, 2), lanes, gen)
    prefix, total = NK.prefix_products(z)
    assert_same((prefix, total), NK.prefix_products_plain(z))
    tinv = rand_kf12((2,), lanes, gen)
    assert_same(NK.running_inverse(z, prefix, tinv), NK.running_inverse_plain(z, prefix, tinv))


def exact_fp2_step(c, z):
    """fp2_mul(c, z) on digits as kernels I and J compute it: z carried
    (load_fp), 2p - z1 reduced (fp_neg), each component's two products
    summed and reduced word by word, exactly (int64 columns). c, z:
    [..., 2, 21, lanes] int32 with c's digits below 2^13 -> c z, the same."""
    from pairing_tpu_torch.fields import fp as F

    dev = z.device

    def carried(t):
        return F._ripple_carry(t.transpose(-1, -2))[0].transpose(-1, -2).long()

    p_digits = torch.as_tensor(F.int_to_limbs(F.P), device=dev).long().view(-1, 1)
    c0, c1 = c[..., 0, :, :].long(), c[..., 1, :, :].long()
    z0, z1 = carried(z[..., 0, :, :]), carried(z[..., 1, :, :])
    nz1 = carried(2 * p_digits - z1)  # 2p - z1, and 0 where z1 is 0 (not 2p)
    nz1 = torch.where((z1 == 0).all(dim=-2, keepdim=True), torch.zeros_like(nz1), nz1)

    def mont(pairs):
        t = torch.zeros(c0.shape[:-2] + (2 * F.NLIMBS, c0.shape[-1]), dtype=torch.long,
                        device=dev)
        for a, b in pairs:
            for i in range(F.NLIMBS):
                t[..., i:i + F.NLIMBS, :] += a[..., i:i + 1, :] * b
        for i in range(F.NLIMBS):
            m = (t[..., i, :] * 905) & F.MASK  # 905 = -1/p mod 2^13
            t[..., i:i + F.NLIMBS, :] += m.unsqueeze(-2) * p_digits
            t[..., i + 1, :] += t[..., i, :] >> F.RADIX_BITS
        return carried(t[..., F.NLIMBS:, :])

    return torch.stack([mont([(c0, z0), (c1, nz1)]), mont([(c0, z1), (c1, z0)])], dim=-3).int()


#: Kernel I runs two threads a lane, 16 lanes a warp, 64 a block: lane
#: counts that cut a warp and a block, the main path's 16384 and the K = 4
#: path's 65,536 (plus 3).
PREFIX_PRODUCTS_LANE_COUNTS = [1, 15, 16, 17, 33, 63, 65, 16384, 65539]


@pytest.mark.parametrize("n_steps", [1, 2, 130])
@pytest.mark.parametrize("lanes", PREFIX_PRODUCTS_LANE_COUNTS)
def test_prefix_products_kernel_matches_plain(gen, lanes, n_steps):
    """Kernel I equal to its plain version on canonical values, and limb for
    limb at every step: prefix[0] is one's digits and each next row (total
    last) the exact reduction of the same products of the row before,
    which is what the one-thread kernel it replaced computed."""
    from pairing_tpu_torch.fields import fp as F
    from pairing_tpu_torch.ops import norm_kernels as NK

    z = rand_kf12((n_steps, 2), lanes, gen)
    before = NK.PREFIX_PRODUCTS.launches
    got = NK.prefix_products(z)
    assert NK.PREFIX_PRODUCTS.launches == before + 1
    assert tuple(got[0].shape) == tuple(z.shape) and tuple(got[1].shape) == tuple(z[0].shape)
    assert_same(got, NK.prefix_products_plain(z))
    rows = torch.cat([got[0], got[1][None]])
    one = torch.as_tensor(F.int_to_limbs(F.R_MONT % F.P), dtype=torch.int32, device=z.device)
    assert bool((rows[0, 0] == one.view(-1, 1)).all()) and bool((rows[0, 1] == 0).all())
    for i in range(0, n_steps, 16):  # 16 steps at a time: the int64 columns of 65,539 lanes
        j = min(i + 16, n_steps)
        assert torch.equal(rows[i + 1:j + 1], exact_fp2_step(rows[i:j], z[i:j]))


#: Kernel J runs four threads a lane, 8 lanes a warp, 32 a block: lane
#: counts that cut a warp and a block, the main path's 16384 and the K = 4
#: path's 65,536 (plus 3).
RUNNING_INVERSE_LANE_COUNTS = [1, 8, 15, 16, 17, 33, 16384, 65539]


@pytest.mark.parametrize("n_steps", [1, 2, 130])
@pytest.mark.parametrize("lanes", RUNNING_INVERSE_LANE_COUNTS)
def test_running_inverse_kernel_matches_plain(gen, lanes, n_steps):
    from pairing_tpu_torch.ops import norm_kernels as NK

    z, prefix = rand_kf12((n_steps, 2), lanes, gen), rand_kf12((n_steps, 2), lanes, gen)
    tinv = rand_kf12((2,), lanes, gen)
    before = NK.RUNNING_INVERSE.launches
    got = NK.running_inverse(z, prefix, tinv)
    assert NK.RUNNING_INVERSE.launches == before + 1
    assert_same(got, NK.running_inverse_plain(z, prefix, tinv))


#: Lane counts that cut kernel K's 128-lane blocks.
LINES_LANE_COUNTS = [1, 127, 128, 129, 1029, 2048]


@pytest.mark.parametrize("schedule", ["miller", "runs_rows_reversed"])
@pytest.mark.parametrize("lanes", LINES_LANE_COUNTS)
def test_lines_kernel_matches_plain(gen, lanes, schedule):
    """Kernel K, one thread per (line, lane), on the Miller loop's schedule
    and on RUN_DIGITS with its chords written to the rows in reverse step
    order."""
    from pairing_tpu_torch.ops import line_kernels as LK
    from pairing_tpu_torch.pairing import miller_loop as ML

    if schedule == "miller":
        digits, rows, n_ch = list(ML.STEP_DIGITS), list(ML.CHORD_ROWS[:ML.N_STEPS]), ML.N_ADDS
    else:
        digits = RUN_DIGITS
        chords = [t for t, d in enumerate(digits) if d]
        n_ch = len(chords)
        rows = [-1] * len(digits)
        for c, t in enumerate(chords):
            rows[t] = n_ch - 1 - c
    n = len(digits)
    tops = rand_kf12((n, 6), lanes, gen)
    dbls = rand_kf12((n, 6), lanes, gen)
    zinv = rand_kf12((2 * n + 2, 2), lanes, gen)
    pq = rand_kf12((6,), lanes, gen)
    sched = LK.line_schedule(digits, rows, n_ch)
    before = LK.LINES.launches
    got = LK.lines(tops, dbls, zinv, pq, digits, rows, n_ch)
    assert LK.LINES.launches == before + 1
    assert_same(got, LK.lines_plain(tops, dbls, zinv, pq, sched, n_ch))


def test_pairing_on_card_matches_oracle(gen):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.ops import dispatch
    from pairing_tpu_torch.utils import bn254 as c

    rng = np.random.default_rng(11)
    ks = [int.from_bytes(rng.bytes(32), "little") % (c.R_SCALAR - 1) + 1 for _ in range(6)]
    g1s = [o.g1_mul(c.G1_GEN, k) for k in ks[:3]]
    g2s = [o.g2_mul((c.G2_GEN_X, c.G2_GEN_Y), k) for k in ks[3:]]
    dispatch.reset_launch_counts()
    out = pt.pairing(pt.g1_from_ints(g1s, "cuda"), pt.g2_from_ints(g2s, "cuda"))
    counts = dispatch.launch_counts()
    assert all(counts[name] > 0 for name in PAIRING_KERNELS), counts
    assert pt.fq12_to_int_coeffs(out) == [o.pairing(p, q) for p, q in zip(g1s, g2s)]


@pytest.mark.parametrize("n_pairs, collect", [(2, False), (4, False), (1, True), (2, True)])
@pytest.mark.parametrize("lanes", GROUP_LANE_COUNTS)
def test_miller_f_modes_match_plain(gen, lanes, n_pairs, collect):
    from pairing_tpu_torch.ops import fused_kernels as FU
    from pairing_tpu_torch.pairing import miller_loop as ML

    tg = rand_kf12((ML.N_STEPS, 6), n_pairs * lanes, gen)
    ch = rand_kf12((ML.N_ADDS, 6), n_pairs * lanes, gen)
    ep = rand_kf12((2, 6), n_pairs * lanes, gen)
    sched = FU.miller_schedule(ML.MILLER_FLAGS, ML.CHORD_ROWS)
    kernel = FU.MILLER_F_COLLECT if collect else FU.MILLER_F_MULTI
    before = kernel.launches
    got = FU.miller_f(tg, ch, ep, ML.MILLER_FLAGS, ML.CHORD_ROWS, n_pairs, collect)
    assert kernel.launches == before + 1
    assert_same(got, FU.miller_f_plain(tg, ch, ep, sched, n_pairs, collect))


#: Kernel K12's bit strings besides BN_X's (the witness path's): one set
#: bit, and a string with a leading set bit and runs of ones and zeros.
EXP_BITS_STRINGS = {"one": [1],
                    "runs": [1, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 0, 0, 0, 1]}


@pytest.mark.parametrize("bits", ["bn_x", *EXP_BITS_STRINGS])
@pytest.mark.parametrize("lanes", GROUP_LANE_COUNTS)
def test_exp_bits_kernel_matches_plain(gen, lanes, bits):
    from pairing_tpu_torch.ops import fused_kernels as FU
    from pairing_tpu_torch.pairing.final_exp import easy_part_k

    bits = FU.BN_X_BITS_MSB if bits == "bn_x" else np.asarray(EXP_BITS_STRINGS[bits], np.int32)
    x = easy_part_k(rand_kf12((12,), lanes, gen))
    before = FU.EXP_BITS.launches
    out, rows = FU.exp_bits_ladder(x, bits)
    assert FU.EXP_BITS.launches == before + 1
    want = FU.exp_bits_ladder_plain(x, bits)
    assert_same((out, rows), (want[-1], want))


#: Kernel K13 runs blocks of 128 lanes of one state: these lane counts cut
#: a block at the edge; 16384 is the witness path's.
AFFINE_EXPORT_LANE_COUNTS = [1, 33, 1024, 16384]


@pytest.mark.parametrize("form", ["tensor", "segments"])
@pytest.mark.parametrize("lanes", AFFINE_EXPORT_LANE_COUNTS)
def test_affine_export_kernel_matches_plain(gen, lanes, form):
    """Kernel K13 over 130 states, as one tensor [130, 4, 21, lanes] or as
    the Miller loop's four segments (tops and post-doubles six rows a
    state, sliced [:, 0:4], then end and end + Q1): equal to
    affine_export_plain on canonical values, one launch a call."""
    from pairing_tpu_torch.ops import fq2_vm as VM

    zinv = rand_kf12((130, 2), lanes, gen)
    if form == "tensor":
        xy = rand_kf12((130, 4), lanes, gen)
    else:
        tops, dbls, end, st91 = (rand_kf12(lead, lanes, gen)
                                 for lead in ((64, 6), (64, 6), (6,), (6,)))
        xy = (tops[:, 0:4], dbls[:, 0:4], end[None, 0:4], st91[None, 0:4])
    before = VM.AFFINE_EXPORT.launches
    got = VM.affine_export(xy, zinv)
    assert VM.AFFINE_EXPORT.launches == before + 1
    assert_same(got, VM.affine_export_plain(xy, zinv))


def _seeded_points(n, seed):
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.utils import bn254 as c

    rng = np.random.default_rng(seed)
    ks = [int.from_bytes(rng.bytes(32), "little") % (c.R_SCALAR - 1) + 1 for _ in range(2 * n)]
    return ([o.g1_mul(c.G1_GEN, k) for k in ks[:n]],
            [o.g2_mul((c.G2_GEN_X, c.G2_GEN_Y), k) for k in ks[n:]])


def test_multi_pairing_on_card_matches_oracle(gen):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.ops import dispatch
    from pairing_tpu_torch.utils.interop import reshape_points

    K, B = 3, 2
    g1s, g2s = _seeded_points(K * B, 12)
    dispatch.reset_launch_counts()
    out = pt.multi_pairing(reshape_points(pt.g1_from_ints(g1s, "cuda"), (K, B)),
                           reshape_points(pt.g2_from_ints(g2s, "cuda"), (K, B)))
    assert dispatch.launch_counts()["miller_f_multi"] == 1
    want = [o.final_exp(o.multi_miller_loop([(g1s[k * B + b], g2s[k * B + b])
                                             for k in range(K)])) for b in range(B)]
    assert pt.fq12_to_int_coeffs(out) == want


def test_witness_on_card_passes_both_checkers(gen, tmp_path):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch import witness as W
    from pairing_tpu_torch.ops import dispatch
    from pairing_tpu_torch.utils.interop import reshape_points

    K, B = 2, 2
    g1s, g2s = _seeded_points(K * B, 13)
    p = reshape_points(pt.g1_from_ints(g1s, "cuda"), (K, B))
    q = reshape_points(pt.g2_from_ints(g2s, "cuda"), (K, B))
    dispatch.reset_launch_counts()
    out, trace = W.multi_pairing_witness(p, q)
    counts = dispatch.launch_counts()
    assert all(counts[n] > 0 for n in ("miller_f_collect", "exp_bits", "affine_export")), counts
    assert pt.fq12_to_int_coeffs(out) == pt.fq12_to_int_coeffs(pt.multi_pairing(p, q))
    path = str(tmp_path / "w.npz")
    W.save_pairing_witness(path, p, q, out, trace)
    meta, data = W.load_pairing_witness(path)
    W.check_pairing_constraints(meta, data)
    W.verify_pairing_witness(meta, data)


def test_kernel_wrapper_rejects_bad_operands(gen):
    from pairing_tpu_torch.ops import fq12_kernels as FK

    a = rand_kf12((12,), 64, gen)
    with pytest.raises(ValueError):
        FK.fq12_mul(a, a[:, :, :32])
    with pytest.raises(TypeError):
        FK.fq12_mul(a, a.long())
    with pytest.raises(ValueError):
        FK.fq12_mul(a, a.cpu())


#: K18 runs kernel B's blocks of 32 lanes; 16389 cuts one at the edge.
@pytest.mark.parametrize("lanes", [1, 129, 2048, 16389])
def test_fq12_sq_kernel_matches_plain(gen, lanes):
    from pairing_tpu_torch.ops import fq12_kernels as FK

    a = rand_kf12((12,), lanes, gen)
    before = FK.FQ12_SQ.launches
    assert_same(FK.fq12_sq(a), FK.fq12_sq_plain(a))
    assert FK.FQ12_SQ.launches == before + 1


@pytest.mark.parametrize("lanes", [1, 129, 2048])
@pytest.mark.parametrize("present", [(0, 3, 4), (2, 3, 5), (1,)])
def test_fq12_mul_sparse_kernel_matches_plain(gen, lanes, present):
    from pairing_tpu_torch.ops import fq12_kernels as FK

    a, b = rand_kf12((12,), lanes, gen), rand_kf12((12,), lanes, gen)
    dense, before = FK.FQ12_MUL.launches, FK.FQ12_MUL_SPARSE.launches
    got = FK.fq12_mul_sparse(a, present, b)
    assert FK.FQ12_MUL_SPARSE.launches == before + 1 and FK.FQ12_MUL.launches == dense
    assert_same(got, FK.fq12_mul_sparse_plain(a, present, b))


@pytest.mark.parametrize("mask", range(1, 64))
def test_fq12_mul_sparse_every_mask_matches_plain(gen, mask):
    """Kernel A's sparse mode for every set of present slots of b, at 37
    lanes (a block and 5 lanes): a uniform branch skips each absent slot."""
    from pairing_tpu_torch.ops import fq12_kernels as FK

    present = tuple(j for j in range(6) if mask >> j & 1)
    a, b = rand_kf12((12,), 37, gen), rand_kf12((12,), 37, gen)
    before = FK.FQ12_MUL_SPARSE.launches
    got = FK.fq12_mul_sparse(a, present, b)
    assert FK.FQ12_MUL_SPARSE.launches == before + 1
    assert_same(got, FK.fq12_mul_sparse_plain(a, present, b))


#: Kernels K16 and K17 run kernel D's blocks of 20 lanes (five-lane warps):
#: 33 and 16389 cut a warp and a block at the edge.
@pytest.mark.parametrize("lanes", [33, 1024, 16389])
def test_pow_ladders_k16_k17_match_plain_and_d(gen, lanes):
    from pairing_tpu_torch.ops import fused_kernels as FU
    from pairing_tpu_torch.ops import klayout as KL
    from pairing_tpu_torch.pairing.final_exp import easy_part_k

    m = easy_part_k(rand_kf12((12,), lanes, gen))
    mc = KL.kconj(m)
    before = (FU.POW_LADDER.launches, FU.POW_LADDER_W4.launches)
    naf = FU.pow_ladder(m, mc, FU.BN_X_LADDER_DIGITS)
    assert FU.POW_LADDER.launches == before[0] + 1
    w4 = FU.pow_ladder_w4(m, FU.BN_X_W4_DIGITS)
    assert FU.POW_LADDER_W4.launches == before[1] + 1
    assert_same(naf, FU.pow_ladder_plain(m, mc, FU.BN_X_LADDER_DIGITS))
    assert_same(w4, FU.pow_ladder_w4_plain(m, FU.BN_X_W4_DIGITS))
    assert_same((naf, w4), (FU.pow_x_streamed(m),) * 2)  # three designs, one value


@pytest.mark.parametrize("ladder, digits", [
    ("naf", [0, -1, 1, 0, -1]), ("w4", [3, 0, -5, 0, 7, -1, 0, 1]),
    ("w4", [7, -7, 0, -3, 5, 0, -1, 3]),
])
@pytest.mark.parametrize("lanes", [1, 33, 16389])
def test_pow_ladders_short_negative_digits_match_oracle(gen, lanes, ladder, digits):
    """K16 and K17 over short digit vectors with negative digits (the CPU
    tests' vectors, and one with every row of K17's table conjugated), on
    four distinct easy-part outputs tiled over the lanes: each call one
    launch, equal to the plain version and, on the distinct lanes, to the
    oracle; every tiled lane equal to its original."""
    from pairing_tpu_torch.fields import fp12 as TF12
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.ops import fq12_kernels as FK
    from pairing_tpu_torch.ops import fused_kernels as FU
    from pairing_tpu_torch.ops import klayout as KL
    from pairing_tpu_torch.utils import bn254 as c

    rng = np.random.default_rng(306)
    xs = [o.easy_part([int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)])
          for _ in range(4)]
    base, _ = FK.to_kernel_layout(TF12.fq12_from_int_coeffs(xs, "cuda"))
    idx = torch.arange(lanes, device="cuda") % len(xs)
    m = base[..., idx].contiguous()
    e = 1 if ladder == "naf" else 0
    for d in digits:
        e = 2 * e + d
    if ladder == "naf":
        mc = KL.kconj(m)
        kernel, before = FU.POW_LADDER, FU.POW_LADDER.launches
        got = FU.pow_ladder(m, mc, digits)
        want = FU.pow_ladder_plain(m, mc, digits)
    else:
        kernel, before = FU.POW_LADDER_W4, FU.POW_LADDER_W4.launches
        got = FU.pow_ladder_w4(m, digits)
        want = FU.pow_ladder_w4_plain(m, digits)
    assert kernel.launches == before + 1
    assert_same(got, want)
    canon = FK.kf12_canonical(got)
    k = min(lanes, len(xs))
    assert torch.equal(canon, canon[..., :k][..., idx])
    ints = TF12.fq12_to_int_coeffs(FK.from_kernel_layout(got[..., :k].contiguous(), (k,)))
    assert ints == [o.pow_fq12(x, e) for x in xs[:k]]


#: K15 runs blocks of 32 lanes, each through the whole program with a
#: barrier after every operation; 33 and 16389 cut one at the edge.
@pytest.mark.parametrize("lanes", [33, 1024, 16389])
def test_hard_chain_kernel_matches_plain_and_unfused(gen, lanes):
    from pairing_tpu_torch.ops import fused_kernels as FU
    from pairing_tpu_torch.pairing.final_exp import easy_part_k, hard_part_chain_k

    xs = [easy_part_k(rand_kf12((12,), lanes, gen)) for _ in range(4)]
    before = FU.HARD_CHAIN.launches
    got = hard_part_chain_k(*xs, fused=True)
    assert FU.HARD_CHAIN.launches == before + 1
    assert_same(got, FU.hard_chain_plain(*xs))
    assert_same(got, hard_part_chain_k(*xs, fused=False))


def test_hard_chain_entry_runs_in_place_programs_and_refuses_bad_ones(gen):
    """K15's C entry on programs other than the chain's: one whose every
    kind of operation writes a register it reads (the kernel's second
    barrier) equals the plain interpreter; programs that
    ``check_chain_program`` refuses are refused by the entry too."""
    from pairing_tpu_torch.ops import dispatch
    from pairing_tpu_torch.ops import fused_kernels as FU
    from pairing_tpu_torch.pairing.final_exp import easy_part_k
    from test_torch_sq_chain_kernels import IN_PLACE_PROG

    lanes = 45
    xs = [easy_part_k(rand_kf12((12,), lanes, gen)) for _ in range(4)]
    _, ops, consts = FU._hard_chain_consts()

    def launch(prog, out_reg):
        host = torch.as_tensor(np.asarray(prog, np.int32).reshape(-1, 4))
        out = torch.empty_like(xs[0])
        FU.HARD_CHAIN(*xs, dispatch.Host(host), len(prog), dispatch.Host(ops),
                      dispatch.Host(consts), out_reg, out, lanes)
        return out

    assert_same(launch(IN_PLACE_PROG, 7),
                FU.hard_chain_plain(*xs, prog=IN_PLACE_PROG, out_reg=7))
    for bad in (((FU.OPC_MUL, 2, 3, 4),), ((FU.OPC_CYC, 4, 1, 0),), ((6, 4, 3, 0),),
                ((FU.OPC_MUL, 8, 3, 3),)):
        with pytest.raises(ValueError):
            FU.check_chain_program(bad)
        with pytest.raises(RuntimeError, match="invalid argument"):
            launch(bad, 5)


def test_fused_chain_pairing_and_split_final_exp_on_card(gen, monkeypatch):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.ops import dispatch
    from pairing_tpu_torch.pairing import final_exp as FE

    g1s, g2s = _seeded_points(3, 14)
    p, q = pt.g1_from_ints(g1s, "cuda"), pt.g2_from_ints(g2s, "cuda")
    want = [o.pairing(a, b) for a, b in zip(g1s, g2s)]
    monkeypatch.setenv("PAIRING_FUSED_CHAIN", "1")
    dispatch.reset_launch_counts()
    assert pt.fq12_to_int_coeffs(pt.pairing(p, q)) == want
    assert dispatch.launch_counts()["hard_chain"] == 1
    monkeypatch.delenv("PAIRING_FUSED_CHAIN")
    f = pt.miller_loop(q, p)
    dispatch.reset_launch_counts()
    out = FE.hard_part(FE.easy_part(f))
    counts = dispatch.launch_counts()
    assert counts["pow_ladder_w4"] == 3 and counts["fq12_inv"] == 1 and counts["hard_chain"] == 0
    assert pt.fq12_to_int_coeffs(out) == want


def test_fq12_pow_on_card_matches_oracle(gen):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.ops import dispatch
    from pairing_tpu_torch.pairing.final_exp import fq12_pow
    from pairing_tpu_torch.utils import bn254 as c

    rng = np.random.default_rng(15)
    coeffs = [[int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)]
              for _ in range(3)]
    a = pt.fq12_from_int_coeffs(coeffs, "cuda")
    for e in (0b101101110101, c.BN_X):
        dispatch.reset_launch_counts()
        got = pt.fq12_to_int_coeffs(fq12_pow(a, e))
        assert dispatch.launch_counts()["fq12_sq"] > 0
        assert got == [o.pow_fq12(x, e) for x in coeffs]


def test_witness_stream_on_card_matches_one_shot(gen):
    """witness_stream on CUDA tensors (a side stream copies chunk i out while
    chunk i + 1 computes): each chunk's host trace equal, leaf for leaf, to
    a one-shot pairing_witness of its lanes."""
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.utils.interop import map_limbs
    from pairing_tpu_torch.witness import pairing_witness
    from pairing_tpu_torch.witness.stream import tensor_leaves, witness_stream

    g1s, g2s = _seeded_points(6, 16)
    p, q = pt.g1_from_ints(g1s, "cuda"), pt.g2_from_ints(g2s, "cuda")
    got = list(witness_stream(p, q, 2))
    assert [start for start, _, _ in got] == [0, 2, 4]
    for start, out, trace in got:
        def cut(limbs):
            return limbs[start:start + 2]

        want = tensor_leaves(pairing_witness(map_limbs(p, cut), map_limbs(q, cut)))
        host = tensor_leaves((out, trace), np.ndarray)
        assert not tensor_leaves((out, trace)) and len(host) == len(want) > 100
        for h, w in zip(host, want):
            assert h.shape == tuple(w.shape)
            np.testing.assert_array_equal(h, w.cpu().numpy())


@pytest.fixture(scope="module")
def nccl_world1(gen):
    """A process group of one rank over NCCL, torn down after the module."""
    import socket

    import torch.distributed as dist
    from pairing_tpu_torch.parallel import launch

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    launch.init_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["fq12_all_reduce_mul", "fq12_reduce_mul_psum_style"])
def test_collectives_world1_over_nccl(gen, nccl_world1, name):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.fields.fp12 import fq12_to_canonical_limbs
    from pairing_tpu_torch.parallel import collectives
    from pairing_tpu_torch.utils import bn254 as c

    rng = np.random.default_rng(17)
    coeffs = [[int.from_bytes(rng.bytes(40), "little") % c.P for _ in range(12)]
              for _ in range(3)]
    f = pt.fq12_from_int_coeffs(coeffs, "cuda")
    out = getattr(collectives, name)(f)
    assert out.device.type == "cuda"
    assert torch.equal(fq12_to_canonical_limbs(out), fq12_to_canonical_limbs(f))


def test_mesh_entry_points_world1_over_nccl(gen, nccl_world1):
    import pairing_tpu_torch as pt
    from pairing_tpu_torch.ops import dispatch
    from pairing_tpu_torch.oracle import native as o
    from pairing_tpu_torch.parallel import mesh as M
    from pairing_tpu_torch.utils.interop import reshape_points

    K, B = 2, 2
    g1s, g2s = _seeded_points(K * B, 18)
    ps = reshape_points(pt.g1_from_ints(g1s, "cuda"), (K, B))
    qs = reshape_points(pt.g2_from_ints(g2s, "cuda"), (K, B))
    dispatch.reset_launch_counts()
    out = M.multi_pairing_sharded(M.make_mesh((1,), ("pairs",)), ps, qs)
    assert dispatch.launch_counts()["miller_f_multi"] == 1
    want = [o.final_exp(o.multi_miller_loop([(g1s[k * B + b], g2s[k * B + b])
                                             for k in range(K)])) for b in range(B)]
    assert pt.fq12_to_int_coeffs(out) == want
    p, q = pt.g1_from_ints(g1s, "cuda"), pt.g2_from_ints(g2s, "cuda")
    shard = M.pairing_data_parallel(M.make_mesh((1,), ("data",)), p, q)
    assert pt.fq12_to_int_coeffs(shard) == [o.pairing(a, b) for a, b in zip(g1s, g2s)]
