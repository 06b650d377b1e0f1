#!/usr/bin/env python3
"""Kernels E and K13: their design variants against the kernels they
replaced, on one CUDA card.

    python3 tools/ek13_variants.py

Builds ``tools/ek13_variants.cu`` (one nvcc, into the git-ignored
``build/ek13_variants/``) beside the port's library, then:

  1. prints ptxas's report and the SASS instruction count (``cuobjdump
     -sass``) of every variant and of the library's kernels E and K13;
  2. kernel E at 16384 lanes (lane 0 zero, lane 1 one, lane 2 limbs of 2^13
     and 2^13 + 1, lane 3 values just below 2p) for the conjugate and the
     powers 1, 2, 3 and 6: holds the wrapper ``klayout.slotwise`` and the
     32 x 12 block variant limb for limb against the committed kernel, that
     kernel against the old one and ``slotwise_plain`` on canonical values
     and in the envelope;
  3. kernel K13 at 16384 lanes x 130 states (the same edge lanes in state
     0): the register and two-thread variants and the wrapper
     ``fq2_vm.affine_export`` in the single-tensor and in the segment form
     (the Miller loop's four segments, six rows a state) limb for limb
     against the committed kernel, the two-thread variant (y as (Y zi)
     zi^2) and the old kernel on canonical values, the committed kernel
     against ``affine_export_plain``;
  4. times each with CUDA events, four turns in alternating order,
     sampling the SM clock before and after each timing: E per program, 20
     launches a turn made back to back by the C side (E takes about as
     long as the host's call through ctypes: launched from Python the
     timing would be the host's; the wrapper's time, so launched, is shown
     beside), K13 10 launches a turn (``tools/fb_variants.py``'s ``timed``);

and prints one JSON line. Any difference raises. Needs a CUDA device and
nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from fb_variants import TURNS, check, clock_mhz, sass, sass_count, timed  # noqa: E402
from pairing_tpu_torch.fields import fp as F  # noqa: E402
from pairing_tpu_torch.ops import build  # noqa: E402
from pairing_tpu_torch.ops import fq12_kernels as FK  # noqa: E402
from pairing_tpu_torch.ops import fq2_vm as VM  # noqa: E402
from pairing_tpu_torch.ops import klayout as KL  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "ek13_variants.cu"
OUT = ROOT / "build" / "ek13_variants"
SEED = 20261020
LANES = 16384
STATES = 130
POWERS = (None, 1, 2, 3, 6)
TIMED_POWERS = (None, 1, 2, 3)  # the main path's programs
E_KINDS = {"old": 0, "committed": 1, "mixed": 2}
K13_KINDS = {"old": 0, "committed": 1, "reg": 2, "pair": 3}
LIBRARY_KERNELS = ("k_fq12_slotwise", "k_affine_export")
REPS_IN_C = 20  # E's launches in one call of h_slot when timed


def build_variants():
    nvcc = build._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    obj, lib = OUT / "ek13_variants.o", OUT / "libek13_variants.so"
    t0 = time.perf_counter()
    r = subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-c", "-o", str(obj),
                        str(SOURCE)], capture_output=True, text=True)
    print(r.stdout + r.stderr, flush=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed on ek13_variants.cu")
    subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", "-o", str(lib), str(obj)], check=True)
    print(f"variants build {time.perf_counter() - t0:.1f} s", flush=True)
    print("variants SASS:", json.dumps({k: sass_count(v) for k, v in sass(obj).items()}),
          flush=True)
    h = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    h.h_slot.argtypes = [i, p, p, p, p, i, i, p]
    h.h_k13.argtypes = [i, p, p, i, p, i, p]
    h.h_slot.restype = h.h_k13.restype = i
    return h


def edge_lanes(a: torch.Tensor) -> torch.Tensor:
    """Rows [R, 21, lanes]: lane 0 zero, lane 1 one (Montgomery) in row 0,
    lane 2 limbs of 2^13 and 2^13 + 1, lane 3 values just below 2p."""
    n = a.shape[0]
    rows = [np.zeros((n, F.NLIMBS), np.int64), np.zeros((n, F.NLIMBS), np.int64)]
    rows[1][0] = F.int_to_limbs(F.R_MONT % F.P)
    rng = np.random.default_rng(SEED)
    settled = rng.integers(0, 4000, (n, F.NLIMBS))
    settled[:, 0:19:2] = 8192 + rng.integers(0, 2, (n, 10))
    settled[:, 19], settled[:, 20] = rng.integers(0, 100, n), 0  # the value stays below 2p
    rows += [settled, np.stack([F.int_to_limbs(2 * F.P - 1 - k) for k in range(n)])]
    for lane, row in enumerate(rows):
        a[:, :, lane] = torch.as_tensor(row, dtype=torch.int32, device=a.device)
    return a


def same(got, want) -> bool:
    return FK.kf12_in_envelope(got) and torch.equal(FK.kf12_canonical(got),
                                                    FK.kf12_canonical(want))


def held(name: str, got, want, committed: bool) -> None:
    """``got`` limb-equal to the committed kernel's ``want``, or (the old
    kernel) equal on canonical values and in the envelope."""
    torch.cuda.synchronize()
    if committed:
        ok = torch.equal(got, want)
        print(f"{name}: limb-equal to the committed kernel: {ok}", flush=True)
    else:
        ok = same(got, want)
        print(f"{name}: equal to the committed kernel (canonical, envelope): {ok}; raw limbs "
              f"equal: {torch.equal(got, want)}", flush=True)
    if not ok:
        bad = (FK.kf12_canonical(got) != FK.kf12_canonical(want)).flatten(0, -2).any(0)
        print(f"{name}: {int(bad.sum())} of {bad.numel()} lanes differ on canonical values, "
              f"the first {bad.nonzero().flatten()[:8].tolist()}", flush=True)
    check(ok, f"{name} differs")


def timed_reps(run, kinds: dict, label: str) -> dict:
    """As tools/fb_variants.py's ``timed``, but each timing is one call of
    run(kind, REPS_IN_C): the C side launches REPS_IN_C times back to back,
    so that the times are the card's and not the host's (the wrapper, kind
    "library", loops in Python and includes its host time)."""
    times = {k: [] for k in kinds}
    clocks = {k: [] for k in kinds}
    names = list(kinds)
    for turn in range(TURNS):
        for name in (names if turn % 2 == 0 else names[::-1]):
            run(kinds[name], 1)
            torch.cuda.synchronize()
            before = clock_mhz()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            run(kinds[name], REPS_IN_C)
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1) / REPS_IN_C)
            clocks[name].append((before, clock_mhz()))
    for k, v in times.items():
        print(f"{label} {k}: ms per launch at {LANES} lanes, turns {[round(t, 5) for t in v]}, "
              f"mean {sum(v) / len(v):.5f}; SM MHz before/after {clocks[k]}", flush=True)
    return {k: {"ms": v, "sm_mhz": clocks[k]} for k, v in times.items()}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    h = build_variants()
    _, info = build.load()
    print(f"library build {info.seconds:.1f} s", flush=True)
    print("library SASS:", json.dumps({k: sass_count(v) for k, v in sass(info.path).items()
                                       if any(s in k for s in LIBRARY_KERNELS)}), flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def call(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: launch failed, CUDA error {err}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    results = {}

    # kernel E
    a = edge_lanes(FK.random_kf12((12,), LANES, gen))
    out = torch.empty_like(a)
    for power in POWERS:
        ops, consts = KL._slot_prog(power)
        host = (torch.as_tensor(ops), torch.as_tensor(consts))
        dev = tuple(t.cuda() for t in host)

        def run_e(kind, reps=1):
            if kind == "library":
                for _ in range(reps):
                    got = KL.slotwise(a, power)
                return got
            prog, cst = dev if kind == E_KINDS["old"] else host
            call(h.h_slot(kind, a.data_ptr(), prog.data_ptr(), cst.data_ptr(), out.data_ptr(),
                          LANES, reps, stream()), f"E kind {kind}")
            return out

        want = run_e(E_KINDS["committed"]).clone()
        check(same(want, KL.slotwise_plain(a, power)), f"E differs from plain, power {power}")
        print(f"E power {power}: committed kernel equal to slotwise_plain, {LANES} lanes",
              flush=True)
        for name in ("library", "mixed", "old"):
            out.fill_(-1)
            got = run_e(E_KINDS.get(name, name))
            held(f"E power {power} {name}", got, want, name != "old")
        if power in TIMED_POWERS:
            results[f"E_{power}"] = timed_reps(run_e, {**E_KINDS, "library": "library"},
                                               f"E power {power}")
    del a, out

    # kernel K13
    xy = FK.random_kf12((STATES, 4), LANES, gen)
    zinv = FK.random_kf12((STATES, 2), LANES, gen)
    xy[0], zinv[0] = edge_lanes(xy[0]), edge_lanes(zinv[0])
    # the same states as the Miller loop's segments: tops, post-doubles, end, end + Q1
    half = (STATES - 2) // 2
    rows6 = torch.zeros((STATES, 6, F.NLIMBS, LANES), dtype=torch.int32, device="cuda")
    rows6[:, 0:4] = xy
    segs = (rows6[:half, 0:4], rows6[half:2 * half, 0:4], rows6[2 * half, 0:4][None],
            rows6[2 * half + 1, 0:4][None])
    out = torch.empty_like(xy)

    def run_k(kind):
        if kind == "library":
            return VM.affine_export(xy, zinv)
        if kind == "segments":
            return VM.affine_export(segs, zinv)
        call(h.h_k13(kind, xy.data_ptr(), zinv.data_ptr(), STATES, out.data_ptr(), LANES,
                     stream()), f"K13 kind {kind}")
        return out

    want = run_k(K13_KINDS["committed"]).clone()
    check(same(want, VM.affine_export_plain(xy, zinv)), "K13 differs from plain")
    print(f"K13: committed kernel equal to affine_export_plain, {LANES} lanes x {STATES} states",
          flush=True)
    for name in ("library", "segments", "reg", "pair", "old"):
        out.fill_(-1)
        got = run_k(K13_KINDS.get(name, name))
        # the pair's y is (Y zi) zi^2, another product order: digits may differ by p
        held(f"K13 {name}", got, want, name not in ("old", "pair"))
    results["K13"] = timed(run_k, {**K13_KINDS, "library": "library", "segments": "segments"},
                           "K13", LANES)
    print(json.dumps({"ek13_variants": results, "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
