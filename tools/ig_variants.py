#!/usr/bin/env python3
"""Kernels I and G: their design variants against the kernels they
replaced, on one CUDA card.

    python3 tools/ig_variants.py

Builds ``tools/ig_variants.cu`` (one nvcc, into the git-ignored
``build/ig_variants/``) beside the port's library, then:

  1. prints ptxas's report and the SASS instruction count (``cuobjdump
     -sass``) of every variant and of the library's kernels I, G (its three
     stages), J and F;
  2. kernel I, 130 steps: holds every variant and the wrapper
     ``norm_kernels.prefix_products`` limb for limb against the
     one-thread-per-lane kernel at 16384 and 65,536 lanes, that kernel
     against the plain version on canonical values, and counts the values
     whose digits differ from the plain version's after an exact carry;
  3. kernel G: holds the old kernel with only its chain replaced limb for
     limb against the old kernel, and every other variant and the wrapper
     ``klayout.kinv`` on canonical values and in the envelope, at 16384 and
     65,536 lanes, where lane 0 is zero and lane 1 is one (each must come
     back as itself); at 16384 also against ``kinv_plain``;
  4. times each at 16384 and 65,536 lanes with CUDA events, 10 launches a
     turn, four turns in alternating order, and G's stages alone beside
     kernel F (``fp_kernels.fp_pow_bits`` for p - 2: the same power as G's
     chain, one thread per lane); prints the turns, their means and one
     JSON line.

Any difference raises. Needs a CUDA device and nvcc; prints the card's name
and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pairing_tpu_torch.fields import fp as F  # noqa: E402
from pairing_tpu_torch.ops import build  # noqa: E402
from pairing_tpu_torch.ops import fq12_kernels as FK  # noqa: E402
from pairing_tpu_torch.ops import klayout as KL  # noqa: E402
from pairing_tpu_torch.ops import norm_kernels as NK  # noqa: E402
from pairing_tpu_torch.ops.fp_kernels import fp_pow_bits  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "ig_variants.cu"
OUT = ROOT / "build" / "ig_variants"
SEED = 20261018
REPS, TURNS = 10, 4
N_STEPS = 130  # Phase N's stack: 2 x 64 loop steps + 2
LANE_COUNTS = (16384, 65536)
I_KINDS = {"old": 0, "i2": 1, "i2_cap8": 2, "i4": 3, "i4_cap8": 4}
G_KINDS = {"old": 0, "old_chain32": 1, "stages_bits": 2, "stages_w4": 3, "fused_bits": 4,
           "fused_w4": 5}
G_STAGES = {"stage1_norm": 6, "stage2_chain_bits": 7, "stage3_out": 8, "stage2_chain_w4": 9}
LIBRARY_KERNELS = ("k_prefix_products", "k_running_inverse", "k_fq12_inv", "k_fp_pow_bits")


def sass_counts(path: Path) -> dict:
    """Instructions per function in ``cuobjdump -sass`` of an object or library."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True,
                         check=True).stdout
    counts = {}
    for part in out.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        counts[name] = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/", part, re.M))
    return counts


def build_variants() -> ctypes.CDLL:
    nvcc = build._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    obj, lib = OUT / "ig_variants.o", OUT / "libig_variants.so"
    t0 = time.perf_counter()
    r = subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-c", "-o", str(obj),
                        str(SOURCE)], capture_output=True, text=True)
    print(r.stdout + r.stderr, flush=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed on ig_variants.cu")
    subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", "-o", str(lib), str(obj)], check=True)
    print(f"variants build {time.perf_counter() - t0:.1f} s", flush=True)
    print("variants SASS:", json.dumps(sass_counts(obj)), flush=True)
    h = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    h.h_prefix.argtypes = [i, p, i, p, p, i, p]
    h.h_inv.argtypes = [i, p, p, i, p, p, i, p]
    h.h_prefix.restype = h.h_inv.restype = i
    return h


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def carried(t: torch.Tensor) -> torch.Tensor:
    """Digits in [0, 2^13) of the same integers ([..., 21, lanes])."""
    return F._ripple_carry(t.transpose(-1, -2))[0]


def edge_lanes(a: torch.Tensor) -> torch.Tensor:
    """Lane 0 zero, lane 1 one (Montgomery)."""
    a[..., 0] = 0
    a[..., 1] = 0
    a[0, :, 1] = torch.as_tensor(F.int_to_limbs(F.R_MONT % F.P), device=a.device)
    return a


def timed(run, kinds: dict, label: str, lanes: int) -> dict:
    """Four turns of REPS launches each, kinds in alternating order."""
    times = {k: [] for k in kinds}
    names = list(kinds)
    for turn in range(TURNS):
        for name in (names if turn % 2 == 0 else names[::-1]):
            run(kinds[name])
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(REPS):
                run(kinds[name])
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1) / REPS)
    for k, v in times.items():
        print(f"{label} {k}: ms per launch at {lanes} lanes, turns {[round(t, 4) for t in v]}, "
              f"mean {sum(v) / len(v):.4f}", flush=True)
    return times


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    h = build_variants()
    lib, info = build.load()
    print(f"library build {info.seconds:.1f} s", flush=True)
    print("library SASS:", json.dumps({k: v for k, v in sass_counts(info.path).items()
                                       if any(s in k for s in LIBRARY_KERNELS)}), flush=True)
    for line in info.ptxas.splitlines():
        if any(s in line for s in LIBRARY_KERNELS) or "registers" in line or "spill" in line:
            print("library ptxas:", line.strip())
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def call(err, what):
        if err != 0:
            raise RuntimeError(f"{what}: launch failed, CUDA error {err}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    # p - 2's bits after its leading one, for the old kernel's fp_pow_bits
    bits = torch.tensor([int(b) for b in bin(F.P - 2)[3:]], dtype=torch.int32,
                        device="cuda")
    results = {}
    for lanes in LANE_COUNTS:
        # kernel I
        z = FK.random_kf12((N_STEPS, 2), lanes, gen)
        prefix, total = torch.empty_like(z), torch.empty_like(z[0])

        def run_i(kind):
            if kind == "library":
                return NK.prefix_products(z)
            call(h.h_prefix(kind, z.data_ptr(), N_STEPS, prefix.data_ptr(), total.data_ptr(),
                            lanes, stream()), f"I kind {kind}")
            return prefix, total

        want = tuple(x.clone() for x in run_i(0))
        for name, kind in list(I_KINDS.items())[1:] + [("library", "library")]:
            prefix.fill_(-1)
            total.fill_(-1)
            got = run_i(kind)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            print(f"I {name} limb-equal to the old kernel, {lanes} lanes: {same}", flush=True)
            check(same, f"I {name} differs from the old kernel at {lanes} lanes")
        plain = NK.prefix_products_plain(z)
        same = all(torch.equal(FK.kf12_canonical(g), FK.kf12_canonical(w))
                   for g, w in zip(want, plain))
        raw = sum(int((carried(g) != carried(w)).any(-1).sum()) for g, w in zip(want, plain))
        print(f"I old kernel against the plain version, {lanes} lanes: canonical values equal "
              f"{same}; values whose digits differ after a carry {raw} of "
              f"{(N_STEPS + 1) * 2 * lanes}", flush=True)
        check(same, "I: the old kernel differs from the plain version")
        del plain
        results[f"I_{lanes}"] = timed(run_i, {**I_KINDS, "library": "library"}, "I", lanes)
        del z, prefix, total, want

        # kernel G
        a = edge_lanes(FK.random_kf12((12,), lanes, gen))
        out = torch.empty_like(a)
        scratch = torch.empty((KL.INV_SCRATCH_ROWS, F.NLIMBS, lanes), dtype=torch.int32,
                              device="cuda")

        xf = FK.random_kf12((), lanes, gen)

        def run_g(kind):
            if kind == "library":
                return KL.kinv(a)
            if kind == "F":
                return fp_pow_bits(xf, F.P - 2)
            call(h.h_inv(kind, a.data_ptr(), bits.data_ptr(), bits.numel(), scratch.data_ptr(),
                         out.data_ptr(), lanes, stream()), f"G kind {kind}")
            return out

        want = run_g(0).clone()
        canon = FK.kf12_canonical(want)
        check(bool((canon[..., 0] == 0).all()), "G old: the zero lane is not zero")
        check(torch.equal(canon[..., 1:2], FK.kf12_canonical(a[..., 1:2])),
              "G old: the one lane is not one")
        for name, kind in list(G_KINDS.items())[1:] + [("library", "library")]:
            out.fill_(-1)
            got = run_g(kind)
            torch.cuda.synchronize()
            if name == "old_chain32":
                same = torch.equal(got, want)
                print(f"G {name} limb-equal to the old kernel, {lanes} lanes: {same}", flush=True)
            else:
                same = FK.kf12_in_envelope(got) and torch.equal(FK.kf12_canonical(got), canon)
                print(f"G {name} equal to the old kernel (canonical, envelope), {lanes} lanes: "
                      f"{same}; raw limbs equal: {torch.equal(got, want)}", flush=True)
            check(same, f"G {name} differs from the old kernel at {lanes} lanes")
        if lanes == LANE_COUNTS[0]:
            same = torch.equal(FK.kf12_canonical(KL.kinv_plain(a)), canon)
            print(f"G old kernel equal to kinv_plain, {lanes} lanes: {same}", flush=True)
            check(same, "G: the old kernel differs from kinv_plain")
        results[f"G_{lanes}"] = timed(run_g, {**G_KINDS, "library": "library"}, "G", lanes)
        results[f"G_stages_{lanes}"] = timed(run_g, {**G_STAGES, "F_fp_pow_bits": "F"}, "G", lanes)
        del a, out, scratch, want, canon, xf
        torch.cuda.empty_cache()
    print(json.dumps({"ig_variants_ms": results, "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
