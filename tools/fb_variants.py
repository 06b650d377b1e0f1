#!/usr/bin/env python3
"""Kernels F and B: their design variants against the kernels they
replaced, and the card's 32-bit IMAD rate, on one CUDA card.

    python3 tools/fb_variants.py

Builds ``tools/fb_variants.cu`` (one nvcc, into the git-ignored
``build/fb_variants/``) beside the port's library, then:

  1. prints ptxas's report and the SASS instruction count (``cuobjdump
     -sass``) of every variant and of the library's kernels F and B, and
     the IMAD count of the throughput loop's body;
  2. kernel F for p - 2, at 16384 and 65,536 lanes (lane 0 zero, lane 1
     one): holds the words-in-a-kernel-parameter variant, the compiled-in
     p - 2 (``fp32_inv``) and the wrapper ``fp_kernels.fp_pow_bits`` limb
     for limb against the committed kernel (the words in a device array),
     that kernel against the old one and ``fp_pow_bits_plain`` on
     canonical values and in the envelope; the same for e = 0b1011001 and
     a 300-bit e (no compiled-in variant) and a 600-bit e (neither: longer
     than the parameter's 16 words);
  3. kernel B at 16384 and 65,536 lanes, on cyclotomic and on random
     inputs: holds the L1 variant and the wrapper
     ``klayout.kcyc_sq`` limb for limb against the committed kernel, that
     kernel against the old one and ``kcyc_sq_plain`` (16384 lanes) on
     canonical values and in the envelope;
  4. times each at 16384 and 65,536 lanes with CUDA events, 10 launches a
     turn, four turns in alternating order, sampling ``nvidia-smi
     --query-gpu=clocks.sm`` before and after each timing;
  5. times the IMAD loop (132 x 8 blocks of 256 threads, 8 independent
     chains a thread) three times and prints IMADs per SM per clock at the
     sampled clock, against the 64 that ``chip_smoke.py`` assumes;

and prints one JSON line. Any difference raises. Needs a CUDA device and
nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from pairing_tpu_torch.fields import fp as F  # noqa: E402
from pairing_tpu_torch.ops import build  # noqa: E402
from pairing_tpu_torch.ops.build import sass, sass_count  # noqa: E402
from pairing_tpu_torch.ops import fq12_kernels as FK  # noqa: E402
from pairing_tpu_torch.ops import klayout as KL  # noqa: E402
from pairing_tpu_torch.ops.fp_kernels import (exponent_words, fp_pow_bits,  # noqa: E402
                                              fp_pow_bits_plain)
from pairing_tpu_torch.pairing.final_exp import easy_part_k  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "fb_variants.cu"
OUT = ROOT / "build" / "fb_variants"
SEED = 20261019
REPS, TURNS = 10, 4
LANE_COUNTS = (16384, 65536)
F_KINDS = {"old": 0, "words_device": 1, "words_param": 2, "pm2_compiled": 3}
F_PARAM_WORDS = 16  # the by-value variant's words (fb_variants.cu)
B_KINDS = {"old": 0, "shared": 1, "l1": 2}
LIBRARY_KERNELS = ("k_fp_pow_bits", "k_fq12_cyc_sq")
SMS, IMAD_BLOCKS_PER_SM, IMAD_THREADS, IMAD_ITERS = 132, 8, 256, 4096


def long_exponent(bits: int, seed: int) -> int:
    """A seeded exponent whose leading one is bit ``bits`` - 1 (the card
    cases' 300- and 600-bit exponents)."""
    rng = np.random.default_rng(seed)
    return int.from_bytes(rng.bytes(bits // 8 + 1), "little") % (1 << (bits - 1)) | (
        1 << (bits - 1))


def build_variants():
    nvcc = build._nvcc()
    OUT.mkdir(parents=True, exist_ok=True)
    obj, lib = OUT / "fb_variants.o", OUT / "libfb_variants.so"
    t0 = time.perf_counter()
    r = subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-c", "-o", str(obj),
                        str(SOURCE)], capture_output=True, text=True)
    print(r.stdout + r.stderr, flush=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed on fb_variants.cu")
    subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", "-o", str(lib), str(obj)], check=True)
    print(f"variants build {time.perf_counter() - t0:.1f} s", flush=True)
    text = sass(obj)
    print("variants SASS:", json.dumps({k: sass_count(v) for k, v in text.items()}), flush=True)
    loop = next(v for k, v in text.items() if "k_imad_rate" in k)
    imads = len(re.findall(r"\bIMAD\b", loop))
    h = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    h.h_fpow.argtypes = [i, p, p, i, p, p, i, i, p, i, p]
    h.h_cyc.argtypes = [i, p, p, i, p]
    h.h_imad.argtypes = [p, ctypes.c_uint32, ctypes.c_uint32, i, i, p]
    h.h_fpow.restype = h.h_cyc.restype = h.h_imad.restype = h.h_imad_per_thread_iter.restype = i
    print(f"IMAD loop: {imads} IMAD in k_imad_rate's SASS, "
          f"{h.h_imad_per_thread_iter()} a thread and iteration in the source", flush=True)
    return h


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0].split()[0])


def timed(run, kinds: dict, label: str, lanes: int) -> dict:
    """Four turns of REPS launches each, kinds in alternating order; the SM
    clock sampled before and after each timing."""
    times = {k: [] for k in kinds}
    clocks = {k: [] for k in kinds}
    names = list(kinds)
    for turn in range(TURNS):
        for name in (names if turn % 2 == 0 else names[::-1]):
            run(kinds[name])
            torch.cuda.synchronize()
            before = clock_mhz()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(REPS):
                run(kinds[name])
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1) / REPS)
            clocks[name].append((before, clock_mhz()))
    for k, v in times.items():
        print(f"{label} {k}: ms per launch at {lanes} lanes, turns {[round(t, 4) for t in v]}, "
              f"mean {sum(v) / len(v):.4f}; SM MHz before/after {clocks[k]}", flush=True)
    return {k: {"ms": v, "sm_mhz": clocks[k]} for k, v in times.items()}


def edge_lanes(a: torch.Tensor) -> torch.Tensor:
    """Lane 0 zero, lane 1 one (Montgomery) in component 0, zero elsewhere."""
    a[..., 0] = 0
    a[..., 1] = 0
    a.view(-1, F.NLIMBS, a.shape[-1])[0, :, 1] = torch.as_tensor(
        F.int_to_limbs(F.R_MONT % F.P), device=a.device)
    return a


def same(got, want) -> bool:
    return FK.kf12_in_envelope(got) and torch.equal(FK.kf12_canonical(got),
                                                    FK.kf12_canonical(want))


def imad_rate(h, stream) -> dict:
    blocks = SMS * IMAD_BLOCKS_PER_SM
    out = torch.empty(blocks * IMAD_THREADS, dtype=torch.int32, device="cuda")
    per_thread = IMAD_ITERS * h.h_imad_per_thread_iter()

    def run():
        err = h.h_imad(out.data_ptr(), 0x9E3779B1, 7, IMAD_ITERS, blocks, stream())
        if err != 0:
            raise RuntimeError(f"IMAD loop: launch failed, CUDA error {err}")

    run()
    torch.cuda.synchronize()
    turns = []
    for _ in range(3):
        before = clock_mhz()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        after = clock_mhz()
        ms = e0.elapsed_time(e1)
        mhz = (before + after) / 2
        rate = blocks * IMAD_THREADS * per_thread / (ms * 1e-3 * SMS * mhz * 1e6)
        turns.append({"ms": ms, "sm_mhz": (before, after), "imads_per_sm_clock": rate})
        print(f"IMAD loop: {blocks * IMAD_THREADS * per_thread:.4e} IMADs in {ms:.4f} ms, SM "
              f"{before:.0f}/{after:.0f} MHz: {rate:.2f} IMADs per SM per clock", flush=True)
    return {"turns": turns}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    h = build_variants()
    lib, info = build.load()
    print(f"library build {info.seconds:.1f} s", flush=True)
    print("library SASS:", json.dumps({k: sass_count(v) for k, v in sass(info.path).items()
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
    results = {"imad_rate": imad_rate(h, stream)}
    for lanes in LANE_COUNTS:
        # kernel F
        x = edge_lanes(FK.random_kf12((), lanes, gen))
        out = torch.empty_like(x)
        for e in (F.P - 2, 0b1011001, long_exponent(300, 1130), long_exponent(600, 1140)):
            words, top = exponent_words(e, torch.device("cuda"))
            host_words = words.cpu()
            bits = torch.tensor([int(b) for b in bin(e)[3:]], dtype=torch.int32, device="cuda")

            def run_f(kind):
                if kind == "library":
                    return fp_pow_bits(x, e)
                call(h.h_fpow(kind, x.data_ptr(), bits.data_ptr(), bits.numel(),
                              words.data_ptr(), host_words.data_ptr(), words.numel(), top,
                              out.data_ptr(), lanes, stream()), f"F kind {kind}")
                return out

            want = run_f(F_KINDS["words_device"]).clone()
            canon = FK.kf12_canonical(want)
            check(bool((canon[:, 0] == 0).all()), "F: the zero lane is not zero")
            check(torch.equal(canon[:, 1], FK.kf12_canonical(x)[:, 1]), "F: the one lane")
            kinds = (["library", "old"] + (["words_param"] if words.numel() <= F_PARAM_WORDS
                                           else [])
                     + (["pm2_compiled"] if e == F.P - 2 else []))
            for name in kinds:
                out.fill_(-1)
                got = run_f(F_KINDS.get(name, name))
                torch.cuda.synchronize()
                if name == "old":
                    ok = same(got, want)
                    print(f"F e={e:#x}: old equal to the committed kernel (canonical, envelope), "
                          f"{lanes} lanes: {ok}; raw limbs equal: {torch.equal(got, want)}",
                          flush=True)
                else:
                    ok = torch.equal(got, want)
                    print(f"F e={e:#x}: {name} limb-equal to the committed kernel, {lanes} "
                          f"lanes: {ok}", flush=True)
                check(ok, f"F {name} differs at {lanes} lanes, e = {e:#x}")
            check(same(want, fp_pow_bits_plain(x, e)), f"F differs from plain, e = {e:#x}")
            if e == F.P - 2:
                results[f"F_{lanes}"] = timed(run_f, {**F_KINDS, "library": "library"}, "F",
                                              lanes)
        del x, out

        # kernel B
        a = FK.random_kf12((12,), lanes, gen)
        for inputs, m in (("cyclotomic", easy_part_k(a)), ("random", a)):
            out = torch.empty_like(m)

            def run_b(kind):
                if kind == "library":
                    return KL.kcyc_sq(m)
                call(h.h_cyc(kind, m.data_ptr(), out.data_ptr(), lanes, stream()),
                     f"B kind {kind}")
                return out

            want = run_b(B_KINDS["shared"]).clone()
            for name in ("library", "l1", "old"):
                out.fill_(-1)
                got = run_b(B_KINDS.get(name, name))
                torch.cuda.synchronize()
                if name == "old":
                    ok = same(got, want)
                    print(f"B {inputs}: old equal to the committed kernel (canonical, envelope), "
                          f"{lanes} lanes: {ok}; raw limbs equal: {torch.equal(got, want)}",
                          flush=True)
                else:
                    ok = torch.equal(got, want)
                    print(f"B {inputs}: {name} limb-equal to the committed kernel, {lanes} "
                          f"lanes: {ok}", flush=True)
                check(ok, f"B {name} differs at {lanes} lanes ({inputs})")
            if lanes == LANE_COUNTS[0]:
                check(same(want, KL.kcyc_sq_plain(m)), f"B differs from plain ({inputs})")
                print(f"B {inputs}: committed kernel equal to kcyc_sq_plain, {lanes} lanes",
                      flush=True)
            if inputs == "cyclotomic":
                results[f"B_{lanes}"] = timed(run_b, {**B_KINDS, "library": "library"}, "B",
                                              lanes)
            del out, want
        del a
        torch.cuda.empty_cache()
    print(json.dumps({"fb_variants": results, "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
