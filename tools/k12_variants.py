#!/usr/bin/env python3
"""Kernel K12's design variants against the kernel it replaced, on one CUDA card.

    python3 tools/k12_variants.py

Builds ``tools/k12_variants.cu`` (one nvcc, into the git-ignored
``build/k12_variants/``) beside the port's library, then:

  1. prints ptxas's report and the SASS instruction count (``cuobjdump
     -sass``) of every variant, of the library's ``k_exp_bits`` and of
     kernel D's ``k_pow_ladder_stream``;
  2. holds every variant, the library's kernel and the wrapper
     ``fused_kernels.exp_bits_ladder`` limb for limb against the
     one-thread-per-lane kernel, at 16384 and 65,536 lanes of easy-part
     outputs, on BN_X's bits and on a string with a leading set bit and
     runs of ones and zeros (the variants that store only the last row, on
     that row); any difference raises;
  3. times each at 16384 lanes on BN_X's bits with CUDA events, 10 launches
     a turn, four turns in alternating order, and prints the turns, their
     means and one JSON line.

Variants (``k_var<RESIDENT, STORE>``): x reloaded from device memory on
every set bit (0) or resident in shared memory (1); every row stored by the
rank that wrote its slot (1), the last row only (0), or the block's row
staged in shared memory and written as 80-byte runs (2). ``(1, 1)`` is the
design of ``pairing_tpu_torch/csrc/exp_bits.cu``. Needs a CUDA device and
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

from pairing_tpu_torch.ops import build  # noqa: E402
from pairing_tpu_torch.ops import fq12_kernels as FK  # noqa: E402
from pairing_tpu_torch.ops import fused_kernels as FU  # noqa: E402
from pairing_tpu_torch.pairing.final_exp import easy_part_k  # noqa: E402

SOURCE = Path(__file__).resolve().parent / "k12_variants.cu"
OUT = ROOT / "build" / "k12_variants"
RUNS = np.asarray([1, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 0, 0, 0, 1],
                  np.int32)
VARIANTS = [(0, 1), (0, 0), (0, 2), (1, 1), (1, 0), (1, 2)]  # (resident, store)
LAST_ROW_ONLY = ((0, 0), (1, 0))
SEED = 20261017
REPS, TURNS = 10, 4


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
    obj, lib = OUT / "k12_variants.o", OUT / "libk12_variants.so"
    t0 = time.perf_counter()
    r = subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", str(build.CSRC), "-c", "-o", str(obj),
                        str(SOURCE)], capture_output=True, text=True)
    print(r.stdout + r.stderr, flush=True)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed on k12_variants.cu")
    subprocess.run([nvcc, *build.ARCH_FLAGS, "-shared", "-o", str(lib), str(obj)], check=True)
    print(f"variants build {time.perf_counter() - t0:.1f} s", flush=True)
    print("variants SASS:", json.dumps(sass_counts(obj)), flush=True)
    h = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    h.h_old.argtypes = [p, p, i, p, i, p]
    h.h_var.argtypes = [i, i, p, p, i, p, i, p]
    h.h_old.restype = h.h_var.restype = i
    return h


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    h = build_variants()
    lib, info = build.load()
    print(f"library build {info.seconds:.1f} s", flush=True)
    print("library SASS:", json.dumps({k: v for k, v in sass_counts(info.path).items()
                                       if "exp_bits" in k or "pow_ladder_stream" in k}),
          flush=True)

    def run(kind, x, bits, rows):
        args = (x.data_ptr(), bits.data_ptr(), len(bits), rows.data_ptr(), x.shape[-1],
                torch.cuda.current_stream().cuda_stream)
        if kind == "old":
            err = h.h_old(*args)
        elif kind == "library":
            err = lib.pt_exp_bits(*args)
        else:
            err = h.h_var(*kind, *args)
        if err != 0:
            raise RuntimeError(f"{kind}: launch failed, CUDA error {err}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for lanes in (16384, 65536):
        x = easy_part_k(FK.random_kf12((12,), lanes, gen))
        for name, bits in (("bn_x", FU.BN_X_BITS_MSB), ("runs", RUNS)):
            bt = torch.as_tensor(bits, device="cuda")
            want = torch.empty((len(bits), 12, 21, lanes), dtype=torch.int32, device="cuda")
            run("old", x, bt, want)
            got = torch.empty_like(want)
            for kind in ["library"] + VARIANTS:
                got.fill_(-1)
                run(kind, x, bt, got)
                torch.cuda.synchronize()
                same = (torch.equal(got[-1], want[-1]) if kind in LAST_ROW_ONLY
                        else torch.equal(got, want))
                print(f"{kind} equal to the old kernel, {lanes} lanes, bits {name}: {same}",
                      flush=True)
                if not same:
                    raise AssertionError(f"{kind} differs from the old kernel")
            _, rows = FU.exp_bits_ladder(x, bits)
            torch.cuda.synchronize()
            if not torch.equal(rows, want):
                raise AssertionError(f"exp_bits_ladder differs, {lanes} lanes, bits {name}")
            print(f"exp_bits_ladder equal to the old kernel, {lanes} lanes, bits {name}: True",
                  flush=True)
            del want, got, rows
        del x
    torch.cuda.empty_cache()

    lanes = 16384
    x = easy_part_k(FK.random_kf12((12,), lanes, gen))
    bt = torch.as_tensor(FU.BN_X_BITS_MSB, device="cuda")
    rows = torch.empty((len(bt), 12, 21, lanes), dtype=torch.int32, device="cuda")
    kinds = ["old", "library"] + VARIANTS
    times = {str(k): [] for k in kinds}
    for turn in range(TURNS):
        for kind in (kinds if turn % 2 == 0 else kinds[::-1]):
            run(kind, x, bt, rows)
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(REPS):
                run(kind, x, bt, rows)
            e1.record()
            torch.cuda.synchronize()
            times[str(kind)].append(e0.elapsed_time(e1) / REPS)
    for k, v in times.items():
        print(f"K12 {k}: ms per launch at {lanes} lanes, turns {[round(t, 4) for t in v]}, "
              f"mean {sum(v) / len(v):.4f}", flush=True)
    print(json.dumps({"k12_variants_ms": times, "lanes": lanes, "device":
                      torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
