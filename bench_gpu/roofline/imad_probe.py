#!/usr/bin/env python3
"""What a 32 x 32 -> 64-bit product costs on the card, for the roofline's
word costs (``roofline/__init__.py``).

    python3 bench_gpu/roofline/imad_probe.py

Builds three kernels with nvcc (into ``build/bench_gpu/imad_probe/`` in the
checkout), each a loop of eight independent chains of one PTX instruction a
step: ``mad.lo.u32`` (a 32-bit IMAD), ``mad.hi.u32`` and ``mad.wide.u32``
(the full 64-bit product). Prints each instruction's rate per SM and clock
over a full grid (CUDA events, and the SM clock that ``nvidia-smi`` reads
before and after) and each kernel's SASS instructions by opcode. Needs a
CUDA card and nvcc; not part of a benchmark run.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "bench_gpu" / "imad_probe"
ITERS = 4096
THREADS = 256
BLOCKS_PER_SM = 8

SOURCE = r"""
#include <cstdint>
#define CHAINS 8
// each chain feeds its own result back as a factor, so no product can be
// hoisted out of the loop or folded into an addition
#define BODY(INSN, T)                                                          \
  T acc[CHAINS];                                                               \
  uint32_t b = blockIdx.x * 40503u + 1u, c = threadIdx.x * 2654435761u + seed; \
  for (int j = 0; j < CHAINS; j++) acc[j] = (T)(c + j);                        \
  for (int i = 0; i < iters; i++) {                                            \
    _Pragma("unroll") for (int j = 0; j < CHAINS; j++) INSN;                   \
  }                                                                            \
  T s = 0;                                                                     \
  for (int j = 0; j < CHAINS; j++) s ^= acc[j];                                \
  if (s == (T)7) out[0] = 1;

extern "C" __global__ void k_lo(uint32_t* out, int iters, uint32_t seed) {
  BODY(asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(acc[j]) : "r"(b), "r"(c)), uint32_t)
}
extern "C" __global__ void k_hi(uint32_t* out, int iters, uint32_t seed) {
  BODY(asm volatile("mad.hi.u32 %0, %0, %1, %2;" : "+r"(acc[j]) : "r"(b), "r"(c)), uint32_t)
}
extern "C" __global__ void k_wide(uint32_t* out, int iters, uint32_t seed) {
  BODY(asm volatile("{ .reg .u32 lo; cvt.u32.u64 lo, %0; mad.wide.u32 %0, lo, %1, %0; }"
                    : "+l"(acc[j]) : "r"(b)), uint64_t)
}
extern "C" int launch(int which, int blocks, int threads, uint32_t* out, int iters) {
  void (*k[3])(uint32_t*, int, uint32_t) = {k_lo, k_hi, k_wide};
  k[which]<<<blocks, threads>>>(out, iters, 12345u);
  return (int)cudaGetLastError();
}
"""


def _sm_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def main() -> int:
    if not torch.cuda.is_available():
        print("imad_probe: needs a CUDA device", file=sys.stderr)
        return 1
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "probe.cu", OUT / "libprobe.so"
    src.write_text(SOURCE)
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    subprocess.run([str(nvcc), *arch, "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(lib),
                    str(src)], check=True)
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    so = ctypes.CDLL(str(lib))
    so.launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    result = {"card": torch.cuda.get_device_name(0), "sms": sms}
    for which, name in enumerate(("mad.lo.u32", "mad.hi.u32", "mad.wide.u32")):
        assert so.launch(which, blocks, THREADS, out.data_ptr(), ITERS) == 0
        torch.cuda.synchronize()  # the first launch loads the module
        mhz = _sm_mhz()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        assert so.launch(which, blocks, THREADS, out.data_ptr(), ITERS) == 0
        stop.record()
        torch.cuda.synchronize()
        mhz = (mhz + _sm_mhz()) / 2
        per_sm = BLOCKS_PER_SM * THREADS * ITERS * 8
        grid_s = start.elapsed_time(stop) / 1e3
        body = sass.split(f"Function : k_{('lo', 'hi', 'wide')[which]}")[1].split("Function :")[0]
        ops = sorted(set(re.findall(r"\b(IMAD[.A-Z0-9]*)\b", body)))
        loop = re.findall(r"^\s+/\*[0-9a-f]{4}\*/\s+([A-Z][A-Z0-9_.]*)", body, re.M)
        result[name] = {"per_sm_clock": per_sm / (grid_s * mhz * 1e6), "sm_mhz": mhz,
                        "sass_imad": ops,
                        "sass_counts": {op: loop.count(op) for op in sorted(set(loop))}}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
