// Kernel A: Fq12 product, out = a * b, on KF12 tensors [12, 21, lanes], dense
// or sparse: only the slots of b named in the 6-bit mask ``present`` are read
// (0x3f dense; 0x19 and 0x2c the tangent and chord line shapes 034 and 235).
//
// Replaces pairing_tpu/ops/fq12_kernels.py:_pallas_mul (pallas_call at :275),
// both patterns: dense (core _mul_core_v3), reached through klayout.kmul, and
// sparse (core _sparse_core_v2), reached through klayout.kmul_sparse. The
// sparse mode issues 72 of the 144 Fq products for a three-slot line.
// On the TPU it runs on (8, 128) tiles padded to 1024 lanes; here each
// thread owns one lane and the grid masks the ragged edge itself.
//
// Bound on the H100: integer multiply-adds. The product needs at least 54
// Fq products (Karatsuba) of 441 32-bit IMADs and 12 reductions of 462,
// about 29 k per lane (the least count in chip_smoke.py); this kernel issues
// 144 schoolbook Fq products of 441 IMAD.WIDE each. Against 2 x 1008 bytes
// read and 1008 bytes written per lane that is above the card's op-per-byte
// line. The operands (3 x 252 words) do not fit the
// register file, so they sit in L1-cached local memory; the simple design
// accepts the spills and launches 128-thread blocks, one lane per thread.
#include <cuda_runtime.h>

#include "field.cuh"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_fq12_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
           unsigned present, int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fq12 x, y, z;
  load_fq12(x, a + lane, n);
#pragma unroll 1
  for (int i = 0; i < 6; ++i) {  // absent slots of b are never read
    if ((present >> i) & 1u) {
      load_fp(y.c[2 * i], b + 2 * i * NL * n + lane, n);
      load_fp(y.c[2 * i + 1], b + (2 * i + 1) * NL * n + lane, n);
    }
  }
  fq12_mul(x, y, present, z);
  store_fq12(z, out + lane, n);
}

}  // namespace pt

extern "C" int pt_fq12_mul(const int32_t* a, const int32_t* b, int present, int32_t* out,
                           int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
    pt::k_fq12_mul<<<blocks, pt::BLOCK, 0, (cudaStream_t)stream>>>(
        a, b, (unsigned)present & pt::DENSE, out, lanes);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
