// Kernel F: a^e in Fq for a static exponent e >= 1, on Fq tensors [21, lanes]
// (the Fermat inverse a^(p-2) on the main path).
//
// Replaces pairing_tpu/ops/fp_kernels.py:fp_pow_bits_pallas (pallas_call at
// :68, body _pow_kernel), reached through fields.fp.fp_inv. The TPU grid
// walked the exponent bits as a sequential grid axis with the accumulator
// in VMEM scratch and multiplied by one on clear bits; here the whole chain
// runs in one thread per lane.
//
// Bound on the H100: integer multiply-adds. For p - 2 the best sliding
// window (5 bits) takes 253 squares and 53 products, at least 223,188
// 32-bit IMADs a lane (chip_smoke.py's count), against 84 bytes in and out.
// The chain is serial within a lane, so the card needs many lanes in
// flight: at 16384 lanes every SM holds one 128-thread block, a warp per
// scheduler. The first port ran field.cuh's fp_pow_bits here: 64-bit
// columns (IMAD.WIDE), every square a full product, a bit at a time (109
// products for p - 2), the bits read from device memory at every step.
//
// Design: field32.cuh's fp32_pow_w4, kernel G's Fermat chain for any
// exponent: 32-bit columns, a real square (231 limb products), a fixed
// 4-bit window over the table x^1..x^15 (in local memory: the digit indexes
// it at run time; 253 squares and 72 products for p - 2), p's digits as
// immediates. The exponent comes as 32-bit words, least significant first,
// from a small device array that the wrapper caches per (e, device), read
// one word a 32 steps through the read-only cache, the same word in every
// thread. Output below 2p with settled digits; the digits may differ by p
// from the bit chain's.
#include <cuda_runtime.h>

#include "field32.cuh"

namespace pt {

// words[k] of an exponent in device memory, through the read-only cache.
struct DeviceWords {
  const uint32_t* __restrict__ p;
  __device__ __forceinline__ uint32_t operator[](int k) const { return __ldg(p + k); }
};

__global__ void __launch_bounds__(BLOCK)
k_fp_pow_bits(const int32_t* __restrict__ a, const uint32_t* __restrict__ words, int top,
              int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fp x;
  load_fp(x, a + lane, n);
  store_fp(fp32_pow_w4(x, DeviceWords{words}, top), out + lane, n);
}

}  // namespace pt

// ``words``: the n_words 32-bit words of e in device memory, least
// significant first; ``top``: the bit of e's leading one (below 32 n_words).
extern "C" int pt_fp_pow_bits(const int32_t* a, const int32_t* words, int n_words, int top,
                              int32_t* out, int lanes, void* stream) {
  if (top < 0 || top >= 32 * n_words) return (int)cudaErrorInvalidValue;
  if (lanes > 0) {
    const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
    pt::k_fp_pow_bits<<<blocks, pt::BLOCK, 0, (cudaStream_t)stream>>>(
        a, (const uint32_t*)words, top, out, lanes);
  }
  return (int)cudaGetLastError();
}
