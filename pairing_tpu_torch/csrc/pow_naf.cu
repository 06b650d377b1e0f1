// Kernel K16: the plain-NAF cyclotomic x-power ladder, out = m^e, where
// ``digits`` are the MSB-first NAF digits of e after its leading one
// (BN_X_LADDER_DIGITS: 62 digits, 23 of them nonzero).
//
// Replaces pairing_tpu/ops/fused_kernels.py:pow_ladder_pallas (pallas_call
// at :355, body _pow_kernel :281). The ladder starts at m; per digit it
// squares (Granger-Scott, valid on the cyclotomic subgroup) and multiplies by
// m on +1, by mc = conj(m) on -1, by nothing on 0. The TPU walked the digits
// as a sequential grid axis with the accumulator in VMEM scratch; here a
// loop over the digits runs inside one launch.
//
// Bound on the H100: integer multiply-adds. 62 cyclotomic squares and 23
// dense products per lane, about 1.51 M 32-bit IMADs at least (the least
// count in chip_smoke.py), against 2 x 1008 bytes read and 1008 written per
// lane. Design: kernel D's (csrc/pow_ladder.cu) on the six-thread group
// core (field_group.cuh): six threads per lane, five lanes per warp, so
// that each thread holds one Fq product's operands and accumulator in
// registers and the SM keeps 8 warps in flight. The lane's f, the square's
// scratch, m and mc live in shared memory; m and mc are loaded once and stay
// resident, as kernel K12 keeps x: staging them from device memory on each
// nonzero digit, as D stages its row, ran 2-3% slower on the H100
// (tools/k1617_variants.py). The digit is the same for every lane, so every
// branch on it is uniform.
#include <cuda_runtime.h>

#include "field_group.cuh"

namespace pt {

// Four warps a block, two blocks (8 warps) per SM, as kernel D. A lane's
// shared region is f, the square's scratch, m and mc (four Fq12 and one word
// of padding, 4,036 B): 80,720 B a block, dynamic (over 48 KB).
constexpr int K16_WARPS = 4;
constexpr int K16_MIN_BLOCKS = 2;
constexpr int K16_THREADS = K16_WARPS * 32;
constexpr int K16_LANES = K16_WARPS * GROUP_LANES;  // lanes per block
constexpr int K16_STRIDE = 4 * F12_WORDS + 1;
constexpr size_t K16_SMEM = (size_t)K16_LANES * K16_STRIDE * sizeof(uint32_t);

// m and mc are written once, before the first barrier, and only read after
// it; every step is kernel D's with m or mc as its row.
__global__ void __launch_bounds__(K16_THREADS, K16_MIN_BLOCKS)
k_pow_ladder(const int32_t* __restrict__ m, const int32_t* __restrict__ mc,
             const int32_t* __restrict__ digits, int n_digits, int32_t* __restrict__ out,
             int lanes) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;
  // Threads 30 and 31 of each warp belong to no lane and to no barrier's mask.
  if (t32 >= GROUP * GROUP_LANES) return;
  const int g = t32 / GROUP, s = t32 % GROUP;
  const int lane = (blockIdx.x * K16_WARPS + warp) * GROUP_LANES + g;
  // A lane past the batch edge works on the last lane's data, reaches every
  // barrier with its group and stores nothing.
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  uint32_t* f = smem + (warp * GROUP_LANES + g) * K16_STRIDE;
  uint32_t* scr = f + F12_WORDS;
  uint32_t* xm = scr + F12_WORDS;
  uint32_t* xmc = xm + F12_WORDS;
  group_load_slot(f, m + col, n, s);
  group_load_slot(xm, m + col, n, s);
  group_load_slot(xmc, mc + col, n, s);
  __syncwarp(GROUP_MASK);
#pragma unroll 1
  for (int t = 0; t < n_digits; ++t) {
    group_cyc_sq(f, scr, s);
    const int d = __ldg(digits + t);
    if (d != 0) group_fq12_mul(f, d > 0 ? xm : xmc, s);
  }
  if (live) group_store_slot(f, out + lane, n, s);
}

}  // namespace pt

extern "C" int pt_pow_ladder(const int32_t* m, const int32_t* mc, const int32_t* digits,
                             int n_digits, int32_t* out, int lanes, void* stream) {
  if (lanes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        pt::k_pow_ladder, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pt::K16_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (lanes + pt::K16_LANES - 1) / pt::K16_LANES;
    pt::k_pow_ladder<<<blocks, pt::K16_THREADS, pt::K16_SMEM, (cudaStream_t)stream>>>(
        m, mc, digits, n_digits, out, lanes);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block of k_pow_ladder asks for at launch
// (ptxas reports static shared memory only).
extern "C" int pt_pow_ladder_shared_bytes() { return (int)pt::K16_SMEM; }
