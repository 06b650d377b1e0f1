// Kernel D: streamed windowed cyclotomic ladder, out = m^e for the MSB-first
// w-NAF digits of e (BN_X with w = 4 on the main path).
//
// Replaces pairing_tpu/ops/fused_kernels.py:pow_ladder_stream_pallas
// (pallas_call at :606, body _pow_stream_kernel :542); the host side,
// fused_kernels.pow_x_streamed, builds the signed table rows (m, m^3, m^5,
// m^7 and conjugates) with kernels A and B.
//
// Schedule row sched[t] = (digit != 0, row): step 0 loads stream[row] as the
// start value; every later step squares (Granger-Scott) and, on a nonzero
// digit, multiplies by stream[row]. On the TPU a scalar-prefetch grid spec
// fetched the row of each step; here the lane's group stages stream[row] in
// shared memory itself.
//
// Bound on the H100: integer multiply-adds (62 cyclotomic squares and 13
// dense products per lane for BN_X), against at most 8 rows of 1008 bytes
// per lane read. Design (field_group.cuh): six threads per lane, five lanes
// per warp, the lane's f and a scratch in shared memory, so that each
// thread holds one Fq product's operands and accumulator in registers and
// the SM keeps several warps per scheduler in flight to hide the latency
// of the dependent multiply-adds. The digit schedule is the same for every
// lane, so every branch on it is uniform.
#include <cuda_runtime.h>

#include "field_group.cuh"

namespace pt {

// Four warps a block: 20 lanes of 2020 shared bytes, 40,400 bytes, static
// (under 48 KB). Two blocks (8 warps) per SM leave the registers uncapped
// below 255: asking for three (12 warps) caps them at 168, and ptxas then
// spills about 0.5 KB a thread.
constexpr int D_WARPS = 4;
constexpr int D_MIN_BLOCKS = 2;
constexpr int D_THREADS = D_WARPS * 32;
constexpr int D_LANES = D_WARPS * GROUP_LANES;  // lanes per block

__global__ void __launch_bounds__(D_THREADS, D_MIN_BLOCKS)
k_pow_ladder_stream(const int32_t* __restrict__ stream, const int32_t* __restrict__ sched,
                    int n_steps, int32_t* __restrict__ out, int lanes) {
  __shared__ uint32_t smem[D_LANES * GROUP_STRIDE];
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;
  // Threads 30 and 31 of each warp belong to no lane and to no barrier's mask.
  if (t32 >= GROUP * GROUP_LANES) return;
  const int g = t32 / GROUP, s = t32 % GROUP;
  const int lane = (blockIdx.x * D_WARPS + warp) * GROUP_LANES + g;
  // A lane past the batch edge works on the last lane's data, reaches every
  // barrier with its group and stores nothing.
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  uint32_t* f = smem + (warp * GROUP_LANES + g) * GROUP_STRIDE;
  uint32_t* scr = f + F12_WORDS;
  const size_t row_words = 12 * NL * n;
  group_load_slot(f, stream + (size_t)__ldg(sched + 1) * row_words + col, n, s);
  __syncwarp(GROUP_MASK);
#pragma unroll 1
  for (int t = 1; t < n_steps; ++t) {
    group_cyc_sq(f, scr, s);
    if (__ldg(sched + 2 * t) != 0) {
      group_load_slot(scr, stream + (size_t)__ldg(sched + 2 * t + 1) * row_words + col, n, s);
      __syncwarp(GROUP_MASK);
      group_fq12_mul(f, scr, s);
    }
  }
  if (live) group_store_slot(f, out + lane, n, s);
}

}  // namespace pt

extern "C" int pt_pow_ladder_stream(const int32_t* stream, const int32_t* sched,
                                    int n_steps, int32_t* out, int lanes,
                                    void* cuda_stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::D_LANES - 1) / pt::D_LANES;
    pt::k_pow_ladder_stream<<<blocks, pt::D_THREADS, 0, (cudaStream_t)cuda_stream>>>(
        stream, sched, n_steps, out, lanes);
  }
  return (int)cudaGetLastError();
}
