// Kernels I and J: the two passes of Montgomery's batch inversion over a
// stack of Fq2 values z [n, 2, 21, lanes] (Phase N, the bulk Jacobian to
// affine normalization of the Miller trajectory).
//
// Replaces pairing_tpu/ops/norm_kernels.py:prefix_products_pallas
// (pallas_call at :116, body _fwd_kernel) and running_inverse_pallas
// (pallas_call at :156, body _bwd_kernel):
//
//   forward:  prefix[i] = z[0] ... z[i-1] (prefix[0] = 1), total = prefix[n];
//   backward: given tinv = 1 / total, from i = n-1 down:
//             zinv[i] = c * prefix[i], c <- c * z[i]   (c starts at tinv).
//
// The TPU walked the stack as a sequential grid axis with the running
// product in VMEM scratch; here a lane walks it in a loop. The one Fermat
// inversion of the total between the passes is kernel F (fp_pow.cu).
//
// Bound on the H100: integer multiply-adds, narrowly. One (forward) or two
// (backward) Fq2 products, at least 2.2 k or 4.5 k 32-bit IMADs, per step
// against 168 bytes read and 168 written per step and lane (the backward
// pass also reads the prefix); at 130 steps x 16384 lanes each pass moves
// about 0.7 GB. Neighbouring
// threads read neighbouring words of every row.
//
// One thread per lane left both passes at four warps per SM, one per
// scheduler, each a serial chain of dependent products (I 21%, J 21.6% of
// its bound on an H100 at 16384 lanes), the running product in registers
// and field.cuh's fp2_mul (out of line, 64-bit columns).
//
// J runs four threads per lane: ranks 0-1 run the chain c <- c z[i], rank h
// computing component h; ranks 2-3 compute component h = rank - 2 of
// zinv[i] = c prefix[i] from the same c at the same time, so the lane's
// critical path is the chain alone, one Fq2 product component a step. Each
// component is two Fq products into one 32-bit column sum and one reduction
// (field32.cuh; every operand digit is below 2^13: load_fp carries on load,
// c and 2p - v1 are outputs of w32_reduce and fp_neg), as in kernel H
// (trajectory.cu), whose two-rank layout ran 6% slower for J on an H100
// at 16384 lanes. A warp holds 8 lanes: threads 8r .. 8r + 7 are rank r, so
// a component row of 8 lanes is one 32-byte store; 16384 lanes make 2,048
// warps. c lives in shared memory, double-buffered, [buffer][comp][limb][8
// lanes] a warp (2,688 bytes): each step every rank reads c from one buffer
// and ranks 0-1 write the new c into the other, then one __syncwarp. Every
// rank runs the same instructions up to the store (2p - v1 is selected limb
// by limb, never by a branch on the rank); a lane past the batch edge
// computes on the last lane's data, reaches every barrier and stores nothing.
//
// I is that chain alone, with prefix[i] = c stored before each product: two
// threads per lane, rank h computing and storing component h, 16 lanes a
// warp (threads 16h .. 16h + 15 are rank h, so a component row of 16 lanes
// is one 64-byte store; 16384 lanes make 1,024 warps), c double-buffered in
// shared memory (5,376 bytes a warp), one __syncwarp a step. On an H100
// (tools/ig_variants.py) four ranks a lane, each pair splitting a
// component's two Fq products and adding its column sums by shuffle, ran
// 25-30% slower, and an occupancy cap of __launch_bounds__(128, 8) (64
// registers) 2.7-3.5 times slower.
//
// The products, their operands and every reduction are fp2_mul's on the
// same integers, so both kernels' digits are those of the one-thread
// kernels they replaced.
#include <cuda_runtime.h>

#include "field32.cuh"

namespace pt {

constexpr int J_LANES = 8;                   // lanes per warp
constexpr int J_WARPS = 4;                   // warps per block
constexpr int J_THREADS = 32 * J_WARPS;
constexpr int J_BLOCK_LANES = J_LANES * J_WARPS;
constexpr int J_COMP = NL * J_LANES;         // words of one component of c
constexpr int J_VAL = 2 * J_COMP;            // words of one c a warp

constexpr int I_LANES = 16;                  // lanes per warp
constexpr int I_WARPS = 4;                   // warps per block
constexpr int I_THREADS = 32 * I_WARPS;
constexpr int I_BLOCK_LANES = I_LANES * I_WARPS;
constexpr int I_COMP = NL * I_LANES;
constexpr int I_VAL = 2 * I_COMP;

// Component h of fp2_mul(c, v): c0 v0 + c1 (2p - v1) for h = 0, c0 v1 + c1 v0
// for h = 1; c at ``c`` (this lane's column of one of the warp's buffers of
// LANES lanes), v at ``v`` (this lane's column of two batch-last rows).
template <int LANES>
static __device__ __forceinline__ Fp mul_part(const uint32_t* c, const int32_t* __restrict__ v,
                                              size_t lanes, int h) {
  Wide32 w;
  w32_zero(w);
  Fp x, y;
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] = c[l * LANES];
  load_fp(y, v + h * NL * lanes, lanes);
  w32_mac(w, x, y);
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] = c[NL * LANES + l * LANES];
  load_fp(y, v + (1 - h) * NL * lanes, lanes);
  const Fp ny = fp_neg(y);
#pragma unroll
  for (int l = 0; l < NL; ++l) y.v[l] = h ? y.v[l] : ny.v[l];
  w32_mac(w, x, y);
  Fp r;
  w32_reduce(w, r);
  return r;
}

__global__ void __launch_bounds__(I_THREADS)
k_prefix_products(const int32_t* __restrict__ z, int n_steps, int32_t* __restrict__ prefix,
                  int32_t* __restrict__ total, int lanes) {
  __shared__ uint32_t cs[I_WARPS * 2 * I_VAL];
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;
  const int g = t32 & (I_LANES - 1), h = t32 >> 4;
  const int lane = (blockIdx.x * I_WARPS + warp) * I_LANES + g;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  const size_t step = 2 * NL * n;
  uint32_t* buf = cs + warp * 2 * I_VAL + g;
  Fp v;  // component h of c; c starts at one
#pragma unroll
  for (int l = 0; l < NL; ++l) v.v[l] = h ? 0u : KP[KP_ONE][l];
#pragma unroll
  for (int l = 0; l < NL; ++l) buf[h * I_COMP + l * I_LANES] = v.v[l];
  int cur = 0;
#pragma unroll 1
  for (int i = 0; i < n_steps; ++i) {
    if (live) store_fp(v, prefix + i * step + h * NL * n + lane, n);
    __syncwarp();  // both components of c in buffer cur; buffer 1 - cur read
    v = mul_part<I_LANES>(buf + cur * I_VAL, z + i * step + col, n, h);
    uint32_t* o = buf + (1 - cur) * I_VAL + h * I_COMP;
#pragma unroll
    for (int l = 0; l < NL; ++l) o[l * I_LANES] = v.v[l];
    cur = 1 - cur;
  }
  if (live) store_fp(v, total + h * NL * n + lane, n);
}

__global__ void __launch_bounds__(J_THREADS, 4)
k_running_inverse(const int32_t* __restrict__ z, const int32_t* __restrict__ prefix,
                  const int32_t* __restrict__ tinv, int n_steps, int32_t* __restrict__ zinv,
                  int lanes) {
  __shared__ uint32_t cs[J_WARPS * 2 * J_VAL];
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;
  const int g = t32 & (J_LANES - 1), r = t32 >> 3, h = r & 1;
  const bool chain = r < 2;
  const int lane = (blockIdx.x * J_WARPS + warp) * J_LANES + g;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  const size_t step = 2 * NL * n;
  uint32_t* buf = cs + warp * 2 * J_VAL + g;
  if (chain) {
    Fp x;
    load_fp(x, tinv + h * NL * n + col, n);
#pragma unroll
    for (int l = 0; l < NL; ++l) buf[h * J_COMP + l * J_LANES] = x.v[l];
  }
  __syncwarp();
  int cur = 0;
#pragma unroll 1
  for (int i = n_steps - 1; i >= 0; --i) {
    const uint32_t* c = buf + cur * J_VAL;
    const Fp v = mul_part<J_LANES>(c, (chain ? z : prefix) + i * step + col, n, h);
    if (chain) {
      uint32_t* o = buf + (1 - cur) * J_VAL + h * J_COMP;
#pragma unroll
      for (int l = 0; l < NL; ++l) o[l * J_LANES] = v.v[l];
    } else if (live) {
      store_fp(v, zinv + i * step + h * NL * n + lane, n);
    }
    __syncwarp();
    cur = 1 - cur;
  }
}

}  // namespace pt

extern "C" int pt_prefix_products(const int32_t* z, int n_steps, int32_t* prefix,
                                  int32_t* total, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::I_BLOCK_LANES - 1) / pt::I_BLOCK_LANES;
    pt::k_prefix_products<<<blocks, pt::I_THREADS, 0, (cudaStream_t)stream>>>(
        z, n_steps, prefix, total, lanes);
  }
  return (int)cudaGetLastError();
}

extern "C" int pt_running_inverse(const int32_t* z, const int32_t* prefix, const int32_t* tinv,
                                  int n_steps, int32_t* zinv, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::J_BLOCK_LANES - 1) / pt::J_BLOCK_LANES;
    pt::k_running_inverse<<<blocks, pt::J_THREADS, 0, (cudaStream_t)stream>>>(
        z, prefix, tinv, n_steps, zinv, lanes);
  }
  return (int)cudaGetLastError();
}
