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
// The forward pass (I) runs one thread per lane with the running product in
// registers (field.cuh's fp2_mul, 64-bit columns). One thread per lane left
// the backward pass (J) at four warps per SM, one per scheduler, each a
// serial chain of dependent products (21.6% of its bound on an H100 at
// 16384 lanes). J runs four threads per lane: ranks 0-1 run the chain
// c <- c z[i], rank h computing component h; ranks 2-3 compute component
// h = rank - 2 of zinv[i] = c prefix[i] from the same c at the same time,
// so the lane's critical path is the chain alone, one Fq2 product component
// a step. Each component is
// two Fq products into one 32-bit column sum and one reduction
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
// computes on the last lane's data, reaches every barrier and stores
// nothing. The products, their operands and every reduction are fp2_mul's
// on the same integers, so the digits are those of the one-thread kernel.
#include <cuda_runtime.h>

#include "field32.cuh"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_prefix_products(const int32_t* __restrict__ z, int n_steps, int32_t* __restrict__ prefix,
                  int32_t* __restrict__ total, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  const size_t step = 2 * NL * n;
  Fp2 c;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    c.c0.v[l] = KP[KP_ONE][l];
    c.c1.v[l] = 0u;
  }
#pragma unroll 1
  for (int i = 0; i < n_steps; ++i) {
    store_fp2(c, prefix + i * step + lane, n);
    c = fp2_mul(c, load_fp2(z + i * step + lane, n));
  }
  store_fp2(c, total + lane, n);
}

constexpr int J_LANES = 8;                   // lanes per warp
constexpr int J_WARPS = 4;                   // warps per block
constexpr int J_THREADS = 32 * J_WARPS;
constexpr int J_BLOCK_LANES = J_LANES * J_WARPS;
constexpr int J_COMP = NL * J_LANES;         // words of one component of c
constexpr int J_VAL = 2 * J_COMP;            // words of one c a warp

// Component h of fp2_mul(c, v): c0 v0 + c1 (2p - v1) for h = 0, c0 v1 + c1 v0
// for h = 1; c at ``c`` (this lane's column of one of the warp's buffers), v
// at ``v`` (this lane's column of two batch-last rows).
static __device__ __forceinline__ Fp mul_part(const uint32_t* c, const int32_t* __restrict__ v,
                                              size_t lanes, int h) {
  Wide32 w;
  w32_zero(w);
  Fp x, y;
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] = c[l * J_LANES];
  load_fp(y, v + h * NL * lanes, lanes);
  w32_mac(w, x, y);
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] = c[J_COMP + l * J_LANES];
  load_fp(y, v + (1 - h) * NL * lanes, lanes);
  const Fp ny = fp_neg(y);
#pragma unroll
  for (int l = 0; l < NL; ++l) y.v[l] = h ? y.v[l] : ny.v[l];
  w32_mac(w, x, y);
  Fp r;
  w32_reduce(w, r);
  return r;
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
    const Fp v = mul_part(c, (chain ? z : prefix) + i * step + col, n, h);
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
    const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
    pt::k_prefix_products<<<blocks, pt::BLOCK, 0, (cudaStream_t)stream>>>(z, n_steps, prefix,
                                                                         total, lanes);
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
