// Phase N's Fq2 inverse: 1 / t = (c0 - c1 u) / (c0^2 + c1^2) for the total
// t of kernel I's prefix products, on Fq2 tensors [2, 21, lanes] (c0, c1).
//
// Replaces no TPU kernel: the XLA glue at
// pairing_tpu/pairing/miller_loop.py:299 (F2.cap(F2.inv(total_fp2)) around
// fp_pow_bits_pallas, kernel F), which the port ran as eager field glue:
// about 205 small kernels and 17 blocking copies of host constants a call,
// paced by the host at every lane count the pairing path runs.
//
// Bound on the H100: integer multiply-adds. Kernel F's chain for p - 2
// (0.2186 ms at 16384 lanes by the best sliding window) plus the norm (two
// Fq squares, one reduction) and two Fq products, about 1% more; 84 bytes
// in and 168 out a lane.
//
// Design: kernel F's, one thread a lane in blocks of BLOCK, on
// field32.cuh's 32-bit columns. The norm's two squares (w32_sq_mac) share
// one Wide32 and one reduction (w32_reduce_imm): two squares' columns,
// below 2.82e9, with the reduction's terms and a carry stay below 3.32e9 <
// 2^32 (tests/test_torch_inv_kernels.py models it at all-maximal digits).
// Then fp32_inv (kernel G's fixed 4-bit window chain, p - 2's words from
// the constant bank) and the two products by the inverse norm, the second
// negated. c0 and c1 are read again from global memory after the chain
// rather than held across it, so the chain keeps F's registers. The input
// is read as load_fp reads it (neighbouring lanes on neighbouring words,
// settled limbs carried on load); the output is below 2p with digits below
// 2^13, the envelope kernel J takes. Its digits may differ by p from the
// field library's, whose chain multiplies in another order; zero lanes give
// zero.
#include <cuda_runtime.h>

#include "field32.cuh"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_fq2_inv(const int32_t* __restrict__ a, int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  const int32_t* a0 = a + lane;
  const int32_t* a1 = a + NL * n + lane;
  Fp ninv;
  {
    Fp c0, c1, norm;
    load_fp(c0, a0, n);
    load_fp(c1, a1, n);
    Wide32 w;
    w32_zero(w);
    w32_sq_mac(w, c0);
    w32_sq_mac(w, c1);
    w32_reduce_imm(w, norm);
    ninv = fp32_inv(norm);
  }
  Fp c;
  load_fp(c, a0, n);
  store_fp(fp32_mul(c, ninv), out + lane, n);
  load_fp(c, a1, n);
  store_fp(fp_neg(fp32_mul(c, ninv)), out + NL * n + lane, n);
}

}  // namespace pt

// ``a`` and ``out``: [2, 21, lanes], not aliased.
extern "C" int pt_fq2_inv(const int32_t* a, int32_t* out, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
    pt::k_fq2_inv<<<blocks, pt::BLOCK, 0, (cudaStream_t)stream>>>(a, out, lanes);
  }
  return (int)cudaGetLastError();
}
