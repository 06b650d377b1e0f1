// Kernel K16: the plain-NAF cyclotomic x-power ladder, out = m^e, where
// ``digits`` are the MSB-first NAF digits of e after its leading one
// (BN_X_LADDER_DIGITS: 62 digits, 23 of them nonzero).
//
// Replaces pairing_tpu/ops/fused_kernels.py:pow_ladder_pallas (pallas_call
// at :355, body _pow_kernel :281). The ladder starts at m; per digit it
// squares (Granger-Scott, valid on the cyclotomic subgroup) and multiplies by
// m on +1, by mc = conj(m) on -1, by nothing on 0. The TPU walked the digits
// as a sequential grid axis with the accumulator in VMEM scratch; here one
// thread per lane runs every step. The digit is the same in every lane, so
// the product branch does not diverge.
//
// Bound on the H100: integer multiply-adds. 62 cyclotomic squares and 23
// dense products per lane, about 1.51 M 32-bit IMADs at least (the least
// count in chip_smoke.py), against 2 x 1008 bytes read and 1008 written per
// lane. The accumulator and one temporary stay in local memory; m or mc is
// read from its (read-only) input on each product.
#include <cuda_runtime.h>

#include "field.cuh"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_pow_ladder(const int32_t* __restrict__ m, const int32_t* __restrict__ mc,
             const int32_t* __restrict__ digits, int n_digits, int32_t* __restrict__ out,
             int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fq12 f0, f1, y;
  Fq12* f = &f0;
  Fq12* g = &f1;
  load_fq12(*f, m + lane, n);
#pragma unroll 1
  for (int t = 0; t < n_digits; ++t) {
    fq12_cyc_sq(*f, *g);
    const int d = __ldg(digits + t);
    if (d != 0) {
      load_fq12(y, (d > 0 ? m : mc) + lane, n);
      fq12_mul(*g, y, DENSE, *f);
    } else {
      Fq12* tmp = f;
      f = g;
      g = tmp;
    }
  }
  store_fq12(*f, out + lane, n);
}

}  // namespace pt

extern "C" int pt_pow_ladder(const int32_t* m, const int32_t* mc, const int32_t* digits,
                             int n_digits, int32_t* out, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
    pt::k_pow_ladder<<<blocks, pt::BLOCK, 0, (cudaStream_t)stream>>>(m, mc, digits, n_digits,
                                                                    out, lanes);
  }
  return (int)cudaGetLastError();
}
