// Kernel K17: the windowed (w = 4 NAF) cyclotomic x-power ladder with its
// table built in the kernel, out = m^e for the MSB-first w-NAF digits of e
// (BN_X_W4_DIGITS: 63 digits, the top one positive, 13 more nonzero).
//
// Replaces pairing_tpu/ops/fused_kernels.py:pow_ladder_w4_pallas
// (pallas_call at :501, body _pow_w4_kernel :433), reached through
// final_exp.pow_x_cyclotomic and the Fq12-level hard_part. Kernel D runs the
// same ladder on a table that kernels A, B and E build outside; here one
// launch does all of it:
//
//   table: m2 = m^2 (Granger-Scott), tab = {m, m^3, m^5, m^7} by three
//          dense products with m2;
//   init:  f = tab[digits[0]] (no square);
//   step:  f = f^2, times the signed entry of a nonzero digit (the entry,
//          conjugated for d < 0: field.cuh:fq12_signed_entry).
//
// The table (4 x 1008 bytes per lane) and the two accumulators do not fit
// the register file. The table lives in a global scratch ``tab`` [4, 12, 21,
// lanes], batch last, so a warp's loads of one word are one coalesced
// transaction; the accumulators stay in local memory.
//
// Bound on the H100: integer multiply-adds. One cyclotomic square and 3
// dense products for the table, 62 squares and 13 products in the ladder,
// about 1.32 M 32-bit IMADs per lane at least (the least count in
// chip_smoke.py), against 1008 bytes read and 1008 written per lane (the
// scratch table is not counted).
#include <cuda_runtime.h>

#include "field.cuh"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_pow_ladder_w4(const int32_t* __restrict__ m, const int32_t* __restrict__ digits,
                int n_digits, int32_t* tab, int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  const size_t row_words = 12 * NL * n;
  int32_t* tab_lane = tab + lane;
  Fq12 x, m2, f0, f1;
  load_fq12(x, m + lane, n);
  store_fq12(x, tab_lane, n);
  fq12_cyc_sq(x, m2);
#pragma unroll 1
  for (int r = 1; r < 4; ++r) {  // x = tab[r - 1] -> tab[r] = m2 * x
    fq12_mul(m2, x, DENSE, f0);
    store_fq12(f0, tab_lane + r * row_words, n);
    x = f0;
  }
  Fq12* f = &f0;
  Fq12* g = &f1;
  fq12_signed_entry(tab_lane, n, __ldg(digits), *f);
#pragma unroll 1
  for (int t = 1; t < n_digits; ++t) {
    fq12_cyc_sq(*f, *g);
    const int d = __ldg(digits + t);
    if (d != 0) {
      fq12_signed_entry(tab_lane, n, d, x);
      fq12_mul(*g, x, DENSE, *f);
    } else {
      Fq12* tmp = f;
      f = g;
      g = tmp;
    }
  }
  store_fq12(*f, out + lane, n);
}

}  // namespace pt

extern "C" int pt_pow_ladder_w4(const int32_t* m, const int32_t* digits, int n_digits,
                                int32_t* tab, int32_t* out, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
    pt::k_pow_ladder_w4<<<blocks, pt::BLOCK, 0, (cudaStream_t)stream>>>(m, digits, n_digits,
                                                                       tab, out, lanes);
  }
  return (int)cudaGetLastError();
}
