// 32-bit column sums for the port's Fq2-level kernels (H, K).
//
// field.cuh sums every limb product into 64-bit position accumulators
// (IMAD.WIDE), which an Fq12 product needs. An Fq2 product component needs
// less: two Fq products into one accumulator and one reduction. With every
// operand digit below 2^13 (each value an output of field.cuh's carried
// routines or of load_fp, which carries on load), a column of two
// products' limb products (at most 42 terms below 2^26), its 21 reduction
// terms m * p_j (m < 2^13, p_j <= 7495) and one carry (below 2^19) stays
// below 4.11e9 < 2^32: the sums are the 64-bit ones of wide_mac /
// mont_reduce, exactly, in half the registers and with 32-bit
// multiply-adds. A Montgomery reduction's result depends only on the
// integer summed, so the digits are those of field.cuh's fp2_mul / fp2_sq /
// fp_mul on the same operands.
#pragma once

#include "field.cuh"

namespace pt {

struct Wide32 { uint32_t t[2 * NL]; };

static __device__ __forceinline__ void w32_zero(Wide32& w) {
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) w.t[i] = 0;
}

static __device__ __forceinline__ void w32_mac(Wide32& w, const Fp& a, const Fp& b) {
#pragma unroll
  for (int i = 0; i < NL; ++i)
#pragma unroll
    for (int j = 0; j < NL; ++j) w.t[i + j] += a.v[i] * b.v[j];
}

// Carry-save fold for sums of more than two Fq products (kernel A): each
// column keeps its low 13 bits and passes the rest one column up, all
// columns at once (every new column reads only old ones: no ripple). The
// integer sum is unchanged; a column leaves below 2^13 + 2^19 (its carry-in
// is below 2^32 >> 13), so two more Fq products fit beside it. Column 41
// takes no limb product and stays small: the whole sum is below 2^533.
static __device__ __forceinline__ void w32_fold(Wide32& w) {
#pragma unroll
  for (int i = 2 * NL - 2; i >= 0; --i) {
    w.t[i + 1] += w.t[i] >> RB;
    w.t[i] &= MASK;
  }
}

// mont_reduce on 32-bit columns.
static __device__ __forceinline__ void w32_reduce(Wide32& w, Fp& r) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t m = (w.t[i] * NP0) & MASK;
#pragma unroll
    for (int j = 0; j < NL; ++j) w.t[i + j] += m * KP[KP_1][j];
    w.t[i + 1] += w.t[i] >> RB;
  }
  uint32_t c = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const uint32_t s = w.t[NL + k] + c;
    r.v[k] = s & MASK;
    c = s >> RB;
  }
}

// fp_small(a, K) for a < 2p: K a < 2K p, so of fp_reduce32's conditional
// subtractions of 16p, 8p, 4p and 2p only those below 2K p can apply; the
// others are skipped. Same result, fewer carry chains.
template <uint32_t K>
static __device__ __forceinline__ Fp small(const Fp& a) {
  static_assert(K >= 2 && K <= 8, "K a must stay below 16p");
  Fp r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = a.v[i] * K;
  fp_carry(r);
  if (K > 4) fp_cond_sub(r, KP_8);
  if (K > 2) fp_cond_sub(r, KP_4);
  fp_cond_sub(r, KP_2);
  return r;
}

}  // namespace pt
