// fq12_terms.cuh's mac_cyc_term with every operand read from device memory
// through L1 and carried at each use, as kernel A reads: the term of the L1
// variants of kernels B (tools/fb_variants.cu) and K18
// (tools/k1518_variants.cu).
#pragma once

#include "fq12_terms.cuh"

namespace pt {

// w += component ``comp`` of the term t; ``a`` at this lane's column of
// component 0 of a tensor of n lanes.
static __device__ __forceinline__ void l1_term(Wide32& w, const int32_t* a, size_t n, BTerm t,
                                               int comp) {
  Fp x0, x1;
  load_fp(x0, a + 2 * t.x * NL * n, n);
  load_fp(x1, a + (2 * t.x + 1) * NL * n, n);
  if (t.flags & B_SQ) {
    if (comp == 0) {
      w32_sq_mac(w, x0);
      w32_mac(w, x1, fp_neg(x1));
    } else {
#pragma unroll
      for (int l = 0; l < NL; ++l) x0.v[l] <<= 1;
      fp_carry(x0);
      w32_mac(w, x0, x1);
    }
    return;
  }
  if (t.flags & B_FOLD) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const uint32_t u0 = x0.v[l], u1 = x1.v[l];
      x0.v[l] = 9 * u0 + KP[KP_2][l] - u1;
      x1.v[l] = u0 + 9 * u1;
    }
    fp_carry(x0);
    fp_carry(x1);
  }
  if (t.flags & B_DBL) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      x0.v[l] <<= 1;
      x1.v[l] <<= 1;
    }
    fp_carry(x0);
    fp_carry(x1);
  }
  Fp y;
  load_fp(y, a + (2 * t.y + comp) * NL * n, n);
  w32_mac(w, x0, y);
  load_fp(y, a + (2 * t.y + 1 - comp) * NL * n, n);
  if (comp == 0) y = fp_neg(y);
  w32_mac(w, x1, y);
}

}  // namespace pt
