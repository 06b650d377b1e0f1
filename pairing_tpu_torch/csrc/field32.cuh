// 32-bit column sums for the port's Fq2-level kernels (H, K, A, I, J, G, B)
// and the Fq power chain (G, F).
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

// ---------------------------------------------------------------------------
// One Fq square, product and Fermat inverse a thread (kernel G's chain).
// ---------------------------------------------------------------------------

// Digit j of p as a compile-time constant: in an unrolled loop the
// reduction's multiply-adds take it as an immediate, and the top digit, 0,
// drops out.
static __device__ __forceinline__ uint32_t p_digit(int j) {
  constexpr uint32_t d[NL] = {7495, 999, 1462, 280, 5058, 1350, 455, 4653, 362, 3260, 5655,
                              770, 7016, 2082, 1761, 5125, 305, 5015, 6419, 96, 0};
  return d[j];
}

// w32_reduce with p's digits as immediates: the same sums, the same digits.
static __device__ __forceinline__ void w32_reduce_imm(Wide32& w, Fp& r) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t m = (w.t[i] * NP0) & MASK;
#pragma unroll
    for (int j = 0; j < NL - 1; ++j) w.t[i + j] += m * p_digit(j);
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

// w += a^2, a's digits below 2^13: each cross product a_i a_j (i < j) once,
// against the doubled digit 2 a_i, and the squares a_i^2; 231 limb products
// where w32_mac takes 441, the same columns. A column takes at most 10
// doubled cross products and one square, below 1.41e9, as w32_mac's
// product does.
static __device__ __forceinline__ void w32_sq_mac(Wide32& w, const Fp& a) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t d = a.v[i] << 1;
#pragma unroll
    for (int j = i + 1; j < NL; ++j) w.t[i + j] += d * a.v[j];
    w.t[2 * i] += a.v[i] * a.v[i];
  }
}

// w = a^2 (w is overwritten). The reduction's terms m_i p_j (at most 8,191 x
// 59,618 a column) and one carry below 2^19 keep a column below 1.9e9 <
// 2^32 (the numpy model in tests/test_torch_inv_kernels.py checks both at
// all-maximal digits).
static __device__ __forceinline__ void w32_sq(Wide32& w, const Fp& a) {
  w32_zero(w);
  w32_sq_mac(w, a);
}

// a * b * R^-1 and a^2 * R^-1 for digits below 2^13 and values below 2p:
// field.cuh's fp_mul on the same integers, so the same digits.
static __device__ __forceinline__ Fp fp32_mul(const Fp& a, const Fp& b) {
  Wide32 w;
  w32_zero(w);
  w32_mac(w, a, b);
  Fp r;
  w32_reduce_imm(w, r);
  return r;
}

static __device__ __forceinline__ Fp fp32_sq(const Fp& a) {
  Wide32 w;
  w32_sq(w, a);
  Fp r;
  w32_reduce_imm(w, r);
  return r;
}

// p - 2 in 32-bit words, least significant first; its leading one is bit
// 253. ops/fp_kernels.py:inverse_schedule gives the same words (a tier-1
// test reads them from this file).
static __constant__ uint32_t PM2_WORDS[8] = {0xd87cfd45u, 0x3c208c16u, 0x6871ca8du,
                                             0x97816a91u, 0x8181585du, 0xb85045b6u,
                                             0xe131a029u, 0x30644e72u};
constexpr int PM2_TOP = 253;

// x^e in the Montgomery domain for a static e >= 1 (0 for x = 0) over a
// fixed window of 4 bits. e comes as its 32-bit words, least significant
// first, and ``top``, the bit of its leading one: ``words`` is anything
// indexable (the constant bank's PM2_WORDS, a kernel parameter, or a reader
// of device memory; words[k] is read for k <= top / 32, once a word, and is
// the same across a warp). x^d for d = 1..15 in a table (one square, 13 products), r the top
// digit's entry (the digit at bit top & ~3, never 0), then for each of the
// top / 4 digits below it four squares and, for a nonzero one, a product by
// x^d. For p - 2: 253 squares and 72 products, where a bit at a time
// (field.cuh's fp_pow_bits) takes 253 and 109. e < 16 is the top digit
// alone: e = 1 returns x. Every step is fp32_sq or fp32_mul, so the output
// is below 2p with digits below 2^13; its digits may differ by p from the
// bit chain's, whose products fall in another order.
template <typename Words>
static __device__ __forceinline__ Fp fp32_pow_w4(const Fp& x, const Words& words, int top) {
  Fp tab[16];  // tab[d] = x^d; the digit indexes it at run time: local memory
  tab[1] = x;
  tab[2] = fp32_sq(x);
#pragma unroll 1
  for (int d = 3; d < 16; ++d) tab[d] = fp32_mul(tab[d - 1], x);
  const int lead = top & ~3;
  uint32_t word = words[top >> 5];
  Fp r = tab[(word >> (lead & 31)) & 15u];
#pragma unroll 1
  for (int i = lead - 1; i >= 0; --i) {
    r = fp32_sq(r);
    if ((i & 31) == 31) word = words[i >> 5];
    if ((i & 3) == 0) {
      const uint32_t d = (word >> (i & 31)) & 15u;
      if (d) r = fp32_mul(r, tab[d]);
    }
  }
  return r;
}

// x^(p-2): 1/x, and 0 for x = 0 (kernel G's chain). p - 2's top digit is 3.
static __device__ __forceinline__ Fp fp32_inv(const Fp& x) {
  return fp32_pow_w4(x, PM2_WORDS, PM2_TOP);
}

}  // namespace pt
