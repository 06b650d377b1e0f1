// Kernel K's one-thread line arithmetic and its chord, shared with the
// Miller loop's epilogue lines (miller_epilogue.cu).
//
// One thread per (line, lane), blocks of K_THREADS neighbouring lanes. Each
// Fq2 product component sums its two Fq products in 32-bit columns and
// reduces once (field32.cuh); every operand is below 2p with digits below
// 2^13 (lines.cu says why). The Fq2 product, the Fq2 square and the
// one-product sum are out of line, one body each called from every site:
// inlined whole, kernel K overflowed the instruction cache and ran at half
// the speed. Two Fq2 values a thread that wait across other products are
// parked in the thread's own column of a shared-memory stash.
//
// The operations, their operands' order and every reduction are those of
// field.cuh's fp2_mul / fp2_sq / fp_mul / fp_small, and each computes the
// same integers.
#pragma once

#include "field32.cuh"

namespace pt {

constexpr int K_THREADS = 128;  // lanes per block
constexpr int K_STASH = 2;      // Fq2 slots a thread parks in shared memory
constexpr int K_STASH_WORDS = K_STASH * 2 * NL * K_THREADS;

// a b, or a b + c d, Montgomery-reduced on 32-bit columns.
static __device__ __noinline__ Fp mont(const Fp& a, const Fp& b) {
  Wide32 w;
  w32_zero(w);
  w32_mac(w, a, b);
  Fp r;
  w32_reduce(w, r);
  return r;
}

static __device__ __forceinline__ Fp mont(const Fp& a, const Fp& b, const Fp& c,
                                          const Fp& d) {
  Wide32 w;
  w32_zero(w);
  w32_mac(w, a, b);
  w32_mac(w, c, d);
  Fp r;
  w32_reduce(w, r);
  return r;
}

// field.cuh's fp2_mul: c0 = a0 b0 + a1 (2p - b1), c1 = a0 b1 + a1 b0; c1
// first, so that b1 is dead once 2p - b1 is formed.
static __device__ __noinline__ Fp2 mul(const Fp2& a, const Fp2& b) {
  Fp2 r;
  r.c1 = mont(a.c0, b.c1, a.c1, b.c0);
  r.c0 = mont(a.c0, b.c0, a.c1, fp_neg(b.c1));
  return r;
}

// field.cuh's fp2_sq: c0 = (a0 + a1)(a0 - a1 + 2p), c1 = (2 a0) a1.
static __device__ __noinline__ Fp2 sq(const Fp2& a) {
  Fp2 r;
  {
    Fp t;
#pragma unroll
    for (int i = 0; i < NL; ++i) t.v[i] = 2 * a.c0.v[i];
    fp_carry(t);
    r.c1 = mont(t, a.c1);
  }
  Fp s, d;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    s.v[i] = a.c0.v[i] + a.c1.v[i];
    d.v[i] = a.c0.v[i] + KP[KP_2][i] - a.c1.v[i];
  }
  fp_carry(s);
  fp_carry(d);
  r.c0 = mont(s, d);
  return r;
}

template <uint32_t K>
static __device__ __forceinline__ Fp2 small2(const Fp2& a) {
  return Fp2{small<K>(a.c0), small<K>(a.c1)};
}

// This thread's column of the block's stash: slot s, component c, limb l at
// base[((2 s + c) NL + l) K_THREADS], so a warp's 32 threads hit 32 banks.
struct Stash {
  uint32_t* base;

  __device__ __forceinline__ void put(int s, const Fp2& x) const {
    uint32_t* p = base + 2 * s * NL * K_THREADS;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      p[l * K_THREADS] = x.c0.v[l];
      p[(NL + l) * K_THREADS] = x.c1.v[l];
    }
  }

  __device__ __forceinline__ Fp2 get(int s) const {
    const uint32_t* p = base + 2 * s * NL * K_THREADS;
    Fp2 x;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      x.c0.v[l] = p[l * K_THREADS];
      x.c1.v[l] = p[(NL + l) * K_THREADS];
    }
    return x;
  }
};

// zi^2 from this lane's inverse at ``zi_src``; zi^3 parked in slot 0.
static __device__ __forceinline__ Fp2 inverse_powers(const int32_t* __restrict__ zi_src,
                                                     size_t n, const Stash& st) {
  const Fp2 zi = load_fp2(zi_src, n);
  const Fp2 zi2 = sq(zi);
  st.put(0, mul(zi2, zi));
  return zi2;
}

// Component c of the partner's y: qy_c, negated when the digit is.
static __device__ __forceinline__ Fp partner_y(const int32_t* __restrict__ qy, size_t n, int c,
                                               bool neg) {
  Fp v;
  load_fp(v, qy + c * NL * n, n);
  return neg ? fp_neg(v) : v;
}

// Chord through the affine form of the Jacobian state at ``dbl`` (inverse Z
// at ``zi_src``) and this lane's partner (qx, sqy), sqy = -qy when ``neg``:
// (qx - cx) Py, (cy - sqy) Px, cx sqy - qx cy at dst, dst + 2 rows, dst + 4
// rows. ``p``: the rows px, py; ``q``: the partner's rows qx.c0, qx.c1,
// qy.c0, qy.c1 (each row NL n words). Kernel K's partner is sign(d) Q, the
// epilogue's Q1 or -Q2.
static __device__ __forceinline__ void chord(const int32_t* __restrict__ dbl,
                                             const int32_t* __restrict__ zi_src,
                                             const int32_t* __restrict__ p,
                                             const int32_t* __restrict__ q, bool neg,
                                             int32_t* __restrict__ dst, size_t n,
                                             const Stash& st) {
  const size_t row = NL * n;
  const int32_t* qx = q;
  const int32_t* qy = q + 2 * row;
  {
    const Fp2 zi2 = inverse_powers(zi_src, n, st);
    const Fp2 cx = mul(load_fp2(dbl, n), zi2);
    st.put(1, cx);
    Fp py;
    load_fp(py, p + row, n);
#pragma unroll 1
    for (int c = 0; c < 2; ++c) {
      Fp x;
      load_fp(x, qx + c * row, n);
      store_fp(mont(fp_sub(x, c ? cx.c1 : cx.c0), py), dst + c * row, n);
    }
  }
  {
    const Fp2 cy = mul(load_fp2(dbl + 2 * row, n), st.get(0));
    Fp px;
    load_fp(px, p, n);
#pragma unroll 1
    for (int c = 0; c < 2; ++c)
      store_fp(mont(fp_sub(c ? cy.c1 : cy.c0, partner_y(qy, n, c, neg)), px),
               dst + (2 + c) * row, n);
    st.put(0, mul(load_fp2(qx, n), cy));
  }
  const Fp2 sqy{partner_y(qy, n, 0, neg), partner_y(qy, n, 1, neg)};
  store_fp2(fp2_sub(mul(st.get(1), sqy), st.get(0)), dst + 4 * row, n);
}

}  // namespace pt
