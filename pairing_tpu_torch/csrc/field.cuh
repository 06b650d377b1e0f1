// BN254 field tower for the port's CUDA kernels: Fq, Fq2, Fq12 on one lane.
//
// Replaces the in-kernel arithmetic library of the TPU kernels,
// pairing_tpu/ops/kernel_core.py (k_mul_wide, k_carry, k_mont_reduce,
// k_cyc_sq) and pairing_tpu/ops/kwide.py (static-bound signed-wide
// Karatsuba). It keeps the reference representation: 21 limbs of 13 bits,
// Montgomery R = 2^273, values < 2p. Inputs may carry limbs up to
// SETTLED = 2^13 + 1; every output has digits in [0, 2^13) and value < 2p.
//
// What bounds it on this card: integer multiply-adds. One Fq product is
// 441 limb products plus a 441-product word-by-word Montgomery reduction,
// all IMAD.WIDE into 64-bit position accumulators, so no static bound
// bookkeeping is needed (kwide.py's reason to exist on the TPU, whose
// vector unit has no 64-bit accumulate). An Fq12 value is 252 words, more
// than the 255-register file can hold beside its operands, so Fq12 values
// live in per-thread local memory (L1-cached) and the big routines are
// kept out of line to bound code size and compile time.
//
// Design: one thread per batch lane, batch-last layout [comp, 21, lanes]
// so that neighbouring threads read neighbouring words. Every Fq12 product
// accumulates its 12 terms per output coefficient unreduced and pays one
// Montgomery reduction per coefficient: the xi fold of slots >= 6 is done
// by pre-multiplying the left operand with xi = 9 + u (value < 20p), and
// c0 = a0*b0 + a1*(2p - b1) keeps the sum additive. The sum stays below
// 480 p^2 < R p, so the reduced value is < 2p.
#pragma once

#include <cstddef>
#include <cstdint>

namespace pt {

constexpr int NL = 21;          // limbs per Fq element
constexpr int RB = 13;          // bits per limb
constexpr uint32_t MASK = (1u << RB) - 1;
constexpr uint32_t NP0 = 905;   // -p^{-1} mod 2^13

// Rows: p, 2p, 4p, 8p, 16p, R mod p (Montgomery one); 13-bit digits, LSB first.
enum { KP_1 = 0, KP_2 = 1, KP_4 = 2, KP_8 = 3, KP_16 = 4, KP_ONE = 5 };
static __constant__ uint32_t KP[6][NL] = {
    {7495, 999, 1462, 280, 5058, 1350, 455, 4653, 362, 3260, 5655,
     770, 7016, 2082, 1761, 5125, 305, 5015, 6419, 96, 0},
    {6798, 1999, 2924, 560, 1924, 2701, 910, 1114, 725, 6520, 3118,
     1541, 5840, 4165, 3522, 2058, 611, 1838, 4647, 193, 0},
    {5404, 3999, 5848, 1120, 3848, 5402, 1820, 2228, 1450, 4848, 6237,
     3082, 3488, 139, 7045, 4116, 1222, 3676, 1102, 387, 0},
    {2616, 7999, 3504, 2241, 7696, 2612, 3641, 4456, 2900, 1504, 4283,
     6165, 6976, 278, 5898, 41, 2445, 7352, 2204, 774, 0},
    {5232, 7806, 7009, 4482, 7200, 5225, 7282, 720, 5801, 3008, 374,
     4139, 5761, 557, 3604, 83, 4890, 6512, 4409, 1548, 0},
    {5790, 7107, 4720, 322, 1473, 4816, 6414, 4235, 3262, 2007, 7516,
     7941, 3454, 1377, 2696, 6885, 1087, 4401, 337, 53, 0},
};

struct Fp { uint32_t v[NL]; };
struct Fp2 { Fp c0, c1; };
// Component 2*slot + {0: c0, 1: c1} of the coefficient basis, as KF12 rows.
struct Fq12 { Fp c[12]; };
// Unreduced product positions 0..41.
struct Wide { uint64_t t[2 * NL]; };

// ---------------------------------------------------------------------------
// Fq
// ---------------------------------------------------------------------------

// Exact carry to digits in [0, 2^13); x may hold small signed words and must
// represent a value in [0, 2^273).
static __device__ __forceinline__ void fp_carry(Fp& x) {
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int32_t t = (int32_t)x.v[i] + c;
    x.v[i] = (uint32_t)t & MASK;
    c = t >> RB;
  }
}

// x -= KP[row] when x >= KP[row]; x digits normalized in and out.
static __device__ __forceinline__ void fp_cond_sub(Fp& x, int row) {
  uint32_t d[NL];
  int32_t c = 0;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    int32_t t = (int32_t)x.v[i] - (int32_t)KP[row][i] + c;
    d[i] = (uint32_t)t & MASK;
    c = t >> RB;
  }
  const bool ge = (c == 0);
#pragma unroll
  for (int i = 0; i < NL; ++i) x.v[i] = ge ? d[i] : x.v[i];
}

// value < 32p -> value < 2p
static __device__ __forceinline__ void fp_reduce32(Fp& x) {
  fp_cond_sub(x, KP_16);
  fp_cond_sub(x, KP_8);
  fp_cond_sub(x, KP_4);
  fp_cond_sub(x, KP_2);
}

static __device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b) {
  Fp r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = a.v[i] + b.v[i];
  fp_carry(r);
  fp_cond_sub(r, KP_2);
  return r;
}

// a - b + 2p, reduced below 2p.
static __device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b) {
  Fp r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = a.v[i] + KP[KP_2][i] - b.v[i];
  fp_carry(r);
  fp_cond_sub(r, KP_2);
  return r;
}

// 2p - a (in (0, 2p]), reduced below 2p.
static __device__ __forceinline__ Fp fp_neg(const Fp& a) {
  Fp r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = KP[KP_2][i] - a.v[i];
  fp_carry(r);
  fp_cond_sub(r, KP_2);
  return r;
}

// k * a for 0 <= k <= 15, reduced below 2p.
static __device__ __forceinline__ Fp fp_small(const Fp& a, uint32_t k) {
  Fp r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = a.v[i] * k;
  fp_carry(r);
  fp_reduce32(r);
  return r;
}

static __device__ __forceinline__ void wide_zero(Wide& w) {
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) w.t[i] = 0;
}

// w += a * b, schoolbook over limbs.
static __device__ __forceinline__ void wide_mac(Wide& w, const Fp& a, const Fp& b) {
  uint32_t x[NL], y[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    x[i] = a.v[i];
    y[i] = b.v[i];
  }
#pragma unroll
  for (int i = 0; i < NL; ++i)
#pragma unroll
    for (int j = 0; j < NL; ++j) w.t[i + j] += (uint64_t)x[i] * y[j];
}

// r = w * R^{-1} mod p, word-by-word in 13-bit digits. Requires w < R p, so
// that r < w / R + p < 2p.
static __device__ __forceinline__ void mont_reduce(Wide& w, Fp& r) {
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint32_t m = ((uint32_t)w.t[i] * NP0) & MASK;
#pragma unroll
    for (int j = 0; j < NL; ++j) w.t[i + j] += (uint64_t)m * KP[KP_1][j];
    w.t[i + 1] += w.t[i] >> RB;  // w.t[i] is now a multiple of 2^13
  }
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const uint64_t s = w.t[NL + k] + c;
    r.v[k] = (uint32_t)s & MASK;
    c = s >> RB;
  }
}

// a * b * R^{-1}; operands < 2p, so the product is < 4p^2 < R p.
static __device__ __noinline__ Fp fp_mul(const Fp& a, const Fp& b) {
  Wide w;
  wide_zero(w);
  wide_mac(w, a, b);
  Fp r;
  mont_reduce(w, r);
  return r;
}

// a^e in the Montgomery domain for e = 1 followed by the MSB-first bits
// ``bits[0..n)`` (the leading one is consumed by starting at a).
static __device__ __noinline__ Fp fp_pow_bits(const Fp& a, const int32_t* __restrict__ bits,
                                              int n) {
  Fp r = a;
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    r = fp_mul(r, r);
    if (__ldg(bits + i)) r = fp_mul(r, a);
  }
  return r;
}

// ---------------------------------------------------------------------------
// Fq2 = Fq[u]/(u^2 + 1)
// ---------------------------------------------------------------------------

static __device__ __forceinline__ Fp2 fp2_neg(const Fp2& a) {
  return Fp2{fp_neg(a.c0), fp_neg(a.c1)};
}

static __device__ __forceinline__ Fp2 fp2_conj(const Fp2& a) {
  return Fp2{a.c0, fp_neg(a.c1)};
}

// (a0 b0 - a1 b1) + (a0 b1 + a1 b0) u; each lazy sum is < 8 p^2.
static __device__ __noinline__ Fp2 fp2_mul(const Fp2& a, const Fp2& b) {
  const Fp nb1 = fp_neg(b.c1);
  Fp2 r;
  Wide w;
  wide_zero(w);
  wide_mac(w, a.c0, b.c0);
  wide_mac(w, a.c1, nb1);
  mont_reduce(w, r.c0);
  wide_zero(w);
  wide_mac(w, a.c0, b.c1);
  wide_mac(w, a.c1, b.c0);
  mont_reduce(w, r.c1);
  return r;
}

static __device__ __forceinline__ Fp2 fp2_mul_fp(const Fp2& a, const Fp& k) {
  return Fp2{fp_mul(a.c0, k), fp_mul(a.c1, k)};
}

// (c0 - c1 u) / (c0^2 + c1^2): one Fermat inversion; ``bits`` are those of
// p - 2 after its leading one.
static __device__ __noinline__ Fp2 fp2_inv(const Fp2& a, const int32_t* __restrict__ bits,
                                           int n) {
  Wide w;
  wide_zero(w);
  wide_mac(w, a.c0, a.c0);
  wide_mac(w, a.c1, a.c1);
  Fp norm;
  mont_reduce(w, norm);
  const Fp ninv = fp_pow_bits(norm, bits, n);
  return Fp2{fp_mul(a.c0, ninv), fp_mul(fp_neg(a.c1), ninv)};
}

static __device__ __forceinline__ Fp2 fp2_add(const Fp2& a, const Fp2& b) {
  return Fp2{fp_add(a.c0, b.c0), fp_add(a.c1, b.c1)};
}

static __device__ __forceinline__ Fp2 fp2_sub(const Fp2& a, const Fp2& b) {
  return Fp2{fp_sub(a.c0, b.c0), fp_sub(a.c1, b.c1)};
}

static __device__ __forceinline__ Fp2 fp2_small(const Fp2& a, uint32_t k) {
  return Fp2{fp_small(a.c0, k), fp_small(a.c1, k)};
}

// xi * a = (9 a0 - a1) + (a0 + 9 a1) u, left unreduced: value < 20p.
static __device__ __forceinline__ Fp2 fp2_mul_xi_wide(const Fp2& a) {
  Fp2 r;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    r.c0.v[i] = 9 * a.c0.v[i] + KP[KP_2][i] - a.c1.v[i];
    r.c1.v[i] = a.c0.v[i] + 9 * a.c1.v[i];
  }
  fp_carry(r.c0);
  fp_carry(r.c1);
  return r;
}

static __device__ __forceinline__ Fp2 fp2_mul_xi(const Fp2& a) {
  Fp2 r = fp2_mul_xi_wide(a);
  fp_reduce32(r.c0);
  fp_reduce32(r.c1);
  return r;
}

// ((a0 + a1)(a0 - a1), 2 a0 a1): two products, sums below 16 p^2.
static __device__ __noinline__ Fp2 fp2_sq(const Fp2& a) {
  Fp s, d, t;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    s.v[i] = a.c0.v[i] + a.c1.v[i];
    d.v[i] = a.c0.v[i] + KP[KP_2][i] - a.c1.v[i];
    t.v[i] = 2 * a.c0.v[i];
  }
  fp_carry(s);
  fp_carry(d);
  fp_carry(t);
  Fp2 r;
  Wide w;
  wide_zero(w);
  wide_mac(w, s, d);
  mont_reduce(w, r.c0);
  wide_zero(w);
  wide_mac(w, t, a.c1);
  mont_reduce(w, r.c1);
  return r;
}

// ---------------------------------------------------------------------------
// Fq12 = Fq2[w]/(w^6 - xi), coefficient basis
// ---------------------------------------------------------------------------

// out = a * b over the slots of b named in the 6-bit mask ``present`` (0x3f:
// dense; 0x19: tangent slots 0,3,4; 0x2c: chord slots 2,3,5). The other
// slots of b are never read. out must not alias a or b.
static __device__ __noinline__ void fq12_mul(const Fq12& a, const Fq12& b,
                                             unsigned present, Fq12& out) {
  Fq12 xa;  // xi * a, unreduced (< 20p)
  Fp nb[6];  // 2p - b.c1 per slot
#pragma unroll 1
  for (int i = 0; i < 6; ++i) {
    const Fp2 x = fp2_mul_xi_wide(Fp2{a.c[2 * i], a.c[2 * i + 1]});
    xa.c[2 * i] = x.c0;
    xa.c[2 * i + 1] = x.c1;
    if ((present >> i) & 1u) nb[i] = fp_neg(b.c[2 * i + 1]);
  }
#pragma unroll 1
  for (int k = 0; k < 12; ++k) {
    const int s = k >> 1, comp = k & 1;
    Wide w;
    wide_zero(w);
#pragma unroll 1
    for (int i = 0; i < 6; ++i) {
      int j = s - i;
      const Fq12& A = j < 0 ? xa : a;  // w^(i+j) with i+j >= 6 folds as xi
      if (j < 0) j += 6;
      if (!((present >> j) & 1u)) continue;
#pragma unroll 1
      for (int t = 0; t < 2; ++t) {
        // c0: a0*b0 + a1*(2p - b1);  c1: a0*b1 + a1*b0
        const Fp& x = A.c[2 * i + t];
        const Fp& y = comp == 0 ? (t == 0 ? b.c[2 * j] : nb[j])
                                : b.c[2 * j + 1 - t];
        wide_mac(w, x, y);
      }
    }
    mont_reduce(w, out.c[k]);
  }
}

// out = a^2, dense (any a). Symmetric schoolbook over the 21 unordered slot
// pairs {i, j}: a cross pair adds 2 a_i a_j, a diagonal one a_i^2, folded by
// xi when i + j >= 6, every Fq2 term as four Fq products into the output
// coefficient's unreduced sum (84 Fq products; fq12_mul takes 144). The
// doubled left operand (< 40p, digits < 2^14) keeps each sum below 640 p^2
// < R p. out must not alias a.
static __device__ __noinline__ void fq12_sq(const Fq12& a, Fq12& out) {
  Fq12 xa;   // xi * a, unreduced (< 20p)
  Fp na[6];  // 2p - a.c1 per slot
#pragma unroll 1
  for (int i = 0; i < 6; ++i) {
    const Fp2 x = fp2_mul_xi_wide(Fp2{a.c[2 * i], a.c[2 * i + 1]});
    xa.c[2 * i] = x.c0;
    xa.c[2 * i + 1] = x.c1;
    na[i] = fp_neg(a.c[2 * i + 1]);
  }
#pragma unroll 1
  for (int k = 0; k < 12; ++k) {
    const int s = k >> 1, comp = k & 1;
    Wide w;
    wide_zero(w);
#pragma unroll 1
    for (int i = 0; i < 6; ++i) {
      int j = s - i;
      const Fq12& A = j < 0 ? xa : a;
      if (j < 0) j += 6;
      if (j < i) continue;  // the pair {j, i} was taken at i' = j
      const uint32_t twice = j != i;
#pragma unroll 1
      for (int t = 0; t < 2; ++t) {
        Fp x;
#pragma unroll
        for (int l = 0; l < NL; ++l) x.v[l] = A.c[2 * i + t].v[l] << twice;
        const Fp& y = comp == 0 ? (t == 0 ? a.c[2 * j] : na[j]) : a.c[2 * j + 1 - t];
        wide_mac(w, x, y);
      }
    }
    mont_reduce(w, out.c[k]);
  }
}

// Fq4 square of x + y w^3 with (w^3)^2 = xi, as in Granger-Scott.
static __device__ __forceinline__ void fq4_sq(const Fp2& x, const Fp2& y,
                                              Fp2& r0, Fp2& r1) {
  const Fp2 x2 = fp2_sq(x);
  const Fp2 y2 = fp2_sq(y);
  r1 = fp2_sub(fp2_sq(fp2_add(x, y)), fp2_add(x2, y2));
  r0 = fp2_add(x2, fp2_mul_xi(y2));
}

// Granger-Scott squaring; equals a^2 when a is in the cyclotomic subgroup.
// out must not alias a.
static __device__ __noinline__ void fq12_cyc_sq(const Fq12& a, Fq12& out) {
  Fp2 s[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) s[i] = Fp2{a.c[2 * i], a.c[2 * i + 1]};
  Fp2 A0, A1, B0, B1, C0, C1;
  fq4_sq(s[0], s[3], A0, A1);
  fq4_sq(s[1], s[4], B0, B1);
  fq4_sq(s[2], s[5], C0, C1);
  Fp2 o[6];
  o[0] = fp2_sub(fp2_small(A0, 3), fp2_small(s[0], 2));
  o[2] = fp2_sub(fp2_small(B0, 3), fp2_small(s[2], 2));
  o[4] = fp2_sub(fp2_small(C0, 3), fp2_small(s[4], 2));
  o[1] = fp2_add(fp2_small(fp2_mul_xi(C1), 3), fp2_small(s[1], 2));
  o[3] = fp2_add(fp2_small(A1, 3), fp2_small(s[3], 2));
  o[5] = fp2_add(fp2_small(B1, 3), fp2_small(s[5], 2));
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    out.c[2 * i] = o[i].c0;
    out.c[2 * i + 1] = o[i].c1;
  }
}

static __device__ __forceinline__ void fq12_set_one(Fq12& f) {
#pragma unroll 1
  for (int c = 0; c < 12; ++c)
#pragma unroll
    for (int l = 0; l < NL; ++l) f.c[c].v[l] = c == 0 ? KP[KP_ONE][l] : 0u;
}

// ---------------------------------------------------------------------------
// Device memory <-> lane registers, batch-last [comp, 21, lanes]
// ---------------------------------------------------------------------------

static __device__ __forceinline__ void load_fp(Fp& x, const int32_t* __restrict__ src,
                                               size_t lanes) {
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] = (uint32_t)__ldg(src + l * lanes);
  fp_carry(x);  // accept settled limbs (<= 2^13 + 1)
}

// An Fq2 as two consecutive component rows: c0 at ``src``, c1 one row on.
static __device__ __forceinline__ Fp2 load_fp2(const int32_t* __restrict__ src, size_t lanes) {
  Fp2 r;
  load_fp(r.c0, src, lanes);
  load_fp(r.c1, src + NL * lanes, lanes);
  return r;
}

static __device__ __forceinline__ void store_fp(const Fp& x, int32_t* __restrict__ dst,
                                                size_t lanes) {
#pragma unroll
  for (int l = 0; l < NL; ++l) dst[l * lanes] = (int32_t)x.v[l];
}

static __device__ __forceinline__ void store_fp2(const Fp2& x, int32_t* __restrict__ dst,
                                                 size_t lanes) {
  store_fp(x.c0, dst, lanes);
  store_fp(x.c1, dst + NL * lanes, lanes);
}

// ``src`` points at component 0 of this lane.
static __device__ __forceinline__ void load_fq12(Fq12& f, const int32_t* __restrict__ src,
                                                 size_t lanes) {
#pragma unroll 1
  for (int c = 0; c < 12; ++c) load_fp(f.c[c], src + c * NL * lanes, lanes);
}

// A line [6, 21, lanes] (3 Fq2 coefficients, ascending slots s0 < s1 < s2)
// into the slots of an Fq12 operand.
static __device__ __forceinline__ void load_line(Fq12& f, const int32_t* __restrict__ src,
                                                 size_t lanes, int s0, int s1, int s2) {
  const int slot[3] = {s0, s1, s2};
#pragma unroll 1
  for (int jj = 0; jj < 3; ++jj) {
    load_fp(f.c[2 * slot[jj]], src + (2 * jj) * NL * lanes, lanes);
    load_fp(f.c[2 * slot[jj] + 1], src + (2 * jj + 1) * NL * lanes, lanes);
  }
}

static __device__ __forceinline__ void store_fq12(const Fq12& f, int32_t* __restrict__ dst,
                                                  size_t lanes) {
#pragma unroll 1
  for (int c = 0; c < 12; ++c)
#pragma unroll
    for (int l = 0; l < NL; ++l) dst[(c * NL + l) * lanes] = (int32_t)f.c[c].v[l];
}

// Loads of scratch that the same kernel writes: plain loads, never the
// read-only (__ldg) path, which need not see the kernel's own stores.
static __device__ __forceinline__ void load_fp_rw(Fp& x, const int32_t* src, size_t lanes) {
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] = (uint32_t)src[l * lanes];
  fp_carry(x);
}

static __device__ __forceinline__ void load_fq12_rw(Fq12& f, const int32_t* src, size_t lanes) {
#pragma unroll 1
  for (int c = 0; c < 12; ++c) load_fp_rw(f.c[c], src + c * NL * lanes, lanes);
}

constexpr unsigned DENSE = 0x3f;
constexpr unsigned S034 = (1u << 0) | (1u << 3) | (1u << 4);
constexpr unsigned S235 = (1u << 2) | (1u << 3) | (1u << 5);
constexpr int BLOCK = 128;

}  // namespace pt
