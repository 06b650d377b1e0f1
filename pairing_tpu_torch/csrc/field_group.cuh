// Fq12 routines split over a group of six threads per lane, for kernels C
// (csrc/miller_f.cu), D (csrc/pow_ladder.cu), K12 (csrc/exp_bits.cu), K16
// (csrc/pow_naf.cu) and K17 (csrc/pow_w4.cu).
//
// field.cuh runs a whole Fq12 product in one thread: 252 words of operand
// beside a 42-word 64-bit accumulator do not fit the 255-register file, so
// its Fq12 routines spill to local memory, and one thread per lane leaves
// about four warps per SM at the pairing's batch of 16384. Here the Fq12
// operands live in shared memory and six threads share the work of a lane.
// A warp holds five lanes (threads 0..29, thread 6g + s is rank s of lane
// g); threads 30 and 31 take no part. Each thread keeps only one Fq
// operand pair and its 64-bit Wide accumulator in registers.
//
// * Dense product a * b: rank s computes output slot s, components c0 and
//   c1. Each is the sum of fq12_mul's k loop for k = 2s + comp (twelve
//   schoolbook Fq products, xi * a_i formed on the fly for the folded terms
//   and 2p - b1 for c0), then one Montgomery reduction: the same lazy sum,
//   below 480 p^2 < R p.
// * Dense square f^2 (fq12_sq): rank s sums the unordered slot pairs {i, j}
//   with i + j = s (mod 6), a cross pair's left operand doubled: four pairs
//   (8 Fq products a component) for even s, three (6) for odd s.
// * Product by a line (fq12_mul with a ``present`` mask): the line's three
//   Fq2 coefficients are staged in shared memory, one component a rank;
//   rank s sums the three terms whose right slot is present (6 Fq products
//   a component).
// * Granger-Scott cyclotomic square: rank s = 2j + h takes Fq4 pair (j,
//   j + 3) and component h of its three Fq2 squares x^2, y^2, (x + y)^2;
//   after an exchange through shared memory it forms component h of the
//   pair's two Fq2 results, and after another, output slot s.
//
// Every routine follows field.cuh's fq12_mul / fq12_sq / fq12_cyc_sq
// operation for operation on the same digits, so the outputs are those of
// kernels A, K18 and B digit for digit. Synchronisation is __syncwarp over
// the 30 working threads only; every thread of the group reaches every
// barrier.
#pragma once

#include "field.cuh"

namespace pt {

constexpr int GROUP = 6;        // threads per lane
constexpr int GROUP_LANES = 5;  // lanes per warp: 30 of its 32 threads
constexpr unsigned GROUP_MASK = (1u << (GROUP * GROUP_LANES)) - 1;
constexpr int F12_WORDS = 12 * NL;
// The shared region of a lane in kernels D and K12: its Fq12 f, then a
// scratch of the same size (the staged table row or x, or the square's
// partial results). One word of padding keeps the 30 threads of a warp at
// most two to a bank.
constexpr int GROUP_STRIDE = 2 * F12_WORDS + 1;

static __device__ __forceinline__ void sh_load(Fp& x, const uint32_t* p) {
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] = p[l];
}

static __device__ __forceinline__ void sh_store(const Fp& x, uint32_t* p) {
#pragma unroll
  for (int l = 0; l < NL; ++l) p[l] = x.v[l];
}

// Slot s (components 2s, 2s + 1) of the lane's batch-last Fq12 at ``src``
// (component 0 of this lane's column) into the shared Fq12 ``dst``.
static __device__ __forceinline__ void group_load_slot(uint32_t* dst,
                                                       const int32_t* __restrict__ src,
                                                       size_t lanes, int s) {
#pragma unroll 1
  for (int c = 2 * s; c < 2 * s + 2; ++c) {
    Fp x;
    load_fp(x, src + c * NL * lanes, lanes);
    sh_store(x, dst + c * NL);
  }
}

// f <- 1 (fq12_set_one): rank s writes slot s, the Montgomery one in
// component 0 and zeros elsewhere. The caller's barrier makes it visible.
static __device__ __forceinline__ void group_set_one(uint32_t* f, int s) {
#pragma unroll 1
  for (int c = 2 * s; c < 2 * s + 2; ++c)
#pragma unroll
    for (int l = 0; l < NL; ++l) f[c * NL + l] = c == 0 ? KP[KP_ONE][l] : 0u;
}

static __device__ __forceinline__ void group_store_slot(const uint32_t* f,
                                                        int32_t* __restrict__ dst,
                                                        size_t lanes, int s) {
#pragma unroll 1
  for (int c = 2 * s; c < 2 * s + 2; ++c) {
    Fp x;
    sh_load(x, f + c * NL);
    store_fp(x, dst + c * NL * lanes, lanes);
  }
}

// Component h of fp2_sq(a0 + a1 u): (a0 + a1)(a0 - a1 + 2p) for h = 0,
// (2 a0) a1 for h = 1, one reduction each, as in fp2_sq. The operands are
// selected limb by limb, so both ranks run the same instructions.
static __device__ __forceinline__ Fp fp2_sq_part(const Fp& a0, const Fp& a1, int h) {
  Fp x, y;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    x.v[l] = h ? 2 * a0.v[l] : a0.v[l] + a1.v[l];
    y.v[l] = h ? a1.v[l] : a0.v[l] + KP[KP_2][l] - a1.v[l];
  }
  fp_carry(x);
  fp_carry(y);  // a1's digits are settled already: no change for h = 1
  Wide w;
  wide_zero(w);
  wide_mac(w, x, y);
  Fp r;
  mont_reduce(w, r);
  return r;
}

// w += fq12_mul's two Fq products (its t loop) for the term a_i b_j of
// component ``comp``; a is slot i of the left operand and b slot j of the
// right one (shared, [2][21] each). x: component t of a_i, or of xi * a_i
// when ``fold`` (fp2_mul_xi_wide, < 20p), shifted left by ``shift`` (1 for
// fq12_sq's doubled cross pairs); y: b0, 2p - b1 for c0, b1, b0 for c1.
static __device__ __forceinline__ void group_mac_term(Wide& w, const uint32_t* a,
                                                      const uint32_t* b, bool fold, int comp,
                                                      uint32_t shift) {
#pragma unroll 1
  for (int t = 0; t < 2; ++t) {
    // y: c0 = a0*b0 + a1*(2p - b1);  c1 = a0*b1 + a1*b0
    Fp y;
    if (comp == 0 && t == 1) {
      Fp b1;
      sh_load(b1, b + NL);
      y = fp_neg(b1);
    } else {
      sh_load(y, b + (comp == t ? 0 : NL));
    }
    // x: selected limb by limb, so all ranks run the same instructions
    Fp x;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const uint32_t u0 = a[l], u1 = a[NL + l];
      const uint32_t x0 = fold ? 9 * u0 + KP[KP_2][l] - u1 : u0;
      const uint32_t x1 = fold ? u0 + 9 * u1 : u1;
      x.v[l] = t ? x1 : x0;
    }
    fp_carry(x);  // settled digits pass unchanged when not folded
#pragma unroll
    for (int l = 0; l < NL; ++l) x.v[l] <<= shift;
    wide_mac(w, x, y);
  }
}

// Component ``comp`` of output slot s of a * b, a at ``fa`` and b at ``fb``
// (shared, [12][21] each): fq12_mul's k = 2s + comp sum over the dense b.
static __device__ __forceinline__ Fp group_mul_part(const uint32_t* fa, const uint32_t* fb,
                                                    int s, int comp) {
  Wide w;
  wide_zero(w);
#pragma unroll 1
  for (int i = 0; i < 6; ++i) {
    const bool fold = i > s;  // w^(i+j) with i + j >= 6 folds as xi
    const int j = fold ? s - i + 6 : s - i;
    group_mac_term(w, fa + 2 * i * NL, fb + 2 * j * NL, fold, comp, 0);
  }
  Fp r;
  mont_reduce(w, r);
  return r;
}

// Component ``comp`` of output slot s of f^2 (f shared, [12][21]): fq12_sq's
// k = 2s + comp sum over the unordered slot pairs {i, j}, i <= j, in its
// order of i: i = 0 .. s/2 with j = s - i, then i = s + 1 .. (s + 6)/2
// with j = s - i + 6, folded by xi. The left operand of a cross pair
// (i != j) is doubled; the sum stays below 640 p^2 < R p.
static __device__ __forceinline__ Fp group_sq_part(const uint32_t* f, int s, int comp) {
  const int h = s >> 1;
  const int pairs = (s & 1) ? 3 : 4;
  Wide w;
  wide_zero(w);
#pragma unroll 1
  for (int q = 0; q < pairs; ++q) {
    const bool fold = q > h;
    const int i = fold ? s + q - h : q;
    const int j = fold ? s - i + 6 : s - i;
    group_mac_term(w, f + 2 * i * NL, f + 2 * j * NL, fold, comp, i != j);
  }
  Fp r;
  mont_reduce(w, r);
  return r;
}

// Component ``comp`` of output slot s of f * line: fq12_mul's k = 2s + comp
// sum over the present slots j = s0, s1, s2, whose coefficients are the
// line's rows 0-1, 2-3, 4-5 (shared, [6][21]); i = s - j (mod 6).
static __device__ __forceinline__ Fp group_sparse_part(const uint32_t* f, const uint32_t* line,
                                                       int s, int comp, int s0, int s1, int s2) {
  Wide w;
  wide_zero(w);
#pragma unroll 1
  for (int m = 0; m < 3; ++m) {
    const int j = m == 0 ? s0 : m == 1 ? s1 : s2;
    const bool fold = j > s;
    const int i = fold ? s - j + 6 : s - j;
    group_mac_term(w, f + 2 * i * NL, line + 2 * m * NL, fold, comp, 0);
  }
  Fp r;
  mont_reduce(w, r);
  return r;
}

constexpr int PACKED = (NL + 1) / 2;  // words of an Fp packed two digits a word

// A result's 13-bit digits two to a word, to wait through the next sum.
static __device__ __forceinline__ void pack_digits(const Fp& r, uint32_t (&p)[PACKED]) {
#pragma unroll
  for (int k = 0; k < PACKED; ++k)
    p[k] = r.v[2 * k] | (2 * k + 1 < NL ? r.v[2 * k + 1] << 16 : 0u);
}

// Rank s writes slot s of f in place, once every rank has read all of f:
// barrier, write, barrier.
static __device__ __forceinline__ void group_write_slot(uint32_t* f, int s,
                                                        const uint32_t (&r0)[PACKED],
                                                        const Fp& r1) {
  __syncwarp(GROUP_MASK);
  uint32_t* o = f + 2 * s * NL;
#pragma unroll
  for (int l = 0; l < NL; ++l) o[l] = (r0[l >> 1] >> (16 * (l & 1))) & MASK;
  sh_store(r1, o + NL);
  __syncwarp(GROUP_MASK);
}

// f <- f * b for the lane (b dense, in ``b``). Each of the in-place
// routines below computes c0 first; it waits through the c1 sum packed.
static __device__ __forceinline__ void group_fq12_mul(uint32_t* f, const uint32_t* b, int s) {
  uint32_t r0[PACKED];
  pack_digits(group_mul_part(f, b, s, 0), r0);
  group_write_slot(f, s, r0, group_mul_part(f, b, s, 1));
}

// dst <- a * b for the lane (b dense); dst may be a or b, since every rank
// reads all of both before any rank writes. Kernel K17 runs its table's
// products (m2 * f, the plain version's operand order) and its ladder's (f
// times the staged entry) through this one call site.
static __device__ __forceinline__ void group_fq12_mul_to(uint32_t* dst, const uint32_t* a,
                                                         const uint32_t* b, int s) {
  uint32_t r0[PACKED];
  pack_digits(group_mul_part(a, b, s, 0), r0);
  group_write_slot(dst, s, r0, group_mul_part(a, b, s, 1));
}

// f <- f^2, dense (fq12_sq), for any f.
static __device__ __forceinline__ void group_fq12_sq(uint32_t* f, int s) {
  uint32_t r0[PACKED];
  pack_digits(group_sq_part(f, s, 0), r0);
  group_write_slot(f, s, r0, group_sq_part(f, s, 1));
}

// f <- f * line, the line staged in ``line`` with coefficients at slots
// s0 < s1 < s2 (0, 3, 4 or 2, 3, 5); fq12_mul's ``present`` mask.
static __device__ __forceinline__ void group_fq12_mul_sparse(uint32_t* f, const uint32_t* line,
                                                             int s, int s0, int s1, int s2) {
  uint32_t r0[PACKED];
  pack_digits(group_sparse_part(f, line, s, 0, s0, s1, s2), r0);
  group_write_slot(f, s, r0, group_sparse_part(f, line, s, 1, s0, s1, s2));
}

// Component s of a line [6, 21, lanes] (``src`` at component 0 of the
// lane's column) into the lane's shared line: one Fq a rank, carried as
// load_line does. The caller's barrier makes it visible to the group.
static __device__ __forceinline__ void group_stage_line(uint32_t* line,
                                                        const int32_t* __restrict__ src,
                                                        size_t lanes, int s) {
  Fp x;
  load_fp(x, src + s * NL * lanes, lanes);
  sh_store(x, line + s * NL);
}

// f <- the Granger-Scott square of f (fq12_cyc_sq), in place; ``scr`` holds
// the pairs' results: entry (pair, which, comp) at scr + (4 pair + 2 which
// + comp) NL, which 0 = x^2 + xi y^2, which 1 = (x + y)^2 - x^2 - y^2.
static __device__ __forceinline__ void group_cyc_sq(uint32_t* f, uint32_t* scr, int s) {
  const int j = s >> 1, h = s & 1;
  uint32_t* r0p = scr + (4 * j + h) * NL;
  uint32_t* r1p = scr + (4 * j + 2 + h) * NL;
  const uint32_t* x = f + 2 * j * NL;        // slot j
  const uint32_t* y = f + 2 * (j + 3) * NL;  // slot j + 3
  // component h of y^2 (parked in r1p), x^2 (parked in r0p), (x + y)^2
  Fp sq3;
#pragma unroll 1
  for (int q = 0; q < 3; ++q) {
    Fp a0, a1;
    if (q == 2) {
      Fp u, v;
      sh_load(u, x);
      sh_load(v, y);
      a0 = fp_add(u, v);
      sh_load(u, x + NL);
      sh_load(v, y + NL);
      a1 = fp_add(u, v);
    } else {
      const uint32_t* p = q == 0 ? y : x;
      sh_load(a0, p);
      sh_load(a1, p + NL);
    }
    const Fp r = fp2_sq_part(a0, a1, h);
    if (q == 0) {
      sh_store(r, r1p);
    } else if (q == 1) {
      sh_store(r, r0p);
    } else {
      sq3 = r;
    }
  }
  __syncwarp(GROUP_MASK);
  {
    // component h of y^2 and of xi * y^2 (fp2_mul_xi), from the parked pair
    const uint32_t* y2p = scr + (4 * j + 2) * NL;
    Fp x2, y2, xy2;
    sh_load(x2, r0p);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const uint32_t u0 = y2p[l], u1 = y2p[NL + l];
      y2.v[l] = h ? u1 : u0;
      xy2.v[l] = h ? u0 + 9 * u1 : 9 * u0 + KP[KP_2][l] - u1;
    }
    fp_carry(xy2);
    fp_reduce32(xy2);
    sh_store(fp_add(x2, xy2), r0p);  // only this rank reads its parked x^2
    const Fp r1 = fp_sub(sq3, fp_add(x2, y2));
    __syncwarp(GROUP_MASK);  // the partner has read the parked y^2
    sh_store(r1, r1p);
  }
  __syncwarp(GROUP_MASK);
  // slot s: o[0, 2, 4] = 3 r0 - 2 f_s of pairs 0, 1, 2; o[3, 5] = 3 r1 + 2 f_s
  // of pairs 0, 1; o[1] = 3 xi r1 + 2 f_1 of pair 2. Component by component,
  // in place: no other rank reads slot s now.
  const int odd = s & 1;
  const bool xi = s == 1;
  const int pair = odd ? ((s >> 1) + 2) % 3 : s >> 1;
  const uint32_t* e = scr + (4 * pair + 2 * odd) * NL;
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    Fp x, own;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const uint32_t u0 = e[l], u1 = e[NL + l];
      x.v[l] = xi ? (c ? u0 + 9 * u1 : 9 * u0 + KP[KP_2][l] - u1) : (c ? u1 : u0);
    }
    if (xi) {
      fp_carry(x);
      fp_reduce32(x);
    }
    uint32_t* fs = f + (2 * s + c) * NL;
    sh_load(own, fs);
    const Fp t3 = fp_small(x, 3), t2 = fp_small(own, 2);
    sh_store(odd ? fp_add(t3, t2) : fp_sub(t3, t2), fs);
  }
  __syncwarp(GROUP_MASK);
}

}  // namespace pt
