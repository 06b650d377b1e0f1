// Fq12 routines split over a group of six threads per lane, for kernel D
// (csrc/pow_ladder.cu).
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
// * Granger-Scott cyclotomic square: rank s = 2j + h takes Fq4 pair (j,
//   j + 3) and component h of its three Fq2 squares x^2, y^2, (x + y)^2;
//   after an exchange through shared memory it forms component h of the
//   pair's two Fq2 results, and after another, output slot s.
//
// Every routine follows field.cuh's fq12_mul / fq12_cyc_sq operation for
// operation on the same digits, so the outputs are those of kernels A and B
// digit for digit. Synchronisation is __syncwarp over the 30 working
// threads only; every thread of the group reaches every barrier.
#pragma once

#include "field.cuh"

namespace pt {

constexpr int GROUP = 6;        // threads per lane
constexpr int GROUP_LANES = 5;  // lanes per warp: 30 of its 32 threads
constexpr unsigned GROUP_MASK = (1u << (GROUP * GROUP_LANES)) - 1;
constexpr int F12_WORDS = 12 * NL;
// A lane's shared region: its Fq12 f, then a scratch of the same size (the
// staged table row, or the square's partial results). One word of padding
// keeps the 30 threads of a warp at most two to a bank.
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
    const uint32_t* a = fa + 2 * i * NL;
    const uint32_t* b = fb + 2 * j * NL;
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
      // x: component t of a_i, or of xi * a_i (fp2_mul_xi_wide, < 20p)
      Fp x;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const uint32_t u0 = a[l], u1 = a[NL + l];
        const uint32_t x0 = fold ? 9 * u0 + KP[KP_2][l] - u1 : u0;
        const uint32_t x1 = fold ? u0 + 9 * u1 : u1;
        x.v[l] = t ? x1 : x0;
      }
      fp_carry(x);  // settled digits pass unchanged when not folded
      wide_mac(w, x, y);
    }
  }
  Fp r;
  mont_reduce(w, r);
  return r;
}

// f <- f * b for the lane (b dense, in ``b``); rank s writes slot s once
// every rank has read all of f. Its c0 waits through the c1 sum packed two
// 13-bit digits to a word.
static __device__ __forceinline__ void group_fq12_mul(uint32_t* f, const uint32_t* b, int s) {
  constexpr int NP = (NL + 1) / 2;
  uint32_t r0[NP];
  {
    const Fp r = group_mul_part(f, b, s, 0);
#pragma unroll
    for (int k = 0; k < NP; ++k)
      r0[k] = r.v[2 * k] | (2 * k + 1 < NL ? r.v[2 * k + 1] << 16 : 0u);
  }
  const Fp r1 = group_mul_part(f, b, s, 1);
  __syncwarp(GROUP_MASK);
  uint32_t* o = f + 2 * s * NL;
#pragma unroll
  for (int l = 0; l < NL; ++l) o[l] = (r0[l >> 1] >> (16 * (l & 1))) & MASK;
  sh_store(r1, o + NL);
  __syncwarp(GROUP_MASK);
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
