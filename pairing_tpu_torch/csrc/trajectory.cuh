// Kernel H's two-thread Fq2 arithmetic and its mixed addition, shared with
// the Miller loop's epilogue points (miller_epilogue.cu).
//
// Two threads per lane: rank h = 0, 1 computes component h of every Fq2
// value. A component of an Fq2 product is two Fq products into one
// accumulator and one Montgomery reduction (fp2_mul), of an Fq2 square one
// product (fp2_sq), and every linear operation (add, sub, small multiple,
// negation) works one component at a time. A warp holds 16 lanes: threads
// 0-15 are rank 0 of lanes 0-15, threads 16-31 rank 1 of the same lanes.
//
// A lane's Fq2 values live in shared-memory slots, both components, laid
// out [slot][comp][limb][16 lanes] per warp, and a slot pointer already
// points at the lane's column. The two components of a limb are 336 words
// apart, 16 banks, so the 32 threads of a warp hit 32 banks. A rank keeps
// in registers only its accumulator, the operand pair of its current
// product and the values of the current stage. The accumulator's columns
// are 32-bit (field32.cuh).
//
// Each stage writes the components that the next stage reads whole; a
// __syncwarp follows, and every thread reaches every barrier. Both ranks run
// the same instructions: operands are selected limb by limb, never by a
// branch on the rank.
//
// The operations, their operands' order and every reduction are those of
// field.cuh's fp2_mul / fp2_sq / fp_add / fp_sub / fp_small / fp_neg, and
// each computes the same integers.
#pragma once

#include "field32.cuh"

namespace pt {

constexpr int H_LANES = 16;                     // lanes per warp
constexpr int H_COMP = NL * H_LANES;            // words of one component of a slot
constexpr int H_SLOT = 2 * H_COMP;              // words of one Fq2 slot

// A slot's word for (comp, limb) of this lane: s + comp * H_COMP + limb *
// H_LANES, where s already points at the lane's column of the slot.
static __device__ __forceinline__ void ld(Fp& x, const uint32_t* s, int comp) {
  const uint32_t* p = s + comp * H_COMP;
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] = p[l * H_LANES];
}

static __device__ __forceinline__ void st(const Fp& x, uint32_t* s, int comp) {
  uint32_t* p = s + comp * H_COMP;
#pragma unroll
  for (int l = 0; l < NL; ++l) p[l * H_LANES] = x.v[l];
}

// The affine point of a mixed addition, read one coordinate component at a
// time: row 0-3 is x.c0, x.c1, y.c0, y.c1. QRows reads this lane's column
// of batch-last rows [4, 21, lanes] in device memory (kernel H's Q), QSlots
// two slots x, y of the lane's shared memory (the epilogue's Q1, which the
// same kernel computes).
struct QRows {
  const int32_t* __restrict__ q;
  size_t lanes;

  __device__ __forceinline__ void load(Fp& x, int row) const {
    load_fp(x, q + row * NL * lanes, lanes);
  }
};

struct QSlots {
  const uint32_t* s;

  __device__ __forceinline__ void load(Fp& x, int row) const {
    ld(x, s + (row >> 1) * H_SLOT, row & 1);
  }
};

// w += x times the component of the slot b that fp2_mul pairs with
// component c of its left operand for output component h: b_h for c = 0;
// for c = 1, b0 (h = 1) or 2p - b1 (h = 0), selected limb by limb.
static __device__ __forceinline__ void mac_b(Wide32& w, const Fp& x, const uint32_t* b, int c,
                                             int h) {
  Fp y;
  ld(y, b, c ^ h);
  if (c) {
    const Fp ny = fp_neg(y);
#pragma unroll
    for (int l = 0; l < NL; ++l) y.v[l] = h ? y.v[l] : ny.v[l];
  }
  w32_mac(w, x, y);
}

// Component h of fp2_mul(a, b): a0 b0 + a1 (2p - b1) for h = 0, a0 b1 +
// a1 b0 for h = 1, one reduction.
static __device__ __forceinline__ Fp mul_part(const uint32_t* a, const uint32_t* b, int h) {
  Wide32 w;
  w32_zero(w);
  Fp x;
  ld(x, a, 0);
  mac_b(w, x, b, 0, h);
  ld(x, a, 1);
  mac_b(w, x, b, 1, h);
  Fp r;
  w32_reduce(w, r);
  return r;
}

// The same with the left operand the affine point's coordinate at rows
// ``row``, ``row`` + 1 (0: x, 2: y), negated when ``neg``.
template <class Q>
static __device__ __forceinline__ Fp mul_part_q(const Q& q, int row, bool neg, const uint32_t* b,
                                                int h) {
  Wide32 w;
  w32_zero(w);
#pragma unroll 1
  for (int c = 0; c < 2; ++c) {
    Fp x;
    q.load(x, row + c);
    if (neg) x = fp_neg(x);
    mac_b(w, x, b, c, h);
  }
  Fp r;
  w32_reduce(w, r);
  return r;
}

// Component h of fp2_sq(a0 + a1 u), as field_group.cuh's fp2_sq_part:
// (a0 + a1)(a0 - a1 + 2p) for h = 0, (2 a0) a1 for h = 1.
static __device__ __forceinline__ Fp sq_of(const Fp& a0, const Fp& a1, int h) {
  Fp x, y;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    x.v[l] = h ? 2 * a0.v[l] : a0.v[l] + a1.v[l];
    y.v[l] = h ? a1.v[l] : a0.v[l] + KP[KP_2][l] - a1.v[l];
  }
  fp_carry(x);
  fp_carry(y);
  Wide32 w;
  w32_zero(w);
  w32_mac(w, x, y);
  Fp r;
  w32_reduce(w, r);
  return r;
}

// Component h of fp2_sq of the slot a.
static __device__ __forceinline__ Fp sq_part(const uint32_t* a, int h) {
  Fp a0, a1;
  ld(a0, a, 0);
  ld(a1, a, 1);
  return sq_of(a0, a1, h);
}

// Component h of fp2_sq(fp2_add(a, b)).
static __device__ __forceinline__ Fp sq_sum_part(const uint32_t* a, const uint32_t* b, int h) {
  Fp u, v;
  ld(u, a, 0);
  ld(v, b, 0);
  const Fp s0 = fp_add(u, v);
  ld(u, a, 1);
  ld(v, b, 1);
  return sq_of(s0, fp_add(u, v), h);
}

// Component h of a slot (rows h, h + 2, h + 4 of a Jacobian state: X, Y, Z)
// to the batch-last rows [6, 21, lanes] at dst (this lane's column).
static __device__ __forceinline__ void store_state(const uint32_t* s, int32_t* __restrict__ dst,
                                                   size_t lanes, int h) {
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    Fp x;
    ld(x, s + k * H_SLOT, h);
    store_fp(x, dst + (2 * k + h) * NL * lanes, lanes);
  }
}

// jac_mixed_add (madd-2007-bl): state p plus the affine q into state r, q's
// y negated when ``neg``. r's slots are written; of p's, only Z is (with a
// temporary, once p's Z is read no more). t: four temporary slots.
template <class Q>
static __device__ __forceinline__ void lane_mixed_add(uint32_t* p, const Q& q, bool neg,
                                                      uint32_t* r, uint32_t* t, int h) {
  const uint32_t *X = p, *Y = p + H_SLOT;
  uint32_t* Z = p + 2 * H_SLOT;
  uint32_t *rX = r, *rY = r + H_SLOT, *rZ = r + 2 * H_SLOT;
  uint32_t *t0 = t, *t1 = t + H_SLOT, *t2 = t + 2 * H_SLOT, *t3 = t + 3 * H_SLOT;
  // stage 1: Z1Z1 = Z^2 (t0); T = qy Z (t1)
  st(sq_part(Z, h), t0, h);
  st(mul_part_q(q, 2, neg, Z, h), t1, h);
  __syncwarp();
  // stage 2: U2 = qx Z1Z1, S2 = T Z1Z1; H = U2 - X (t2), rr = 2(S2 - Y) (t3)
  {
    const Fp U2 = mul_part_q(q, 0, false, t0, h);
    Fp x;
    ld(x, X, h);
    st(fp_sub(U2, x), t2, h);
  }
  {
    const Fp S2 = mul_part(t1, t0, h);
    Fp y;
    ld(y, Y, h);
    st(small<2>(fp_sub(S2, y)), t3, h);
  }
  __syncwarp();
  // stage 3: Z3 = (Z + H)^2 - Z1Z1 - HH (rZ); I = 4 HH (t1), HH = H^2;
  // rr^2 (kept in rX)
  {
    Fp z;
    ld(z, t0, h);
    st(fp_sub(sq_sum_part(Z, t2, h), z), rZ, h);
  }
  {
    const Fp HH = sq_part(t2, h);
    st(small<4>(HH), t1, h);
    Fp z;
    ld(z, rZ, h);
    st(fp_sub(z, HH), rZ, h);
  }
  st(sq_part(t3, h), rX, h);
  __syncwarp();
  // stage 4: J = H I (t0), V = X I; X3 = rr^2 - J - 2V (rX), W = V - X3 (Z's
  // slot: p's Z is read no more)
  {
    const Fp J = mul_part(t2, t1, h);
    st(J, t0, h);
    const Fp V = mul_part(X, t1, h);
    Fp s;
    ld(s, rX, h);
    const Fp X3 = fp_sub(fp_sub(s, J), small<2>(V));
    st(X3, rX, h);
    st(fp_sub(V, X3), Z, h);
  }
  __syncwarp();
  // stage 5: Y3 = rr W - 2 Y J
  {
    const Fp m = mul_part(t3, Z, h);
    st(m, rY, h);
    const Fp yj = mul_part(Y, t0, h);
    Fp u;
    ld(u, rY, h);
    st(fp_sub(u, small<2>(yj)), rY, h);
  }
  __syncwarp();
}

}  // namespace pt
