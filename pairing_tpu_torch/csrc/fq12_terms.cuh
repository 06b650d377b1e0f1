// The term machinery of the Fq12 kernels that run one thread per (output
// component, lane) over a block's rows staged in shared memory: kernel B
// (cyc_sq.cu, the cyclotomic square), K18 (fq12_sq.cu, the dense square)
// and K15 (hard_chain.cu, whose cyclotomic squares are B's components).
//
// A block is B_LANES lanes x B_COMPS output components: threadIdx.x the
// lane, threadIdx.y the component k = 2s + comp, so every branch is uniform
// in a warp. Output slot s of a square is a sum of Fq2 terms x y over slot
// pairs (BTerm: x = slot t.x, times xi and/or 2 when flagged, carried; y =
// slot t.y; B_SQ a square x x), read from a table (B_TERMS / B_SLOTS here,
// SQ_TERMS / SQ_SLOTS in fq12_sq.cu) and summed by mac_cyc_term into one
// 32-bit column sum, a carry-save fold (w32_fold) between terms. The
// column bound is cyc_sq.cu's: a term adds at most 42 limb products below
// 2^26 to a column.
#pragma once

#include "field32.cuh"

namespace pt {

constexpr int B_LANES = 32;                 // lanes per block: threadIdx.x
constexpr int B_COMPS = 12;                 // output components: threadIdx.y
constexpr int B_THREADS = B_LANES * B_COMPS;
constexpr int B_ROW = NL * B_LANES;         // words of one shared row

// Term flags: x <- xi x, then x <- 2 x; B_SQ: the term is x x.
enum : uint8_t { B_FOLD = 1, B_DBL = 2, B_SQ = 4 };

struct BTerm { uint8_t x, y, flags; };
// Output slot i: terms [first, first + count) of B_TERMS.
struct BSlot { uint8_t first, count; };

static __constant__ BTerm B_TERMS[] = {
    {0, 0, B_SQ}, {3, 3, B_FOLD},  // 0: T_0 = s0^2 + xi s3^2
    {2, 5, B_FOLD | B_DBL},        // 2: T_1 = xi 2 s2 s5
    {1, 1, B_SQ}, {4, 4, B_FOLD},  // 3: T_2 = s1^2 + xi s4^2
    {0, 3, B_DBL},                 // 5: T_3 = 2 s0 s3
    {2, 2, B_SQ}, {5, 5, B_FOLD},  // 6: T_4 = s2^2 + xi s5^2
    {1, 4, B_DBL},                 // 8: T_5 = 2 s1 s4
};
static __constant__ BSlot B_SLOTS[6] = {{0, 2}, {2, 1}, {3, 2}, {5, 1}, {6, 2}, {8, 1}};

// Component ``row`` of this thread's lane from the block's shared rows,
// [row][limb][32 lanes], digits below 2^13; ``sm`` is this lane's word of
// row 0, limb 0.
static __device__ __forceinline__ void load_row(Fp& x, const uint32_t* sm, int row) {
  const uint32_t* src = sm + row * B_ROW;
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] = src[l * B_LANES];
}

// w += component ``comp`` of the Fq2 term t.
static __device__ __forceinline__ void mac_cyc_term(Wide32& w, const uint32_t* sm, BTerm t,
                                                    int comp) {
  Fp x0, x1;
  load_row(x0, sm, 2 * t.x);
  load_row(x1, sm, 2 * t.x + 1);
  if (t.flags & B_SQ) {
    if (comp == 0) {  // x0^2 + x1 (2p - x1)
      w32_sq_mac(w, x0);
      w32_mac(w, x1, fp_neg(x1));
    } else {  // 2 x0 x1
#pragma unroll
      for (int l = 0; l < NL; ++l) x0.v[l] <<= 1;
      fp_carry(x0);
      w32_mac(w, x0, x1);
    }
    return;
  }
  if (t.flags & B_FOLD) {  // fp2_mul_xi_wide
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
  load_row(y, sm, 2 * t.y + comp);  // y0 for c0, y1 for c1
  w32_mac(w, x0, y);
  load_row(y, sm, 2 * t.y + 1 - comp);
  if (comp == 0) y = fp_neg(y);  // 2p - y1 for c0, y0 for c1
  w32_mac(w, x1, y);
}

// Output component k (warp-uniform) of this lane.
static __device__ __forceinline__ Fp cyc_component(int k, const uint32_t* sm) {
  const int i = k >> 1, comp = k & 1;
  const BSlot slot = B_SLOTS[i];
  Wide32 w;
  w32_zero(w);
#pragma unroll 1
  for (int j = 0; j < slot.count; ++j) {
    if (j) w32_fold(w);
    mac_cyc_term(w, sm, B_TERMS[slot.first + j], comp);
  }
  Fp t, s;
  w32_reduce_imm(w, t);
  load_row(s, sm, k);
  const Fp t3 = small<3>(t), s2 = small<2>(s);
  return (i & 1) ? fp_add(t3, s2) : fp_sub(t3, s2);
}

// Row k of this lane's operand into the block's shared rows, carried on
// load: ``rows`` at this lane's word of row 0, limb 0, ``a`` at this lane's
// column of component 0 of a tensor of n lanes.
static __device__ __forceinline__ void stage_row(uint32_t* rows, const int32_t* a, int k,
                                                 size_t n) {
  Fp x;
  load_fp(x, a + k * NL * n, n);
  uint32_t* dst = rows + k * B_ROW;
#pragma unroll
  for (int l = 0; l < NL; ++l) dst[l * B_LANES] = x.v[l];
}

}  // namespace pt
