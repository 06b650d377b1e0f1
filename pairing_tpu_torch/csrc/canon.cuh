// Exact reduction mod p of an operand read in place, shared by k_canonical
// (canonical.cu) and k_validate (validate.cu).
//
// Per operand and lane: the exact signed carry of its 21 limbs in 64 bits
// (limbs may exceed 2^13 + 1 and be lazy sums), the digits packed into five
// 64-bit words, then binary long division by p: for j = steps - 1 down to
// 0, subtract p 2^j when it fits. With value < bound <= p 2^steps every
// step keeps value < p 2^j, so the result is below p: the unique canonical
// representative. The host derives steps from the operand's static bound
// (at most 20: p 2^20 > R). An operand is a base pointer, a row stride and
// a limb stride: a row stride of 0 reads an expanded constant, the
// batch-last kernel layout is row stride 1 and limb stride lanes.
#pragma once

#include "field.cuh"

namespace pt {

constexpr int CANON_WORDS = 5;       // 320 bits hold 21 digits and the carry-out
constexpr int CANON_MAX_STEPS = 20;  // p 2^19 < R = 2^273 <= p 2^20

// p 2^j for j = 0..19, 64-bit words, least significant first.
static __constant__ uint64_t P_SHIFT[CANON_MAX_STEPS][CANON_WORDS] = {
    {0x3c208c16d87cfd47ull, 0x97816a916871ca8dull, 0xb85045b68181585dull,
     0x30644e72e131a029ull, 0x0000000000000000ull},
    {0x7841182db0f9fa8eull, 0x2f02d522d0e3951aull, 0x70a08b6d0302b0bbull,
     0x60c89ce5c2634053ull, 0x0000000000000000ull},
    {0xf082305b61f3f51cull, 0x5e05aa45a1c72a34ull, 0xe14116da06056176ull,
     0xc19139cb84c680a6ull, 0x0000000000000000ull},
    {0xe10460b6c3e7ea38ull, 0xbc0b548b438e5469ull, 0xc2822db40c0ac2ecull,
     0x83227397098d014dull, 0x0000000000000001ull},
    {0xc208c16d87cfd470ull, 0x7816a916871ca8d3ull, 0x85045b68181585d9ull,
     0x0644e72e131a029bull, 0x0000000000000003ull},
    {0x841182db0f9fa8e0ull, 0xf02d522d0e3951a7ull, 0x0a08b6d0302b0bb2ull,
     0x0c89ce5c26340537ull, 0x0000000000000006ull},
    {0x082305b61f3f51c0ull, 0xe05aa45a1c72a34full, 0x14116da060561765ull,
     0x19139cb84c680a6eull, 0x000000000000000cull},
    {0x10460b6c3e7ea380ull, 0xc0b548b438e5469eull, 0x2822db40c0ac2ecbull,
     0x3227397098d014dcull, 0x0000000000000018ull},
    {0x208c16d87cfd4700ull, 0x816a916871ca8d3cull, 0x5045b68181585d97ull,
     0x644e72e131a029b8ull, 0x0000000000000030ull},
    {0x41182db0f9fa8e00ull, 0x02d522d0e3951a78ull, 0xa08b6d0302b0bb2full,
     0xc89ce5c263405370ull, 0x0000000000000060ull},
    {0x82305b61f3f51c00ull, 0x05aa45a1c72a34f0ull, 0x4116da060561765eull,
     0x9139cb84c680a6e1ull, 0x00000000000000c1ull},
    {0x0460b6c3e7ea3800ull, 0x0b548b438e5469e1ull, 0x822db40c0ac2ecbcull,
     0x227397098d014dc2ull, 0x0000000000000183ull},
    {0x08c16d87cfd47000ull, 0x16a916871ca8d3c2ull, 0x045b68181585d978ull,
     0x44e72e131a029b85ull, 0x0000000000000306ull},
    {0x1182db0f9fa8e000ull, 0x2d522d0e3951a784ull, 0x08b6d0302b0bb2f0ull,
     0x89ce5c263405370aull, 0x000000000000060cull},
    {0x2305b61f3f51c000ull, 0x5aa45a1c72a34f08ull, 0x116da060561765e0ull,
     0x139cb84c680a6e14ull, 0x0000000000000c19ull},
    {0x460b6c3e7ea38000ull, 0xb548b438e5469e10ull, 0x22db40c0ac2ecbc0ull,
     0x27397098d014dc28ull, 0x0000000000001832ull},
    {0x8c16d87cfd470000ull, 0x6a916871ca8d3c20ull, 0x45b68181585d9781ull,
     0x4e72e131a029b850ull, 0x0000000000003064ull},
    {0x182db0f9fa8e0000ull, 0xd522d0e3951a7841ull, 0x8b6d0302b0bb2f02ull,
     0x9ce5c263405370a0ull, 0x00000000000060c8ull},
    {0x305b61f3f51c0000ull, 0xaa45a1c72a34f082ull, 0x16da060561765e05ull,
     0x39cb84c680a6e141ull, 0x000000000000c191ull},
    {0x60b6c3e7ea380000ull, 0x548b438e5469e104ull, 0x2db40c0ac2ecbc0bull,
     0x7397098d014dc282ull, 0x0000000000018322ull},
};

// One operand: limb l of lane i at ptr[i * row + l * limb]; ptr null: zero.
struct CanonOperand {
  const int32_t* ptr;
  long long row;
  long long limb;
  int steps;
};

// The operand's value at `lane` as five 64-bit words: the exact signed
// carry of its limbs, digit l at bit 13 l, the carry-out at bit 273.
static __device__ __forceinline__ void canon_load(const CanonOperand& o, long long lane,
                                                  uint64_t w[CANON_WORDS]) {
  const int32_t* x = o.ptr + lane * o.row;
#pragma unroll
  for (int k = 0; k < CANON_WORDS; ++k) w[k] = 0;
  long long carry = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const long long t = (long long)__ldg(x + l * o.limb) + carry;
    const uint64_t d = (uint64_t)(t & MASK);
    carry = t >> RB;  // arithmetic: borrows of negative limbs resolve
    const int bit = RB * l, k = bit / 64, s = bit % 64;
    w[k] |= d << s;
    if (s + RB > 64) w[k + 1] |= d >> (64 - s);
  }
  w[CANON_WORDS - 1] |= (uint64_t)carry << (RB * NL - 256);
}

// value mod p, for value < p 2^steps: subtract p 2^j where it fits.
static __device__ __forceinline__ void canon_reduce(uint64_t w[CANON_WORDS], int steps) {
#pragma unroll 1
  for (int j = steps - 1; j >= 0; --j) {
    uint64_t d[CANON_WORDS], borrow = 0;
#pragma unroll
    for (int k = 0; k < CANON_WORDS; ++k) {
      const uint64_t c = P_SHIFT[j][k];
      const uint64_t t = w[k] - c;
      const uint64_t under = w[k] < c;
      d[k] = t - borrow;
      borrow = under | (t < borrow);
    }
#pragma unroll
    for (int k = 0; k < CANON_WORDS; ++k) w[k] = borrow ? w[k] : d[k];
  }
}

}  // namespace pt
