// Canonical reduction mod p and the exact equality tests built on it
// (k_canonical).
//
// Replaces no TPU kernel: the JAX package reduces with fused XLA inside its
// jitted graphs (pairing_tpu/fields/fp.py:445 canonical, :464 fp_eq, :470
// fp_is_zero), and the port ran the same code eagerly: per value a weak
// reduction while the bound exceeds 2p, then two 21-step Python carry loops
// (fields/fp.py _ripple_carry), some 130 small launches and a blocking copy
// of p's limbs. Every exact compare of a Groth16 call (the on-curve checks,
// the subgroup compare, the test of the product against one) went through
// it: about 6,100 launches a call.
//
// Two modes, one launch each:
//   digits:  rows x [lanes] -> out [lanes, 21], the value mod p in 13-bit
//            digits (still in the Montgomery domain: exactly what the
//            plain canonical returns);
//   compare: up to 24 pairs (a_i, b_i), b_i absent meaning zero -> eq
//            [lanes] (bytes 0 / 1): every a_i == b_i mod p.
//
// Per operand and lane: the exact signed carry of its 21 limbs in 64 bits
// (limbs may exceed 2^13 + 1 and be lazy sums), the digits packed into five
// 64-bit words, then binary long division by p: for j = steps - 1 down to
// 0, subtract p 2^j when it fits. With value < bound <= p 2^steps every
// step keeps value < p 2^j, so the result is below p: the unique canonical
// representative, equal to the plain version's limb for limb for any bound
// (the plain version's weak reductions multiply by 1 mod p). The host
// derives steps from the operand's static bound (at most 20: p 2^20 > R).
//
// Operands are read in place: each is a base pointer, a row stride and a
// limb stride (a row stride of 0 reads an expanded constant; the batch-last
// kernel layout is row stride 1, limb stride lanes). The table of operands
// is the kernel's parameter, by value (__grid_constant__), so a launch
// copies nothing from the host; p 2^j lives in constant memory.
//
// Bound on the H100: bytes. A compare of 12 pairs at 16384 lanes reads at
// most 2 x 12 x 84 B a lane, 33 MB, 9.9 us at 3.35 TB/s; the arithmetic is
// about 300 integer operations an operand. One thread per (pair, lane):
// blocks of 32 x max(1, 8 / pairs) lanes by `pairs` rows, so a warp reads
// one operand; each lane's verdict is an OR of "differs" flags in shared
// memory, written by the pair-0 row after a barrier.
#include <cuda_runtime.h>

#include "field.cuh"

namespace pt {

constexpr int CANON_WORDS = 5;       // 320 bits hold 21 digits and the carry-out
constexpr int CANON_MAX_STEPS = 20;  // p 2^19 < R = 2^273 <= p 2^20
constexpr int CANON_MAX_PAIRS = 24;
constexpr int CANON_THREADS = 768;   // 32 lanes x 24 pairs
constexpr int CANON_DIGITS_LANES = 256;

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

// Pair i is (op[2i], op[2i + 1]).
struct CanonTable {
  CanonOperand op[2 * CANON_MAX_PAIRS];
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

// digits non-null: digits mode (op[0] alone, blockDim.y = 1). Otherwise
// compare mode over blockDim.y pairs, one verdict byte a lane in eq.
__global__ void __launch_bounds__(CANON_THREADS)
k_canonical(const __grid_constant__ CanonTable t, int32_t* __restrict__ digits,
            uint8_t* __restrict__ eq, int lanes) {
  __shared__ int differs[CANON_DIGITS_LANES];
  const int tx = threadIdx.x, pair = threadIdx.y;
  const long long lane = (long long)blockIdx.x * blockDim.x + tx;
  const bool live = lane < lanes;
  if (digits != nullptr) {
    if (!live) return;
    uint64_t w[CANON_WORDS];
    canon_load(t.op[0], lane, w);
    canon_reduce(w, t.op[0].steps);
    int32_t* out = digits + lane * NL;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const int bit = RB * l, k = bit / 64, s = bit % 64;
      uint64_t v = w[k] >> s;
      if (s + RB > 64) v |= w[k + 1] << (64 - s);
      out[l] = (int32_t)(v & MASK);
    }
    return;
  }
  if (pair == 0) differs[tx] = 0;
  __syncthreads();
  if (live) {
    const CanonOperand& oa = t.op[2 * pair];
    const CanonOperand& ob = t.op[2 * pair + 1];
    uint64_t a[CANON_WORDS], b[CANON_WORDS] = {0, 0, 0, 0, 0};
    canon_load(oa, lane, a);
    canon_reduce(a, oa.steps);
    if (ob.ptr != nullptr) {
      canon_load(ob, lane, b);
      canon_reduce(b, ob.steps);
    }
    uint64_t x = 0;
#pragma unroll
    for (int k = 0; k < CANON_WORDS; ++k) x |= a[k] ^ b[k];
    if (x != 0) differs[tx] = 1;
  }
  __syncthreads();
  if (pair == 0 && live) eq[lane] = differs[tx] ? 0 : 1;
}

}  // namespace pt

// table: host int64 [pairs, 2, 4], each operand (pointer, row stride, limb
// stride, steps), a null pointer for an absent b. Digits mode: digits
// non-null, eq null, pairs 1. Compare mode: the reverse, pairs 1-24.
extern "C" int pt_canonical(const long long* table, int pairs, int32_t* digits, uint8_t* eq,
                            int lanes, void* stream) {
  const bool digits_mode = digits != nullptr;
  if (pairs < 1 || pairs > pt::CANON_MAX_PAIRS || digits_mode == (eq != nullptr) ||
      (digits_mode && pairs != 1))
    return (int)cudaErrorInvalidValue;
  pt::CanonTable t = {};
  for (int i = 0; i < 2 * pairs; ++i) {
    const long long* e = table + 4 * i;
    const bool present = e[0] != 0;
    if ((i % 2 == 0 && !present) || (present && (e[3] < 1 || e[3] > pt::CANON_MAX_STEPS)))
      return (int)cudaErrorInvalidValue;
    t.op[i] = {reinterpret_cast<const int32_t*>(e[0]), e[1], e[2], (int)e[3]};
  }
  if (lanes > 0) {
    const int per = digits_mode ? pt::CANON_DIGITS_LANES : 32 * (pairs < 8 ? 8 / pairs : 1);
    const dim3 block(per, digits_mode ? 1 : pairs);
    pt::k_canonical<<<(lanes + per - 1) / per, block, 0, (cudaStream_t)stream>>>(t, digits, eq,
                                                                                lanes);
  }
  return (int)cudaGetLastError();
}
