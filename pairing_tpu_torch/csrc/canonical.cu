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
// Each operand goes through canon.cuh's exact carry and long division by
// p 2^j, so the result equals the plain version's limb for limb for any
// bound (the plain version's weak reductions multiply by 1 mod p).
// Operands are read in place through their strides. The table of operands
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

#include "canon.cuh"

namespace pt {

constexpr int CANON_MAX_PAIRS = 24;
constexpr int CANON_THREADS = 768;   // 32 lanes x 24 pairs
constexpr int CANON_DIGITS_LANES = 256;

// Pair i is (op[2i], op[2i + 1]).
struct CanonTable {
  CanonOperand op[2 * CANON_MAX_PAIRS];
};

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
