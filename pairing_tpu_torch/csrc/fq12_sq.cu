// Kernel K18: dense Fq12 square, out = a^2, on KF12 tensors [12, 21, lanes].
//
// Replaces pairing_tpu/ops/fq12_kernels.py:_pallas_sq (pallas_call at :290,
// core _sq_core_v3), reached through klayout.ksq; here also the square of
// final_exp.fq12_pow, whose operands need not lie in the cyclotomic subgroup.
//
// Bound on the H100: integer multiply-adds. The square needs at least 36 Fq
// products (two-level Karatsuba, as _sq_core_v3 has it) and 12 reductions,
// about 21 k 32-bit IMADs per lane (the least count in chip_smoke.py),
// against 1008 bytes read and 1008 written per lane. The first port ran
// field.cuh's fq12_sq one thread per lane: 84 schoolbook Fq products on
// 64-bit columns, the operands in local memory (130 registers, 3,528 B of
// stack) and, at 16384 lanes, one warp per scheduler with nothing to hide
// the latency of its dependent multiply-adds.
//
// Design: kernel B's (cyc_sq.cu), with the dense square's term table and no
// linear tail. One thread per (output component k = 2s + comp, lane), a
// block 32 lanes x 12 components (threadIdx.x the lane, threadIdx.y the
// component: every branch is uniform in a warp), the block's 12 input rows
// staged once in shared memory (32,256 B a block). Output slot s is the
// sum of a_i a_j over the unordered slot pairs i <= j with i + j = s mod 6,
// times xi where i + j >= 6 (w^6 = xi) and times 2 where i != j: the 21
// terms of SQ_TERMS / SQ_SLOTS, summed by fq12_terms.cuh's mac_cyc_term
// (B_SQ: a_i^2 with w32_sq_mac; B_FOLD: x <- xi x; B_DBL: x <- 2 x) into one
// 32-bit column sum, a carry-save fold between terms, one Montgomery
// reduction. A thread issues 3 or 4 terms; a lane 40.6 k IMADs where the
// first port issued 84 x 441 IMAD.WIDE. A lane past the batch edge computes
// on the last lane's data, reaches the barrier and stores nothing.
//
// Columns: as in kernel B, every operand digit is below 2^13 (load_fp
// carries on load, the flagged operands are carried), a term adds at most
// 42 limb products below 2^26 to a column and a fold leaves each column
// below 2^13 + 2^19, so every column stays below 2^32 whatever the number
// of terms (the numpy model in tests/test_torch_sq_chain_kernels.py checks
// every column at all-maximal digits). Values: a term with xi and 2 is
// below 2 x (40p x 2p) = 160 p^2, so slot 0's sum, the largest, is below
// (8 + 160 + 160 + 80) p^2 = 408 p^2 < R p and the output is below 2p. The
// sums differ from the first port's, which reduced each Fq product, by
// multiples of p: the values are the same, digits may differ by p.
#include <cuda_runtime.h>

#include "fq12_terms.cuh"

namespace pt {

// Output slot s: terms [first, first + count) of SQ_TERMS, the pairs (i, j)
// with i <= j and i + j = s mod 6.
static __constant__ BTerm SQ_TERMS[] = {
    {0, 0, B_SQ}, {1, 5, B_FOLD | B_DBL}, {2, 4, B_FOLD | B_DBL}, {3, 3, B_FOLD},  // 0
    {0, 1, B_DBL}, {2, 5, B_FOLD | B_DBL}, {3, 4, B_FOLD | B_DBL},                 // 4
    {0, 2, B_DBL}, {1, 1, B_SQ}, {3, 5, B_FOLD | B_DBL}, {4, 4, B_FOLD},           // 7
    {0, 3, B_DBL}, {1, 2, B_DBL}, {4, 5, B_FOLD | B_DBL},                          // 11
    {0, 4, B_DBL}, {1, 3, B_DBL}, {2, 2, B_SQ}, {5, 5, B_FOLD},                    // 14
    {0, 5, B_DBL}, {1, 4, B_DBL}, {2, 3, B_DBL},                                   // 18
};
static __constant__ BSlot SQ_SLOTS[6] = {{0, 4}, {4, 3}, {7, 4}, {11, 3}, {14, 4}, {18, 3}};

// Output component k (warp-uniform) of this lane's square.
static __device__ __forceinline__ Fp sq_component(int k, const uint32_t* sm) {
  const BSlot slot = SQ_SLOTS[k >> 1];
  Wide32 w;
  w32_zero(w);
#pragma unroll 1
  for (int j = 0; j < slot.count; ++j) {
    if (j) w32_fold(w);
    mac_cyc_term(w, sm, SQ_TERMS[slot.first + j], k & 1);
  }
  Fp r;
  w32_reduce_imm(w, r);
  return r;
}

__global__ void __launch_bounds__(B_THREADS, 1)
k_fq12_sq(const int32_t* __restrict__ a, int32_t* __restrict__ out, int lanes) {
  __shared__ uint32_t rows[B_COMPS * B_ROW];
  const int k = threadIdx.y;
  const int lane = blockIdx.x * B_LANES + threadIdx.x;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  stage_row(rows + threadIdx.x, a + (live ? (size_t)lane : n - 1), k, n);
  __syncthreads();
  const Fp r = sq_component(k, rows + threadIdx.x);
  if (live) store_fp(r, out + k * NL * n + lane, n);
}

}  // namespace pt

extern "C" int pt_fq12_sq(const int32_t* a, int32_t* out, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::B_LANES - 1) / pt::B_LANES;
    pt::k_fq12_sq<<<blocks, dim3(pt::B_LANES, pt::B_COMPS), 0, (cudaStream_t)stream>>>(
        a, out, lanes);
  }
  return (int)cudaGetLastError();
}
