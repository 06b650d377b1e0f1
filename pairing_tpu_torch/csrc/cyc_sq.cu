// Kernel B: Granger-Scott cyclotomic square on KF12 tensors [12, 21, lanes].
//
// Replaces pairing_tpu/ops/klayout.py:_kcyc_sq_impl (pallas_call at :120,
// core kernel_core.k_cyc_sq), reached through klayout.kcyc_sq. Equals the
// dense square on the cyclotomic subgroup (after the easy part); the
// formula itself is the same polynomial as fields.fp12.fq12_cyclotomic_sq,
// so kernel and plain version agree on any input.
//
// Bound on the H100: integer multiply-adds, 18 Fq products and 12
// reductions a lane (chip_smoke.py's count), against 1008 bytes in and out
// a lane. The first port ran field.cuh's fq12_cyc_sq in one thread per
// lane: 64-bit columns, the Fq2 temporaries in local memory (255 registers,
// 4,080 B of stack, spills) and, at 16384 lanes, one warp per scheduler
// with nothing to hide the latency of its dependent multiply-adds.
//
// Design: kernel A's (fq12_mul.cu), one thread per (output component,
// lane); the table, the term loop and the component (B_TERMS / B_SLOTS,
// mac_cyc_term, cyc_component) are in fq12_terms.cuh, shared with K18 and
// K15. With slots s_i = (a_2i, a_2i+1) and xi = 9 + u, output slot i is
// 3 T_i - 2 s_i for i = 0, 2, 4 and 3 T_i + 2 s_i for i = 1, 3, 5, where
//
//   T_0 = s0^2 + xi s3^2,  T_2 = s1^2 + xi s4^2,  T_4 = s2^2 + xi s5^2,
//   T_1 = xi 2 s2 s5,      T_3 = 2 s0 s3,         T_5 = 2 s1 s4
//
// (field.cuh's fq4_sq with its cross term (x + y)^2 - x^2 - y^2 taken as
// 2 x y: the same value on any input, one product fewer). Thread k = 2i +
// comp sums component comp of T_i's Fq2 terms x y (B_TERMS: x = slot t.x,
// times xi and/or 2 when flagged, carried; y = slot t.y) into one 32-bit
// column sum, as kernel A does:
//
//   c0 += x0 y0 + x1 (2p - y1),  c1 += x0 y1 + x1 y0,
//
// and a square term (x = y, no flag) as c0 += x0^2 + x1 (2p - x1), with
// w32_sq_mac's 231 limb products for x0^2, and c1 += (2 x0) x1; a
// carry-save fold (w32_fold) between terms, one reduction, then the linear
// tail 3T -+ 2 s (small<K>, fp_sub / fp_add), below 2p with digits below
// 2^13. The terms are one loop body over the table (kernel K ran at half
// speed with its routines inlined whole). A block is 32 lanes x 12
// components: threadIdx.x the lane, threadIdx.y the component, so each warp
// holds one component of 32 neighbouring lanes, every branch is uniform and
// every row a warp reads or writes is one 128-byte line. The block's 12
// input rows are staged once in shared memory: each warp loads and carries
// its own row (one carry a row, where reading every operand through L1, as
// kernel A does, carries a row at each use), a __syncthreads, then every
// operand comes from shared memory (32,256 B a block; a warp reads 32
// consecutive words). Through L1 the kernel ran 3.1-4.3% slower on an H100
// (tools/fb_variants.py). A lane past the batch edge computes on the last
// lane's data, reaches the barrier and stores nothing.
//
// Columns: every operand digit is below 2^13 (load_fp carries on load; the
// flagged and negated operands are carried). A term adds at most 42 limb
// products below 2^26 to a column (a square term's 231 + 441 fewer); a fold
// leaves each column below 8,191 + 524,287; the reduction's terms m_i p_j
// and one carry keep every column below 3,307,272,005 < 2^32, as in kernel
// A (the numpy model in tests/test_torch_cyc_kernels.py checks every
// column at all-maximal digits). The sums stay below 160 p^2 < R p, so T
// is below 2p. B sums a component's terms before one reduction where the
// first port reduced each Fq2 square: the same values, digits that may
// differ by p.
#include <cuda_runtime.h>

#include "fq12_terms.cuh"

namespace pt {

__global__ void __launch_bounds__(B_THREADS, 1)
k_fq12_cyc_sq(const int32_t* __restrict__ a, int32_t* __restrict__ out, int lanes) {
  __shared__ uint32_t rows[B_COMPS * B_ROW];
  const int k = threadIdx.y;
  const int lane = blockIdx.x * B_LANES + threadIdx.x;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  Fp x;
  load_fp(x, a + k * NL * n + col, n);
  uint32_t* dst = rows + k * B_ROW + threadIdx.x;
#pragma unroll
  for (int l = 0; l < NL; ++l) dst[l * B_LANES] = x.v[l];
  __syncthreads();
  const Fp r = cyc_component(k, rows + threadIdx.x);
  if (live) store_fp(r, out + k * NL * n + lane, n);
}

}  // namespace pt

extern "C" int pt_fq12_cyc_sq(const int32_t* a, int32_t* out, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::B_LANES - 1) / pt::B_LANES;
    pt::k_fq12_cyc_sq<<<blocks, dim3(pt::B_LANES, pt::B_COMPS), 0, (cudaStream_t)stream>>>(
        a, out, lanes);
  }
  return (int)cudaGetLastError();
}
