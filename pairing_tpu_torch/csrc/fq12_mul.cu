// Kernel A: Fq12 product, out = a * b, on KF12 tensors [12, 21, lanes], dense
// or sparse: only the slots of b named in the 6-bit mask ``present`` are read
// (0x3f dense; 0x19 and 0x2c the tangent and chord line shapes 034 and 235).
//
// Replaces pairing_tpu/ops/fq12_kernels.py:_pallas_mul (pallas_call at :275),
// both patterns: dense (core _mul_core_v3), reached through klayout.kmul, and
// sparse (core _sparse_core_v2), reached through klayout.kmul_sparse. The
// sparse mode issues 72 of the 144 Fq products for a three-slot line.
// On the TPU it runs on (8, 128) tiles padded to 1024 lanes; here the grid
// masks the ragged edge itself.
//
// Bound on the H100: integer multiply-adds. The product needs at least 54
// Fq products (Karatsuba) of 441 32-bit IMADs and 12 reductions of 462,
// about 29 k per lane (the least count in chip_smoke.py), against 2 x 1008
// bytes read and 1008 bytes written per lane: above the card's op-per-byte
// line. The first port ran one thread per lane through field.cuh's fq12_mul
// (64-bit columns, the three Fq12 operands in local memory): 128 blocks of
// one lane a thread at 16384 lanes, one warp per scheduler, nothing to hide
// the latency of its dependent multiply-adds.
//
// Design: one thread per (output component, lane). Thread k = 2s + comp of a
// lane computes output component k: fq12_mul's k loop (field.cuh) over the
// slots j of b that are present, one Fq2 term a_i b_j (i = s - j mod 6, xi *
// a_i when i > s) at a time, as two Fq products into one accumulator:
//
//   c0 += x0 b0 + x1 (2p - b1),  c1 += x0 b1 + x1 b0,
//
// x = a_i, or xi * a_i = (9 a0 + 2p - a1, a0 + 9 a1) carried (< 20p), then
// one Montgomery reduction. A block is 32 lanes x 12 components:
// threadIdx.x is the lane, threadIdx.y the component, so each warp holds one
// component of 32 neighbouring lanes and every row it reads or writes is one
// 128-byte line; the block's 12 warps read the same rows of a and b, through
// L1. The component, its terms and the mask are the same across a warp:
// every branch is uniform. No shared memory, no barrier; a lane past the
// batch edge returns. The term is one loop body, not unrolled, for every
// component and mode (kernel K ran at half speed with its routines inlined
// whole: instruction fetch).
//
// Columns are 32-bit (field32.cuh). Every operand digit is below 2^13
// (load_fp carries on load; xi * a_i and 2p - b1 are carried). One Fq2 term
// adds at most 42 limb products below 2^26 to a column, 2,817,884,202; a
// fold (w32_fold) between terms leaves each column below 8,191 + 524,287.
// The last term, then the reduction's terms m_i p_j (m_i < 2^13, each of p's
// digits once, 8,191 x 59,618) and one carry below 2^19 keep every column
// below 3,307,272,005 < 2^32 (the numpy model in
// tests/test_torch_line_kernels.py holds each column below 2^32 at every
// step). A fold moves value between columns and leaves the integer sum as
// it is, and a Montgomery reduction's result depends only on that integer:
// the digits are those of field.cuh's fq12_mul on the same operands.
#include <cuda_runtime.h>

#include "field32.cuh"

namespace pt {

constexpr int A_LANES = 32;                 // lanes per block: threadIdx.x
constexpr int A_COMPS = 12;                 // output components: threadIdx.y
constexpr int A_THREADS = A_LANES * A_COMPS;

// w += the Fq2 term of component ``comp`` with left slot a (rows a, a + row)
// and right slot b (this lane's column of each), xi-folded when ``fold``.
static __device__ __forceinline__ void mac_term(Wide32& w, const int32_t* __restrict__ a,
                                                const int32_t* __restrict__ b, size_t lanes,
                                                bool fold, int comp) {
  const size_t row = NL * lanes;
  Fp x0, x1;
  load_fp(x0, a, lanes);
  load_fp(x1, a + row, lanes);
  if (fold) {  // fp2_mul_xi_wide
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const uint32_t u0 = x0.v[l], u1 = x1.v[l];
      x0.v[l] = 9 * u0 + KP[KP_2][l] - u1;
      x1.v[l] = u0 + 9 * u1;
    }
    fp_carry(x0);
    fp_carry(x1);
  }
  Fp y;
  load_fp(y, b + comp * row, lanes);  // b0 for c0, b1 for c1
  w32_mac(w, x0, y);
  load_fp(y, b + (1 - comp) * row, lanes);
  if (comp == 0) y = fp_neg(y);  // 2p - b1 for c0, b0 for c1
  w32_mac(w, x1, y);
}

__global__ void __launch_bounds__(A_THREADS, 1)
k_fq12_mul(const int32_t* __restrict__ a, const int32_t* __restrict__ b, unsigned present,
           int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * A_LANES + threadIdx.x;
  if (lane >= lanes) return;
  const int k = threadIdx.y, s = k >> 1, comp = k & 1;
  const size_t n = (size_t)lanes;
  const size_t slot = 2 * NL * n;
  Wide32 w;
  w32_zero(w);
  bool first = true;
#pragma unroll 1
  for (int i = 0; i < 6; ++i) {
    const bool fold = i > s;  // w^(i+j) with i + j >= 6 folds as xi
    const int j = fold ? s - i + 6 : s - i;
    if (!((present >> j) & 1u)) continue;  // absent slots of b are never read
    if (!first) w32_fold(w);
    first = false;
    mac_term(w, a + i * slot + lane, b + j * slot + lane, n, fold, comp);
  }
  Fp r;
  w32_reduce(w, r);
  store_fp(r, out + k * NL * n + lane, n);
}

}  // namespace pt

extern "C" int pt_fq12_mul(const int32_t* a, const int32_t* b, int present, int32_t* out,
                           int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::A_LANES - 1) / pt::A_LANES;
    pt::k_fq12_mul<<<blocks, dim3(pt::A_LANES, pt::A_COMPS), 0, (cudaStream_t)stream>>>(
        a, b, (unsigned)present & pt::DENSE, out, lanes);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
