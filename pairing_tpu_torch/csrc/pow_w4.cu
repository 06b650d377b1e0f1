// Kernel K17: the windowed (w = 4 NAF) cyclotomic x-power ladder with its
// table built in the kernel, out = m^e for the MSB-first w-NAF digits of e
// (BN_X_W4_DIGITS: 63 digits, the top one positive, 13 more nonzero).
//
// Replaces pairing_tpu/ops/fused_kernels.py:pow_ladder_w4_pallas
// (pallas_call at :501, body _pow_w4_kernel :433), reached through
// final_exp.pow_x_cyclotomic and the Fq12-level hard_part. Kernel D runs the
// same ladder on a table that kernels A, B and E build outside; here one
// launch does all of it:
//
//   table: m2 = m^2 (Granger-Scott), tab = {m, m^3, m^5, m^7} by three
//          dense products m2 * tab[r - 1];
//   init:  f = the entry of digits[0] (no square);
//   step:  f = f^2, times the signed entry of a nonzero digit d: row
//          |d| >> 1, conjugated for d < 0 (slots 1, 3, 5 negated as 2p - x).
//
// Bound on the H100: integer multiply-adds. One cyclotomic square and 3
// dense products for the table, 62 squares and 13 products in the ladder,
// about 1.32 M 32-bit IMADs per lane at least (the least count in
// chip_smoke.py), against 1008 bytes read and 1008 written per lane (the
// scratch table is not counted). Design: kernel D's (csrc/pow_ladder.cu) on
// the six-thread group core (field_group.cuh): six threads per lane, five
// lanes per warp, the lane's f, a scratch and m2 in shared memory, so that
// each thread holds one Fq product's operands and accumulator in registers
// and the SM keeps 8 warps in flight. Rank s stores slot s of each table row
// m^3, m^5, m^7 to a global scratch as it writes it, and stages slot s of a
// digit's entry in the scratch region before the product, as D stages its
// stream row; row 0 is m, read from the input. A rank reads back only the
// slots it stored itself. On the H100 the rows kept resident in shared
// memory instead ran 3.5% slower (five Fq12 a lane), or 30-35% with all four
// rows (fewer warps an SM; tools/k1617_variants.py). The digit is the same
// for every lane, so every branch on it is uniform.
#include <cuda_runtime.h>

#include "field_group.cuh"

namespace pt {

// Four warps a block, two blocks (8 warps) per SM, as kernel D. A lane's
// shared region is f, the square's scratch and m2 (three Fq12 and one word
// of padding, 3,028 B): 60,560 B a block, dynamic (over 48 KB).
constexpr int K17_WARPS = 4;
constexpr int K17_MIN_BLOCKS = 2;
constexpr int K17_THREADS = K17_WARPS * 32;
constexpr int K17_LANES = K17_WARPS * GROUP_LANES;  // lanes per block
constexpr int K17_STRIDE = 3 * F12_WORDS + 1;
constexpr size_t K17_SMEM = (size_t)K17_LANES * K17_STRIDE * sizeof(uint32_t);

// Slot s of the signed table entry of digit d (odd, |d| <= 7) into the
// shared ``dst``: row 0 is m (``m`` at this lane's column of the input), rows
// 1-3 the scratch's rows 0-2 (``tab`` at this group's column, ``cols``
// columns), read with plain loads: this kernel wrote them. For d < 0 ranks
// 1, 3 and 5 negate their slot: the conjugate.
static __device__ __forceinline__ void stage_entry(uint32_t* dst, const int32_t* __restrict__ m,
                                                   size_t lanes, const int32_t* tab, size_t cols,
                                                   int d, int s) {
  const int row = (d < 0 ? -d : d) >> 1;
  const bool neg = d < 0 && (s & 1);
#pragma unroll 1
  for (int c = 2 * s; c < 2 * s + 2; ++c) {
    Fp x;
    if (row == 0) {
      load_fp(x, m + c * NL * lanes, lanes);
    } else {
      load_fp_rw(x, tab + ((size_t)(row - 1) * 12 + c) * NL * cols, cols);
    }
    if (neg) x = fp_neg(x);
    sh_store(x, dst + c * NL);
  }
}

// ``tab`` [3, 12, 21, tab_cols] holds m^3, m^5, m^7; it spans whole blocks
// (tab_cols >= the blocks' lanes), so that every group, also one past the
// batch edge, writes and reads a column of its own.
__global__ void __launch_bounds__(K17_THREADS, K17_MIN_BLOCKS)
k_pow_ladder_w4(const int32_t* __restrict__ m, const int32_t* __restrict__ digits, int n_digits,
                int32_t* tab, int tab_cols, int32_t* __restrict__ out, int lanes) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;
  // Threads 30 and 31 of each warp belong to no lane and to no barrier's mask.
  if (t32 >= GROUP * GROUP_LANES) return;
  const int g = t32 / GROUP, s = t32 % GROUP;
  const int lane = (blockIdx.x * K17_WARPS + warp) * GROUP_LANES + g;
  // A lane past the batch edge works on the last lane's data, reaches every
  // barrier with its group and stores no output.
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes, cols = (size_t)tab_cols;
  const int32_t* m_col = m + (live ? (size_t)lane : n - 1);
  int32_t* tab_col = tab + lane;
  uint32_t* f = smem + (warp * GROUP_LANES + g) * K17_STRIDE;
  uint32_t* scr = f + F12_WORDS;
  uint32_t* m2 = scr + F12_WORDS;
  group_load_slot(f, m_col, n, s);
  group_load_slot(m2, m_col, n, s);
  __syncwarp(GROUP_MASK);
  // Steps u = 0, 1, 2 build the table: m2 = m^2 at u = 0, then f = m2 * f,
  // stored as scratch row u (m^3, m^5, m^7). Step 3 sets f to the top
  // digit's entry (nonzero: the wrapper checks it). Each later step u
  // squares f and multiplies it by the entry of digit u - 3, if nonzero.
  // One call site for each routine: with the table's square and products
  // inlined apart ptxas spilled 72 B.
#pragma unroll 1
  for (int u = 0; u < n_digits + 3; ++u) {
    const bool table = u < 3;
    if (u == 0 || u > 3) group_cyc_sq(u == 0 ? m2 : f, scr, s);
    const int d = table ? 0 : __ldg(digits + u - 3);
    if (d != 0) {
      stage_entry(u == 3 ? f : scr, m_col, n, tab_col, cols, d, s);
      __syncwarp(GROUP_MASK);
    }
    if (table || (u > 3 && d != 0)) {
      group_fq12_mul_to(f, table ? m2 : f, table ? f : scr, s);
      if (table) group_store_slot(f, tab_col + (size_t)u * 12 * NL * cols, cols, s);
    }
  }
  if (live) group_store_slot(f, out + lane, n, s);
}

}  // namespace pt

extern "C" int pt_pow_ladder_w4(const int32_t* m, const int32_t* digits, int n_digits,
                                int32_t* tab, int tab_cols, int32_t* out, int lanes,
                                void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::K17_LANES - 1) / pt::K17_LANES;
    if (tab_cols < blocks * pt::K17_LANES) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        pt::k_pow_ladder_w4, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pt::K17_SMEM);
    if (err != cudaSuccess) return (int)err;
    pt::k_pow_ladder_w4<<<blocks, pt::K17_THREADS, pt::K17_SMEM, (cudaStream_t)stream>>>(
        m, digits, n_digits, tab, tab_cols, out, lanes);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block of k_pow_ladder_w4 asks for at launch
// (ptxas reports static shared memory only).
extern "C" int pt_pow_ladder_w4_shared_bytes() { return (int)pt::K17_SMEM; }
