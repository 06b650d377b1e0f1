// Kernel C: Miller f-accumulation (Phase D) with the epilogue lines fused,
// for any number of pairs per product and with optional per-step collection.
//
// Replaces pairing_tpu/ops/fused_kernels.py:_miller_f_impl (pallas_call at
// :260, body _miller_kernel :72), entry miller_f_pallas.
//
// Per step t, with schedule row sched[t] = (flag, row), for a product of
// K = n_pairs pairs:
//   flag 0: f <- f^2 * prod_k tangent_k[t]                     (slots 0,3,4)
//   flag 1: f <- f^2 * prod_k (tangent_k[t] * chord_k[row])    (slots 2,3,5)
//   flag 2: f <- f * prod_k ep_k[row]  (the two epilogue lines, trailing)
// One square per step is shared by all K pairs (multi_miller_loop_BN_native,
// miller_loop_native.rs:239); pair k's tangent, then its chord, follow for
// k = 0..K-1, in the TPU kernel's order. f starts at one. With ``fs`` non-null
// the accumulator after every step is written to fs[t] (the witness f_steps;
// fs[n_steps - 1] equals out).
//
// Layout: output lanes b < lanes; line blocks [rows, 6, 21, K * lanes] are
// pair-major, so lane b reads pair k's line at column k * lanes + b. The
// TPU kernel walked (batch tile, step, pair) as a sequential grid and needed
// the per-pair lane split to tile whole (8, 128) blocks; GPU blocks run in no
// order, so the step and pair loops run inside the lane's group, f never
// leaves shared memory, and any lane count works.
//
// Bound on the H100: integer multiply-adds. 64 Fq12 squares and 91 K line
// products per lane need at least about 1.37 M + 2.07 M K 32-bit IMADs (the
// least count in chip_smoke.py); this kernel issues about 5.45 M + 6.79 M K
// (IMAD.WIDE counted as two: a schoolbook tower of 84 Fq products a square
// and 72 a line product, 12 word-by-word reductions each; the square was a
// product of 144 before). Against that, 91 K x 504 bytes of line
// words are read per lane, plus 1008 bytes written per step with
// collection. Design (field_group.cuh): six threads per lane, five lanes per
// warp, the lane's f and its staged line in shared memory, so that each
// thread holds one Fq product's operands and accumulator in registers; the
// square is fq12_sq's symmetric schoolbook split by output slot, and a line
// product reads only the line's three slots. The schedule is the same for
// every lane, so every branch on it is uniform.
#include <cuda_runtime.h>

#include "field_group.cuh"

namespace pt {

// Four warps a block: 20 lanes of 1516 shared bytes (f, the staged line,
// one word of padding), 30,320 bytes, static (under 48 KB). Two blocks (8
// warps) per SM leave the registers uncapped below 255, as for kernel D.
constexpr int C_WARPS = 4;
constexpr int C_MIN_BLOCKS = 2;
constexpr int C_THREADS = C_WARPS * 32;
constexpr int C_LANES = C_WARPS * GROUP_LANES;  // lanes per block
constexpr int LINE_WORDS = 6 * NL;
constexpr int C_STRIDE = F12_WORDS + LINE_WORDS + 1;

__global__ void __launch_bounds__(C_THREADS, C_MIN_BLOCKS)
k_miller_f(const int32_t* __restrict__ tg, const int32_t* __restrict__ ch,
           const int32_t* __restrict__ ep, const int32_t* __restrict__ sched,
           int n_steps, int n_pairs, int32_t* __restrict__ out, int32_t* __restrict__ fs,
           int lanes) {
  __shared__ uint32_t smem[C_LANES * C_STRIDE];
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;
  // Threads 30 and 31 of each warp belong to no lane and to no barrier's mask.
  if (t32 >= GROUP * GROUP_LANES) return;
  const int g = t32 / GROUP, s = t32 % GROUP;
  const int lane = (blockIdx.x * C_WARPS + warp) * GROUP_LANES + g;
  // A lane past the batch edge works on the last lane's columns, reaches
  // every barrier with its group and stores nothing.
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t own = live ? (size_t)lane : n - 1;
  const size_t line_lanes = n * (size_t)n_pairs;  // columns of a line block
  const size_t line_words = LINE_WORDS * line_lanes;
  const size_t f_words = F12_WORDS * n;
  uint32_t* f = smem + (warp * GROUP_LANES + g) * C_STRIDE;
  uint32_t* line = f + F12_WORDS;
#pragma unroll 1
  for (int l = 0; l < 2 * NL; ++l) f[2 * s * NL + l] = s == 0 && l < NL ? KP[KP_ONE][l] : 0u;
  __syncwarp(GROUP_MASK);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const int flag = __ldg(sched + 2 * t);
    const int row = __ldg(sched + 2 * t + 1);
    if (flag != 2) group_fq12_sq(f, s);
    // which 0: the tangent (slots 0,3,4); which 1: the chord or epilogue
    // line (slots 2,3,5)
    const int first = flag == 2 ? 1 : 0, last = flag == 0 ? 1 : 2;
#pragma unroll 1
    for (int k = 0; k < n_pairs; ++k) {
      const size_t col = (size_t)k * n + own;
#pragma unroll 1
      for (int which = first; which < last; ++which) {
        const int32_t* src = which == 0 ? tg + (size_t)t * line_words
                                        : (flag == 1 ? ch : ep) + (size_t)row * line_words;
        group_stage_line(line, src + col, line_lanes, s);
        __syncwarp(GROUP_MASK);
        group_fq12_mul_sparse(f, line, s, which ? 2 : 0, 3, which ? 5 : 4);
      }
    }
    if (fs != nullptr && live) group_store_slot(f, fs + (size_t)t * f_words + lane, n, s);
  }
  if (live) group_store_slot(f, out + lane, n, s);
}

}  // namespace pt

extern "C" int pt_miller_f(const int32_t* tg, const int32_t* ch, const int32_t* ep,
                           const int32_t* sched, int n_steps, int n_pairs, int32_t* out,
                           int32_t* fs, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::C_LANES - 1) / pt::C_LANES;
    pt::k_miller_f<<<blocks, pt::C_THREADS, 0, (cudaStream_t)stream>>>(
        tg, ch, ep, sched, n_steps, n_pairs, out, fs, lanes);
  }
  return (int)cudaGetLastError();
}
