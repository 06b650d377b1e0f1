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
// pair-major, so thread b reads pair k's line at column k * lanes + b. The
// TPU kernel walked (batch tile, step, pair) as a sequential grid and needed
// the per-pair lane split to tile whole (8, 128) blocks; GPU blocks run in no
// order, so the step and pair loops run inside the thread, f never leaves it,
// and any lane count works.
//
// Bound on the H100: integer multiply-adds. 64 Fq12 squares and 91 K line
// products per lane need at least about 1.37 M + 2.07 M K 32-bit IMADs (the
// least count in chip_smoke.py); this kernel issues about 8.8 M + 6.8 M K
// (IMAD.WIDE, schoolbook tower, squares as products). Against that, 91 K x
// 504 bytes of line words are read per lane, plus 1008 bytes written per
// step with collection. Each
// thread keeps f and one temporary in local memory and streams its lines
// with coalesced loads.
#include <cuda_runtime.h>

#include "field.cuh"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_miller_f(const int32_t* __restrict__ tg, const int32_t* __restrict__ ch,
           const int32_t* __restrict__ ep, const int32_t* __restrict__ sched,
           int n_steps, int n_pairs, int32_t* __restrict__ out, int32_t* __restrict__ fs,
           int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  const size_t line_lanes = n * (size_t)n_pairs;  // columns of a line block
  const size_t line_words = 6 * NL * line_lanes;
  const size_t f_words = 12 * NL * n;
  Fq12 f0, f1, line;
  Fq12* f = &f0;
  Fq12* g = &f1;
  fq12_set_one(*f);
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    const int flag = __ldg(sched + 2 * t);
    const int row = __ldg(sched + 2 * t + 1);
    if (flag != 2) {
      fq12_mul(*f, *f, DENSE, *g);
      Fq12* tmp = f;
      f = g;
      g = tmp;
    }
#pragma unroll 1
    for (int k = 0; k < n_pairs; ++k) {
      const size_t col = (size_t)k * n + lane;
      if (flag != 2) {
        load_line(line, tg + t * line_words + col, line_lanes, 0, 3, 4);
        fq12_mul(*f, line, S034, *g);
        Fq12* tmp = f;
        f = g;
        g = tmp;
      }
      if (flag != 0) {
        const int32_t* src = (flag == 1 ? ch : ep) + row * line_words + col;
        load_line(line, src, line_lanes, 2, 3, 5);
        fq12_mul(*f, line, S235, *g);
        Fq12* tmp = f;
        f = g;
        g = tmp;
      }
    }
    if (fs != nullptr) store_fq12(*f, fs + t * f_words + lane, n);
  }
  store_fq12(*f, out + lane, n);
}

}  // namespace pt

extern "C" int pt_miller_f(const int32_t* tg, const int32_t* ch, const int32_t* ep,
                           const int32_t* sched, int n_steps, int n_pairs, int32_t* out,
                           int32_t* fs, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
    pt::k_miller_f<<<blocks, pt::BLOCK, 0, (cudaStream_t)stream>>>(
        tg, ch, ep, sched, n_steps, n_pairs, out, fs, lanes);
  }
  return (int)cudaGetLastError();
}
