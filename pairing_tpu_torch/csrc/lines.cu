// Kernel K: the Miller loop's tangent and chord lines (Phase C), with the
// Jacobian to affine conversion folded in.
//
// Replaces pairing_tpu/ops/line_kernels.py:lines_pallas (pallas_call at
// :209, body _lines_kernel). Per step t, with zinv the Phase N inverses
// (loop tops at [t], post-doubles at [n_steps + t]):
//
//   (x, y)   = (X_t zi^2, Y_t zi^3)            affine loop top
//   tangent  out0 = (3x^3 - 2y^2) xi, out3 = 2y Py, out4 = -3x^2 Px
//   (cx, cy) likewise from the post-double; partner (qx, qy) = sign(d) Q
//   chord    out2 = (qx - cx) Py, out3 = (cy - qy) Px, out5 = cx qy - qx cy
//
// Tangent rows go to tg[t] (slots 0, 3, 4). Chord c, the c-th step with a
// nonzero digit, goes to ch[row] (slots 2, 3, 5); the wrapper's chord table
// gives its (step, digit, row), so the chord stream holds only the
// addition steps kernel C reads, in whatever row order it reads them.
//
// Bound on the H100: integer multiply-adds. A tangent takes 3 Fq2 squares,
// 4 Fq2 products and 4 Fq products, a chord 1, 5 and 4 (about 1.54 ms for
// 16384 lanes over the Miller loop's 64 tangents and 25 chords, at the
// least count), against 672 bytes read and 504 written per tangent and
// lane, 1,008 and 504 per chord (about 0.44 ms, P and Q counted once a
// lane). The TPU kernel had the steps as a grid axis. The first port ran
// one thread per lane over all 64 steps: 512 warps for 16384 lanes, four
// an SM, one a scheduler, 255 registers with spills, and nothing to hide
// the latency of its 64-bit multiply-add chains (12.3% of its bound).
//
// Design: one thread per (line, lane). Steps are independent: line t reads
// only its own top or post-double, its inverse, P and Q. blockIdx.y is the
// line: y < n_steps is the tangent of step y, y = n_steps + c the chord c.
// blockIdx.x is a block of 128 neighbouring lanes, so every load and store
// of the batch-last rows coalesces, and a block's branches (tangent or
// chord, the digit's sign) are uniform. No thread reads another's data: no
// barrier, and a lane past the batch edge returns. 16384 lanes make 45,568
// warps over the Miller loop's 89 lines.
//
// Each Fq2 product component sums its two Fq products in 32-bit columns
// and reduces once (field32.cuh: each limb product is a 32-bit
// multiply-add, the accumulator 42 registers). The bound there needs every
// operand digit below 2^13. Every operand here is one of: a value from
// load_fp, which carries on load (zi, X, Y, P, Q); an output of
// w32_reduce, whose digits are masked to 13 bits (every product); an
// output of fp_carry (fp2_sq's a0 + a1, a0 + 2p - a1 and 2 a0); or an
// output of fp_neg or fp_sub, which carry and conditionally subtract (the
// negated partners 2p - b1, qx - cx, cy - sqy). Each value is below 2p, so
// each column sum is as bounded there.
//
// Code size: with every routine inlined, the kernel is 51,408 SASS
// instructions (823 KB), far more than an SM's instruction cache holds;
// that first design took 5.7 ms at 16384 lanes, twice this one's time. So
// the Fq2 product, the Fq2 square and the one-product sum are out of line,
// one body each called from every site: 12,344 instructions in all. A
// call passes its operands through the thread's stack (ptxas's stack
// frame, about 2 KB a thread, cached in L1).
//
// Registers: values that live across a call would be saved on that stack.
// The two Fq2 values that wait across other products (zi^3 until y and
// 3x^3 until the last output of a tangent; cx, and qx cy, in a chord) are
// parked instead in the thread's own column of a shared-memory stash, 336
// bytes a thread, 43,008 a block. __launch_bounds__(128, 2): 8 warps an
// SM, no spills; asking for 12 or 16 warps caps the registers at 168 or
// 128, spills, and ran slower.
//
// The per-thread arithmetic, the stash and the chord live in lines.cuh,
// which the Miller loop's epilogue lines (miller_epilogue.cu) share; the
// tangent is K's alone.
//
// The operations, their operands' order and every reduction are those of
// field.cuh's fp2_mul / fp2_sq / fp_mul / fp_small in the one-thread kernel
// this replaces, and each computes the same integers, so the digits of
// every output are those it wrote.
#include <cuda_runtime.h>

#include "lines.cuh"

namespace pt {

// Tangent of step t: (3x^3 - 2y^2) xi, 2y Py, -3x^2 Px at dst, dst + 2 rows,
// dst + 4 rows (each row NL n words).
static __device__ __forceinline__ void tangent(const int32_t* __restrict__ top,
                                               const int32_t* __restrict__ zi_src,
                                               const int32_t* __restrict__ pq,
                                               int32_t* __restrict__ dst, size_t n,
                                               const Stash& st) {
  const size_t row = NL * n;
  Fp2 x;
  {
    const Fp2 zi2 = inverse_powers(zi_src, n, st);
    x = mul(load_fp2(top, n), zi2);
  }
  {
    const Fp2 x_sq = sq(x);
    Fp px;
    load_fp(px, pq, n);
    store_fp2(fp2_neg(Fp2{small<3>(mont(x_sq.c0, px)), small<3>(mont(x_sq.c1, px))}),
              dst + 4 * row, n);
    st.put(1, small2<3>(mul(x_sq, x)));
  }
  const Fp2 y = mul(load_fp2(top + 2 * row, n), st.get(0));
  {
    Fp py;
    load_fp(py, pq + row, n);
    store_fp2(Fp2{small<2>(mont(y.c0, py)), small<2>(mont(y.c1, py))}, dst + 2 * row, n);
  }
  store_fp2(fp2_mul_xi(fp2_sub(st.get(1), small2<2>(sq(y)))), dst, n);
}

// chords[3 c .. 3 c + 2] = (step, digit, row) of chord c.
__global__ void __launch_bounds__(K_THREADS, 2)
k_lines(const int32_t* __restrict__ tops, const int32_t* __restrict__ dbls,
        const int32_t* __restrict__ zinv, const int32_t* __restrict__ pq,
        const int32_t* __restrict__ chords, int n_steps, int32_t* __restrict__ tg,
        int32_t* __restrict__ ch, int lanes) {
  __shared__ uint32_t stash[K_STASH_WORDS];
  const int lane = blockIdx.x * K_THREADS + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  const size_t state = 6 * NL * n, inv = 2 * NL * n;  // words of a state row block, an inverse
  const Stash st{stash + threadIdx.x};
  const int line = blockIdx.y;
  if (line < n_steps) {
    tangent(tops + line * state + lane, zinv + line * inv + lane, pq + lane,
            tg + line * state + lane, n, st);
  } else {
    const int32_t* tab = chords + 3 * (line - n_steps);
    const int t = __ldg(tab), d = __ldg(tab + 1), r = __ldg(tab + 2);
    chord(dbls + t * state + lane, zinv + (n_steps + t) * inv + lane, pq + lane,
          pq + 2 * NL * n + lane, d < 0, ch + r * state + lane, n, st);
  }
}

}  // namespace pt

extern "C" int pt_lines(const int32_t* tops, const int32_t* dbls, const int32_t* zinv,
                        const int32_t* pq, const int32_t* chords, int n_steps, int n_chords,
                        int32_t* tg, int32_t* ch, int lanes, void* stream) {
  if (lanes > 0 && n_steps + n_chords > 0) {
    const dim3 grid((lanes + pt::K_THREADS - 1) / pt::K_THREADS, n_steps + n_chords);
    pt::k_lines<<<grid, pt::K_THREADS, 0, (cudaStream_t)stream>>>(tops, dbls, zinv, pq, chords,
                                                                  n_steps, tg, ch, lanes);
  }
  return (int)cudaGetLastError();
}
