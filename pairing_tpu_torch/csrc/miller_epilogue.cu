// The Miller loop's epilogue: the twisted Frobenius points with end + Q1
// (k_epilogue_points), then the two epilogue lines (k_epilogue_lines).
//
// Replaces no TPU kernel: the JAX package computes both as fused XLA
// between its kernels (pairing_tpu/pairing/miller_loop.py:269-277, the
// points, and :340-341, the lines), and the port ran them as eager
// PyTorch: some 260 limb products and 220 host constants a call, each
// constant a blocking host-to-device copy. Per lane:
//
//   q1   = (c2 conj(Q.x), c3 conj(Q.y))            twisted_frobenius(Q)
//   nq2  = (c2 conj(q1.x), c3 neg_conj(q1.y))      neg_twisted_frobenius(q1)
//   st91 = end + q1                                jac_mixed_add (madd-2007-bl)
//   ep[0] = chord through affine(end) and q1       zinv[128] the end's 1/Z
//   ep[1] = chord through affine(st91) and nq2     zinv[129] st91's 1/Z
//
// (c2, c3: utils/bn254.py's TWIST_C2, TWIST_C3.) Every output is below 2p
// with digits below 2^13, and equals the eager code's mod p: the same
// formulas with no data-dependent branch, so a degenerate lane (Q outside
// G2 or off the twist) gives the same values too.
//
// Bound on the H100: integer multiply-adds. The points take 16 Fq products
// for the two Frobenius maps and 22 for the mixed addition a lane, the
// lines 2 x 18 (the chord with its affine conversion): about 74 Fq
// products and their reductions a lane, 0.7 ms at 65,536 lanes at kernel
// H's rate; the bytes (1,344 read and 1,512 written a lane by the points,
// 2 x 1,680 and 2 x 504 by the lines) take about 0.1 ms there.
//
// Design: k_epilogue_points is kernel H's mixed addition on H's two threads
// a lane (trajectory.cuh), one warp of 16 lanes a block, the lane's twelve
// Fq2 slots in static shared memory (end, Q1, the sum, four temporaries):
// 32,256 bytes a block, seven blocks an SM. The Frobenius maps fold the
// conjugation into their constants: component h of c conj(v) is v0 a + v1 b
// with (a, b) = (c0, c1) for h = 0 and (c1, -c0) for h = 1, and c
// neg_conj(v) = -(c conj(v)); so each component is two Fq products into one
// 32-bit accumulator and one reduction, with no negation at run time.
// Q1 goes to its output rows and to two slots, from which nq2 and the mixed
// addition read it after a __syncwarp (the same kernel's stores are never
// read through the read-only path). k_epilogue_lines is kernel K's chord
// (lines.cuh) one thread per (line, lane): blockIdx.y is the line, blocks
// of 128 lanes, the chord's partner this lane's Q1 or -Q2 rows.
#include <cuda_runtime.h>

#include "lines.cuh"
#include "trajectory.cuh"

namespace pt {

// Rows: c2.c0, c2.c1, p - c2.c0, c3.c0, c3.c1, p - c3.c0, p - c3.c1 for
// (c2, c3) = (TWIST_C2, TWIST_C3), in the Montgomery domain (c R mod p),
// 13-bit digits, least significant first.
enum { TW_C2_0 = 0, TW_C2_1, TW_C2_0N, TW_C3_0, TW_C3_1, TW_C3_0N, TW_C3_1N };
static __constant__ uint32_t EP_TWIST[7][NL] = {
    {2719, 4087, 1474, 6164, 8136, 3749, 6545, 7592, 134, 6235, 8062,
     4098, 5680, 3706, 5416, 7273, 6839, 6031, 820, 61, 0},
    {7791, 5547, 4942, 4433, 1775, 4205, 5625, 6516, 1687, 3606, 5650,
     3724, 7941, 59, 5827, 6742, 2189, 7492, 3126, 37, 0},
    {4776, 5104, 8179, 2307, 5113, 5792, 2101, 5252, 227, 5217, 5784,
     4863, 1335, 6568, 4536, 6043, 1657, 7175, 5598, 35, 0},
    {6846, 5214, 921, 5137, 3662, 1557, 309, 1913, 5658, 6625, 3659,
     119, 7889, 3249, 5255, 3936, 4895, 445, 6247, 1, 0},
    {4270, 5973, 102, 5274, 195, 5825, 2782, 833, 1772, 2287, 170,
     1075, 5465, 4673, 6338, 2661, 3099, 4010, 7071, 15, 0},
    {649, 3977, 540, 3335, 1395, 7985, 145, 2740, 2896, 4826, 1995,
     651, 7319, 7024, 4697, 1188, 3602, 4569, 172, 95, 0},
    {3225, 3218, 1359, 3198, 4862, 3717, 5864, 3819, 6782, 972, 5485,
     7887, 1550, 5601, 3614, 2463, 5398, 1004, 7540, 80, 0},
};

// Component h of v0 a + v1 b, with (a, b) the rows (A0, B0) for h = 0 and
// (A1, B1) for h = 1: one accumulator, one reduction.
template <int A0, int B0, int A1, int B1>
static __device__ __forceinline__ Fp twist_part(const Fp& v0, const Fp& v1, int h) {
  Fp a, b;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    a.v[l] = EP_TWIST[h ? A1 : A0][l];
    b.v[l] = EP_TWIST[h ? B1 : B0][l];
  }
  Wide32 w;
  w32_zero(w);
  w32_mac(w, v0, a);
  w32_mac(w, v1, b);
  Fp r;
  w32_reduce(w, r);
  return r;
}

// Component h of c2 conj(v), c3 conj(v) and c3 neg_conj(v) = -c3 conj(v).
static __device__ __forceinline__ Fp c2_conj(const Fp& v0, const Fp& v1, int h) {
  return twist_part<TW_C2_0, TW_C2_1, TW_C2_1, TW_C2_0N>(v0, v1, h);
}

static __device__ __forceinline__ Fp c3_conj(const Fp& v0, const Fp& v1, int h) {
  return twist_part<TW_C3_0, TW_C3_1, TW_C3_1, TW_C3_0N>(v0, v1, h);
}

static __device__ __forceinline__ Fp c3_neg_conj(const Fp& v0, const Fp& v1, int h) {
  return twist_part<TW_C3_0N, TW_C3_1N, TW_C3_1N, TW_C3_0>(v0, v1, h);
}

constexpr int EP_SLOTS = 12;  // end (3), Q1 (2), end + Q1 (3), four temporaries
constexpr int EP_THREADS = 32;  // one warp: 16 lanes a block

// q: the capped Q rows [4, 21, lanes] (x.c0, x.c1, y.c0, y.c1); end: kernel
// H's end state [6, 21, lanes]. Writes q1, nq2 [4, 21, lanes] and st91 [6,
// 21, lanes].
__global__ void __launch_bounds__(EP_THREADS)
k_epilogue_points(const int32_t* __restrict__ q, const int32_t* __restrict__ end,
                  int32_t* __restrict__ q1, int32_t* __restrict__ nq2,
                  int32_t* __restrict__ st91, int lanes) {
  __shared__ uint32_t smem[EP_SLOTS * H_SLOT];
  const int g = threadIdx.x & (H_LANES - 1), h = threadIdx.x >> 4;
  const int lane = blockIdx.x * H_LANES + g;
  // A lane past the batch edge works on the last lane's data, reaches every
  // barrier with its partner and stores nothing.
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t row = NL * n;
  const size_t col = live ? (size_t)lane : n - 1;
  uint32_t* E = smem + g;
  uint32_t* Q1 = E + 3 * H_SLOT;
  uint32_t* S = E + 5 * H_SLOT;
  uint32_t* T = E + 8 * H_SLOT;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    Fp x;
    load_fp(x, end + (2 * k + h) * row + col, n);
    st(x, E + k * H_SLOT, h);
  }
  // q1, component h of x (k = 0) and y (k = 1)
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    Fp v0, v1;
    load_fp(v0, q + 2 * k * row + col, n);
    load_fp(v1, q + (2 * k + 1) * row + col, n);
    const Fp r = k ? c3_conj(v0, v1, h) : c2_conj(v0, v1, h);
    st(r, Q1 + k * H_SLOT, h);
    if (live) store_fp(r, q1 + (2 * k + h) * row + lane, n);
  }
  __syncwarp();
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    Fp v0, v1;
    ld(v0, Q1 + k * H_SLOT, 0);
    ld(v1, Q1 + k * H_SLOT, 1);
    const Fp r = k ? c3_neg_conj(v0, v1, h) : c2_conj(v0, v1, h);
    if (live) store_fp(r, nq2 + (2 * k + h) * row + lane, n);
  }
  lane_mixed_add(E, QSlots{Q1}, false, S, T, h);
  if (live) store_state(S, st91 + lane, n, h);
}

// end, st91: the two Jacobian states [6, 21, lanes]; zinv: their inverse Z
// [2, 2, 21, lanes]; p: the rows px, py [2, 21, lanes]; q1, nq2 [4, 21,
// lanes]. Writes ep [2, 6, 21, lanes], the chords' slots 2, 3, 5.
__global__ void __launch_bounds__(K_THREADS, 2)
k_epilogue_lines(const int32_t* __restrict__ end, const int32_t* __restrict__ st91,
                 const int32_t* __restrict__ zinv, const int32_t* __restrict__ p,
                 const int32_t* __restrict__ q1, const int32_t* __restrict__ nq2,
                 int32_t* __restrict__ ep, int lanes) {
  __shared__ uint32_t stash[K_STASH_WORDS];
  const int lane = blockIdx.x * K_THREADS + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  const size_t state = 6 * NL * n, inv = 2 * NL * n;
  const int line = blockIdx.y;
  chord((line ? st91 : end) + lane, zinv + line * inv + lane, p + lane,
        (line ? nq2 : q1) + lane, false, ep + line * state + lane, n,
        Stash{stash + threadIdx.x});
}

}  // namespace pt

extern "C" int pt_epilogue_points(const int32_t* q, const int32_t* end, int32_t* q1, int32_t* nq2,
                                  int32_t* st91, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::H_LANES - 1) / pt::H_LANES;
    pt::k_epilogue_points<<<blocks, pt::EP_THREADS, 0, (cudaStream_t)stream>>>(q, end, q1, nq2,
                                                                              st91, lanes);
  }
  return (int)cudaGetLastError();
}

extern "C" int pt_epilogue_lines(const int32_t* end, const int32_t* st91, const int32_t* zinv,
                                 const int32_t* p, const int32_t* q1, const int32_t* nq2,
                                 int32_t* ep, int lanes, void* stream) {
  if (lanes > 0) {
    const dim3 grid((lanes + pt::K_THREADS - 1) / pt::K_THREADS, 2);
    pt::k_epilogue_lines<<<grid, pt::K_THREADS, 0, (cudaStream_t)stream>>>(end, st91, zinv, p,
                                                                          q1, nq2, ep, lanes);
  }
  return (int)cudaGetLastError();
}
