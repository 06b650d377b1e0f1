// Kernel G: Fq12 inversion on KF12 tensors [12, 21, lanes].
//
// Replaces pairing_tpu/ops/fq2_vm.py:vm_apply (pallas_call at :276) as
// klayout.kinv uses it: the two Fq2 instruction programs of inv_kernels
// (_part1, _part2) on the fq2_vm interpreter, with the one Fq2 norm
// Fermat-inverted between them. A GPU thread runs straight-line code, so
// the interpreter is not carried over: the tower formula of
// fields.fp12.fq12_inv runs directly, norm inverse included.
//
//   Fq12 = Fq6[w]/(w^2 - v), A = (s0, s2, s4), B = (s1, s3, s5):
//   (A + B w)^-1 = (A - B w) / d,  d = A^2 - B^2 v,
//   Fq6 = Fq2[v]/(v^3 - xi): d^-1 = (t0, t1, t2) / n with
//   t0 = d0^2 - xi d1 d2, t1 = xi d2^2 - d0 d1, t2 = d1^2 - d0 d2,
//   n = d0 t0 + xi (d1 t2 + d2 t1) in Fq2, n^-1 = (n0 - n1 u) / N,
//   N = n0^2 + n1^2 in Fq, N^-1 = N^(p-2).
//
// Bound on the H100: integer multiply-adds. The Fermat chain of N takes at
// least 223 k 32-bit IMADs a lane (the best sliding window, 5 bits: 253
// squares and 53 products; the fixed 4-bit window below takes 72 products,
// 240 k), the tower at least 75 k (chip_smoke.py counts both). The
// first port ran everything in one thread per lane: the Fq6 temporaries in
// local memory, every Fq product in 64-bit columns and the chain's squares
// as full products (255 registers, 3,240 B of stack).
//
// Design: three launches on the stream, one call of the wrapper.
//  1. k_fq12_inv_norm: the tower up to the norm, one thread per (output Fq
//     component, lane), as kernel A (fq12_mul.cu): blocks of 32 lanes x 6
//     components, one component a warp (every branch uniform). Levels d,
//     t, n, N run between __syncthreads on the block's shared rows; t, n
//     and N go to a device scratch [10, 21, lanes] (840 bytes a lane).
//  2. k_fq12_inv_chain: N^-1 = N^(p-2), one thread per lane, so every
//     warp has 32 live lanes: field32.cuh's fp32_inv, a fixed 4-bit window
//     (the table x^1..x^15 in local memory, 1,344 bytes), a real square
//     (231 limb products), p's digits as immediates and p - 2's from the
//     constant bank. The same chain a bit at a time (109 products where the
//     window takes 72) made the kernel 4-8% slower on an H100
//     (tools/ig_variants.py).
//  3. k_fq12_inv_out: n^-1, then d^-1 = t n^-1, then A d^-1 into slots 0,
//     2, 4 and -B d^-1 into slots 1, 3, 5: blocks of 32 lanes x 12
//     components, the last level kernel A's layout exactly.
//
// Each level's output component is a sum of Fq2 terms x y (G_TERMS), each
// as two Fq products into one 32-bit column sum with a carry-save fold
// between terms and one reduction, as kernel A sums (x a shared row pair,
// times xi and/or 2 when flagged, carried; y a shared row pair, negated
// per component when flagged). The sums stay below 640 p^2 < R p, so every
// output is below 2p, and the columns below 2^32 as in kernel A. A lane
// past the batch edge computes on the last lane's data, reaches every
// barrier and stores nothing.
//
// The tower sums a component's products before one reduction where the
// first port reduced each Fq2 product: the same value, digits that may
// differ by p (tests/test_torch_inv_kernels.py models the split against
// fields.fp12.fq12_inv).
#include <cuda_runtime.h>

#include "field32.cuh"

namespace pt {

constexpr int G_LANES = 32;                // lanes a block: threadIdx.x
constexpr int G_ROW = NL * G_LANES;        // words of one shared row
constexpr int G_ROWS = 30;                 // rows of the shared map below
constexpr size_t G_SMEM = (size_t)G_ROWS * G_ROW * sizeof(uint32_t);  // 80,640 bytes
constexpr int G_NORM_COMPS = 6;            // warps of k_fq12_inv_norm
constexpr int G_OUT_COMPS = 12;            // warps of k_fq12_inv_out

// Shared rows, [row][limb][32 lanes], a slot s being rows 2s and 2s + 1:
// a rows 0-11 (slots 0-5); d, later d^-1, 12-17 (slots 6-8); t 18-23
// (slots 9-11); n 24-25 (slot 12); N, later N^-1, 26 and a zero row 27
// (slot 13); n^-1 28-29 (slot 14).
enum : uint8_t { S_D = 6, S_T = 9, S_N = 12, S_NINV_X = 13, S_NINV = 14 };
enum : uint8_t { R_N = 24, R_NN = 26, R_ZERO = 27 };
// Scratch rows (klayout.INV_SCRATCH_ROWS): t 0-5, n 6-7, N 8, N^-1 9.
enum : uint8_t { SC_T = 0, SC_N = 6, SC_NN = 8, SC_NINV = 9 };
constexpr uint8_t NONE = 0xff;

// Term flags: x <- xi x, x <- 2 x (in that order); y0 <- -y0, y1 <- -y1.
enum : uint8_t { FOLD = 1, DBL = 2, NEG0 = 4, NEG1 = 8, NEG = NEG0 | NEG1 };

struct GTerm { uint8_t x, y, flags; };
// A level's output slot: terms [first, first + count), the shared row and
// the device row of its component 0 (component 1 one row on), or NONE.
struct GSlot { uint8_t first, count, srow, grow; };
struct GLevel { uint8_t width; GSlot slot[6]; };  // components 0 .. width - 1

static __constant__ GTerm G_TERMS[] = {
    // d = A^2 - B^2 v: A_i = slot 2i, B_i = slot 2i + 1
    {0, 0, 0}, {2, 4, FOLD | DBL}, {1, 5, FOLD | DBL | NEG}, {3, 3, FOLD | NEG},  // 0: d0
    {0, 2, DBL}, {4, 4, FOLD}, {1, 1, NEG}, {3, 5, FOLD | DBL | NEG},            // 4: d1
    {0, 4, DBL}, {2, 2, 0}, {1, 3, DBL | NEG}, {5, 5, FOLD | NEG},               // 8: d2
    {S_D, S_D, 0}, {S_D + 1, S_D + 2, FOLD | NEG},                               // 12: t0
    {S_D + 2, S_D + 2, FOLD}, {S_D, S_D + 1, NEG},                               // 14: t1
    {S_D + 1, S_D + 1, 0}, {S_D, S_D + 2, NEG},                                  // 16: t2
    {S_D, S_T, 0}, {S_D + 1, S_T + 2, FOLD}, {S_D + 2, S_T + 1, FOLD},           // 18: n
    {S_N, S_N, NEG1},  // 21: N = component 0 of n conj(n)
    // 22: n^-1 = (N^-1, 0) conj(n)
    {S_NINV_X, S_N, NEG1},
    {S_T, S_NINV, 0}, {S_T + 1, S_NINV, 0}, {S_T + 2, S_NINV, 0},  // 23: d^-1 = t n^-1
    // 26: A d^-1 (slots 0, 2, 4), d^-1 = slots 6-8, xi where i + l >= 3
    {0, S_D, 0}, {2, S_D + 2, FOLD}, {4, S_D + 1, FOLD},
    {0, S_D + 1, 0}, {2, S_D, 0}, {4, S_D + 2, FOLD},
    {0, S_D + 2, 0}, {2, S_D + 1, 0}, {4, S_D, 0},
    // 35: -B d^-1 (slots 1, 3, 5)
    {1, S_D, NEG}, {3, S_D + 2, FOLD | NEG}, {5, S_D + 1, FOLD | NEG},
    {1, S_D + 1, NEG}, {3, S_D, NEG}, {5, S_D + 2, FOLD | NEG},
    {1, S_D + 2, NEG}, {3, S_D + 1, NEG}, {5, S_D, NEG},
};

// Levels 0-3: k_fq12_inv_norm; levels 4-6: k_fq12_inv_out.
constexpr int G_NORM_LEVELS = 4, G_OUT_LEVELS = 3;
static __constant__ GLevel G_LEVELS[G_NORM_LEVELS + G_OUT_LEVELS] = {
    {6, {{0, 4, 2 * S_D, NONE}, {4, 4, 2 * S_D + 2, NONE}, {8, 4, 2 * S_D + 4, NONE}}},
    {6, {{12, 2, 2 * S_T, SC_T}, {14, 2, 2 * S_T + 2, SC_T + 2}, {16, 2, 2 * S_T + 4, SC_T + 4}}},
    {2, {{18, 3, R_N, SC_N}}},
    {1, {{21, 1, R_NN, SC_NN}}},
    {2, {{22, 1, 2 * S_NINV, NONE}}},
    {6, {{23, 1, 2 * S_D, NONE}, {24, 1, 2 * S_D + 2, NONE}, {25, 1, 2 * S_D + 4, NONE}}},
    {12, {{26, 3, NONE, 0}, {35, 3, NONE, 2}, {29, 3, NONE, 4}, {38, 3, NONE, 6},
          {32, 3, NONE, 8}, {41, 3, NONE, 10}}},
};

extern __shared__ uint32_t g_sm[];

// This thread's column of shared row ``row`` into x (digits below 2^13).
static __device__ __forceinline__ void sm_load(Fp& x, int row) {
  const uint32_t* src = g_sm + row * G_ROW + threadIdx.x;
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] = src[l * G_LANES];
}

static __device__ __forceinline__ void sm_store(const Fp& x, int row) {
  uint32_t* dst = g_sm + row * G_ROW + threadIdx.x;
#pragma unroll
  for (int l = 0; l < NL; ++l) dst[l * G_LANES] = x.v[l];
}

// Device row ``src`` (this lane's column) into shared row ``row``, carried.
static __device__ __forceinline__ void stage_row(const int32_t* __restrict__ src, size_t lanes,
                                                 int row) {
  Fp x;
  load_fp(x, src, lanes);
  sm_store(x, row);
}

// w += component ``comp`` of the Fq2 term t: x = slot t.x (xi x, then 2x,
// when flagged: value below 40p, digits carried), y' = slot t.y with each
// component negated as flagged; c0 += x0 y'0 + x1 (2p - y'1) and c1 += x0
// y'1 + x1 y'0, with 2p - (2p - y1) taken as y1.
static __device__ __forceinline__ void mac_term(Wide32& w, GTerm t, int comp) {
  Fp x0, x1;
  sm_load(x0, 2 * t.x);
  sm_load(x1, 2 * t.x + 1);
  if (t.flags & FOLD) {  // fp2_mul_xi_wide
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const uint32_t u0 = x0.v[l], u1 = x1.v[l];
      x0.v[l] = 9 * u0 + KP[KP_2][l] - u1;
      x1.v[l] = u0 + 9 * u1;
    }
    fp_carry(x0);
    fp_carry(x1);
  }
  if (t.flags & DBL) {
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      x0.v[l] <<= 1;
      x1.v[l] <<= 1;
    }
    fp_carry(x0);
    fp_carry(x1);
  }
  const bool neg_a = t.flags & (comp ? NEG1 : NEG0);
  const bool neg_b = comp ? (t.flags & NEG0) != 0 : (t.flags & NEG1) == 0;
  Fp y;
  sm_load(y, 2 * t.y + comp);  // y0 for c0, y1 for c1
  if (neg_a) y = fp_neg(y);
  w32_mac(w, x0, y);
  sm_load(y, 2 * t.y + 1 - comp);
  if (neg_b) y = fp_neg(y);
  w32_mac(w, x1, y);
}

// Component k of level lv (warp-uniform): its slot's terms summed and
// reduced, into its shared row and its row of ``dst`` where the level has
// them (a lane past the batch edge stores no device row).
static __device__ __forceinline__ void run_level(int lv, int k, int32_t* __restrict__ dst,
                                                 size_t lanes, int lane, bool live) {
  if (k >= G_LEVELS[lv].width) return;
  const GSlot s = G_LEVELS[lv].slot[k >> 1];
  const int comp = k & 1;
  Wide32 w;
  w32_zero(w);
#pragma unroll 1
  for (int i = 0; i < s.count; ++i) {
    if (i) w32_fold(w);
    mac_term(w, G_TERMS[s.first + i], comp);
  }
  Fp r;
  w32_reduce(w, r);
  if (s.srow != NONE) sm_store(r, s.srow + comp);
  if (s.grow != NONE && dst != nullptr && live)
    store_fp(r, dst + (s.grow + comp) * NL * lanes + lane, lanes);
}

template <int FIRST, int COUNT>
static __device__ __forceinline__ void run_levels(int k, int32_t* __restrict__ dst, size_t lanes,
                                                  int lane, bool live) {
#pragma unroll 1
  for (int lv = FIRST; lv < FIRST + COUNT; ++lv) {
    run_level(lv, k, dst, lanes, lane, live);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(G_LANES * G_NORM_COMPS)
k_fq12_inv_norm(const int32_t* __restrict__ a, int32_t* __restrict__ scratch, int lanes) {
  const int k = threadIdx.y;
  const int lane = blockIdx.x * G_LANES + threadIdx.x;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  stage_row(a + (2 * k) * NL * n + col, n, 2 * k);
  stage_row(a + (2 * k + 1) * NL * n + col, n, 2 * k + 1);
  __syncthreads();
  run_levels<0, G_NORM_LEVELS>(k, scratch, n, lane, live);
}

__global__ void __launch_bounds__(BLOCK)
k_fq12_inv_chain(const int32_t* __restrict__ nrm, int32_t* __restrict__ ninv, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fp x;
  load_fp(x, nrm + lane, n);
  store_fp(fp32_inv(x), ninv + lane, n);
}

__global__ void __launch_bounds__(G_LANES * G_OUT_COMPS, 1)
k_fq12_inv_out(const int32_t* __restrict__ a, const int32_t* __restrict__ scratch,
               int32_t* __restrict__ out, int lanes) {
  const int k = threadIdx.y;
  const int lane = blockIdx.x * G_LANES + threadIdx.x;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  const size_t row = NL * n;
  stage_row(a + k * row + col, n, k);
  if (k < 6) stage_row(scratch + (SC_T + k) * row + col, n, 2 * S_T + k);
  else if (k < 8) stage_row(scratch + (SC_N + k - 6) * row + col, n, R_N + k - 6);
  else if (k == 8) stage_row(scratch + SC_NINV * row + col, n, R_NN);
  else if (k == 9) sm_store(Fp{}, R_ZERO);
  __syncthreads();
  run_levels<G_NORM_LEVELS, G_OUT_LEVELS>(k, out, n, lane, live);
}

static int launch_fq12_inv(const int32_t* a, int32_t* scratch, int32_t* out, int lanes,
                           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(k_fq12_inv_norm,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k_fq12_inv_out, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)G_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (lanes + G_LANES - 1) / G_LANES;
  const size_t n = (size_t)lanes;
  k_fq12_inv_norm<<<blocks, dim3(G_LANES, G_NORM_COMPS), G_SMEM, stream>>>(a, scratch, lanes);
  k_fq12_inv_chain<<<(lanes + BLOCK - 1) / BLOCK, BLOCK, 0, stream>>>(
      scratch + SC_NN * NL * n, scratch + SC_NINV * NL * n, lanes);
  k_fq12_inv_out<<<blocks, dim3(G_LANES, G_OUT_COMPS), G_SMEM, stream>>>(a, scratch, out,
                                                                        lanes);
  return (int)cudaGetLastError();
}

}  // namespace pt

// ``scratch`` is [10, 21, lanes] int32 of device memory, written and read
// by the three launches.
extern "C" int pt_fq12_inv(const int32_t* a, int32_t* scratch, int32_t* out, int lanes,
                           void* stream) {
  if (lanes <= 0) return (int)cudaGetLastError();
  return pt::launch_fq12_inv(a, scratch, out, lanes, (cudaStream_t)stream);
}

// The dynamic shared memory a block of the norm and output kernels asks for
// at launch (ptxas reports static shared memory only).
extern "C" int pt_fq12_inv_shared_bytes() { return (int)pt::G_SMEM; }
