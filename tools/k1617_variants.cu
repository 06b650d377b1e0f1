// Kernels K16 and K17: their design variants beside the one-thread-per-lane
// kernels they replaced, for tools/k1617_variants.py: the same ladders, the
// same digits. The library's sources are included, so the committed kernels
// are the ones timed here.
//
// * k_naf_old, k_w4_old: the kernels that csrc/pow_naf.cu and csrc/pow_w4.cu
//   replaced: one thread per lane with field.cuh's Fq12 routines, the state
//   in local memory; K17's table {m, m^3, m^5, m^7} in a global scratch [4,
//   12, 21, lanes] read back through signed_entry_old (field.cuh's former
//   fq12_signed_entry, copied here).
// * k_naf_staged: K16 on the group core staging m or mc from device memory
//   into the scratch region on each nonzero digit, as kernel D stages its
//   stream row (two Fq12 a lane, 40,400 B a block).
// * k_w4_two_phase: the committed K17's work with the table built before
//   the ladder loop, its square and products inlined at call sites of their
//   own.
// * k_w4_scratch4: the committed K17 with m stored as scratch row 0 too
//   ([4, 12, 21, cols]), so that every entry is read from the scratch.
// * k_w4_res<ROWS, WARPS, MIN_BLOCKS>: the committed K17's loop with the
//   table rows resident in shared memory beside f and the scratch. ROWS 3
//   keeps m^3, m^5, m^7 and reads m from the input (five Fq12 a lane,
//   100,880 B a block of 4 warps, two blocks an SM); ROWS 4 keeps all four
//   rows (six Fq12 a lane: 121,040 B a block of 4 warps, one block an SM;
//   or 60,520 B a block of 2 warps, three blocks an SM). m^7's place holds
//   m2 until m^7 is written; a positive digit multiplies by its resident
//   row in place, a negative one stages the row conjugated.
#include <cuda_runtime.h>

#include "pow_naf.cu"
#include "pow_w4.cu"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_naf_old(const int32_t* __restrict__ m, const int32_t* __restrict__ mc,
          const int32_t* __restrict__ digits, int n_digits, int32_t* __restrict__ out,
          int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fq12 f0, f1, y;
  Fq12* f = &f0;
  Fq12* g = &f1;
  load_fq12(*f, m + lane, n);
#pragma unroll 1
  for (int t = 0; t < n_digits; ++t) {
    fq12_cyc_sq(*f, *g);
    const int d = __ldg(digits + t);
    if (d != 0) {
      load_fq12(y, (d > 0 ? m : mc) + lane, n);
      fq12_mul(*g, y, DENSE, *f);
    } else {
      Fq12* tmp = f;
      f = g;
      g = tmp;
    }
  }
  store_fq12(*f, out + lane, n);
}

static __device__ __noinline__ void signed_entry_old(const int32_t* tab, size_t lanes, int d,
                                                     Fq12& f) {
  const int row = (d < 0 ? -d : d) >> 1;
  load_fq12_rw(f, tab + (size_t)row * 12 * NL * lanes, lanes);
  if (d < 0) {
#pragma unroll 1
    for (int c = 2; c < 12; c += 4) {  // components of slots 1, 3, 5
      f.c[c] = fp_neg(f.c[c]);
      f.c[c + 1] = fp_neg(f.c[c + 1]);
    }
  }
}

__global__ void __launch_bounds__(BLOCK)
k_w4_old(const int32_t* __restrict__ m, const int32_t* __restrict__ digits, int n_digits,
         int32_t* tab, int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  const size_t row_words = 12 * NL * n;
  int32_t* tab_lane = tab + lane;
  Fq12 x, m2, f0, f1;
  load_fq12(x, m + lane, n);
  store_fq12(x, tab_lane, n);
  fq12_cyc_sq(x, m2);
#pragma unroll 1
  for (int r = 1; r < 4; ++r) {  // x = tab[r - 1] -> tab[r] = m2 * x
    fq12_mul(m2, x, DENSE, f0);
    store_fq12(f0, tab_lane + r * row_words, n);
    x = f0;
  }
  Fq12* f = &f0;
  Fq12* g = &f1;
  signed_entry_old(tab_lane, n, __ldg(digits), *f);
#pragma unroll 1
  for (int t = 1; t < n_digits; ++t) {
    fq12_cyc_sq(*f, *g);
    const int d = __ldg(digits + t);
    if (d != 0) {
      signed_entry_old(tab_lane, n, d, x);
      fq12_mul(*g, x, DENSE, *f);
    } else {
      Fq12* tmp = f;
      f = g;
      g = tmp;
    }
  }
  store_fq12(*f, out + lane, n);
}

__global__ void __launch_bounds__(128, 2)
k_naf_staged(const int32_t* __restrict__ m, const int32_t* __restrict__ mc,
             const int32_t* __restrict__ digits, int n_digits, int32_t* __restrict__ out,
             int lanes) {
  __shared__ uint32_t smem[4 * GROUP_LANES * GROUP_STRIDE];
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;
  if (t32 >= GROUP * GROUP_LANES) return;
  const int g = t32 / GROUP, s = t32 % GROUP;
  const int lane = (blockIdx.x * 4 + warp) * GROUP_LANES + g;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  uint32_t* f = smem + (warp * GROUP_LANES + g) * GROUP_STRIDE;
  uint32_t* scr = f + F12_WORDS;
  group_load_slot(f, m + col, n, s);
  __syncwarp(GROUP_MASK);
#pragma unroll 1
  for (int t = 0; t < n_digits; ++t) {
    group_cyc_sq(f, scr, s);
    const int d = __ldg(digits + t);
    if (d != 0) {
      group_load_slot(scr, (d > 0 ? m : mc) + col, n, s);
      __syncwarp(GROUP_MASK);
      group_fq12_mul(f, scr, s);
    }
  }
  if (live) group_store_slot(f, out + lane, n, s);
}

// Slot s of shared ``src`` to ``dst``, negated for ``neg``.
static __device__ __forceinline__ void copy_slot(uint32_t* dst, const uint32_t* src, int s,
                                                 bool neg) {
#pragma unroll 1
  for (int c = 2 * s; c < 2 * s + 2; ++c) {
    Fp x;
    sh_load(x, src + c * NL);
    if (neg) x = fp_neg(x);
    sh_store(x, dst + c * NL);
  }
}

// The lane's place in a group-core kernel of W warps a block; returns false
// for threads 30 and 31 of a warp.
#define GROUP_LANE(W)                                                      \
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;               \
  if (t32 >= GROUP * GROUP_LANES) return;                                  \
  const int g = t32 / GROUP, s = t32 % GROUP;                              \
  const int lane = (blockIdx.x * (W) + warp) * GROUP_LANES + g;            \
  const bool live = lane < lanes;                                          \
  const size_t n = (size_t)lanes;                                          \
  const int32_t* m_col = m + (live ? (size_t)lane : n - 1)

__global__ void __launch_bounds__(128, 2)
k_w4_two_phase(const int32_t* __restrict__ m, const int32_t* __restrict__ digits, int n_digits,
               int32_t* tab, int tab_cols, int32_t* __restrict__ out, int lanes) {
  extern __shared__ uint32_t smem[];
  GROUP_LANE(4);
  const size_t cols = (size_t)tab_cols;
  int32_t* tab_col = tab + lane;
  uint32_t* f = smem + (warp * GROUP_LANES + g) * K17_STRIDE;
  uint32_t* scr = f + F12_WORDS;
  uint32_t* m2 = scr + F12_WORDS;
  group_load_slot(f, m_col, n, s);
  group_load_slot(m2, m_col, n, s);
  __syncwarp(GROUP_MASK);
  group_cyc_sq(m2, scr, s);
#pragma unroll 1
  for (int r = 0; r < 3; ++r) {  // f = tab[r] -> tab[r + 1] = m2 * f
    group_fq12_mul_to(f, m2, f, s);
    group_store_slot(f, tab_col + (size_t)r * 12 * NL * cols, cols, s);
  }
  stage_entry(f, m_col, n, tab_col, cols, __ldg(digits), s);
  __syncwarp(GROUP_MASK);
#pragma unroll 1
  for (int t = 1; t < n_digits; ++t) {
    group_cyc_sq(f, scr, s);
    const int d = __ldg(digits + t);
    if (d != 0) {
      stage_entry(scr, m_col, n, tab_col, cols, d, s);
      __syncwarp(GROUP_MASK);
      group_fq12_mul(f, scr, s);
    }
  }
  if (live) group_store_slot(f, out + lane, n, s);
}

// stage_entry with every row, m's too, read from the scratch.
static __device__ __forceinline__ void stage_scratch4(uint32_t* dst, const int32_t* tab,
                                                      size_t cols, int d, int s) {
  const int row = (d < 0 ? -d : d) >> 1;
  const bool neg = d < 0 && (s & 1);
#pragma unroll 1
  for (int c = 2 * s; c < 2 * s + 2; ++c) {
    Fp x;
    load_fp_rw(x, tab + ((size_t)row * 12 + c) * NL * cols, cols);
    if (neg) x = fp_neg(x);
    sh_store(x, dst + c * NL);
  }
}

__global__ void __launch_bounds__(128, 2)
k_w4_scratch4(const int32_t* __restrict__ m, const int32_t* __restrict__ digits, int n_digits,
              int32_t* tab, int tab_cols, int32_t* __restrict__ out, int lanes) {
  extern __shared__ uint32_t smem[];
  GROUP_LANE(4);
  const size_t cols = (size_t)tab_cols, row_words = 12 * NL * cols;
  int32_t* tab_col = tab + lane;
  uint32_t* f = smem + (warp * GROUP_LANES + g) * K17_STRIDE;
  uint32_t* scr = f + F12_WORDS;
  uint32_t* m2 = scr + F12_WORDS;
  group_load_slot(f, m_col, n, s);
  group_load_slot(m2, m_col, n, s);
  group_store_slot(f, tab_col, cols, s);  // row 0: the slot this rank loaded
  __syncwarp(GROUP_MASK);
#pragma unroll 1
  for (int u = 0; u < n_digits + 3; ++u) {
    const bool table = u < 3;
    if (u == 0 || u > 3) group_cyc_sq(u == 0 ? m2 : f, scr, s);
    const int d = table ? 0 : __ldg(digits + u - 3);
    if (d != 0) {
      stage_scratch4(u == 3 ? f : scr, tab_col, cols, d, s);
      __syncwarp(GROUP_MASK);
    }
    if (table || (u > 3 && d != 0)) {
      group_fq12_mul_to(f, table ? m2 : f, table ? f : scr, s);
      if (table) group_store_slot(f, tab_col + (size_t)(u + 1) * row_words, cols, s);
    }
  }
  if (live) group_store_slot(f, out + lane, n, s);
}

template <int ROWS, int WARPS, int MIN_BLOCKS>
__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
k_w4_res(const int32_t* __restrict__ m, const int32_t* __restrict__ digits, int n_digits,
         int32_t* __restrict__ out, int lanes) {
  extern __shared__ uint32_t smem[];
  constexpr int STRIDE = (2 + ROWS) * F12_WORDS + 1;
  constexpr int FIRST = 4 - ROWS;  // the first resident row
  GROUP_LANE(WARPS);
  uint32_t* f = smem + (warp * GROUP_LANES + g) * STRIDE;
  uint32_t* scr = f + F12_WORDS;
  uint32_t* rows = scr + F12_WORDS - FIRST * F12_WORDS;  // row r at rows + r * F12_WORDS
  uint32_t* m2 = rows + 3 * F12_WORDS;
  group_load_slot(f, m_col, n, s);
  group_load_slot(m2, m_col, n, s);
  if (FIRST == 0) group_load_slot(rows, m_col, n, s);
  __syncwarp(GROUP_MASK);
#pragma unroll 1
  for (int u = 0; u < n_digits + 3; ++u) {
    const bool table = u < 3;
    if (u == 0 || u > 3) group_cyc_sq(u == 0 ? m2 : f, scr, s);
    const int d = table ? 0 : __ldg(digits + u - 3);
    const uint32_t* b = scr;
    if (d != 0) {
      const int row = (d < 0 ? -d : d) >> 1;
      if (u > 3 && d > 0 && row >= FIRST) {
        b = rows + row * F12_WORDS;
      } else {
        uint32_t* dst = u == 3 ? f : scr;
        if (row < FIRST) {
          stage_entry(dst, m_col, n, nullptr, 0, d, s);
        } else {
          copy_slot(dst, rows + row * F12_WORDS, s, d < 0 && (s & 1));
        }
        __syncwarp(GROUP_MASK);
      }
    }
    if (table || (u > 3 && d != 0)) {
      group_fq12_mul_to(f, table ? m2 : f, table ? f : b, s);
      // u = 2 writes m^7 over m2, which every rank has read
      if (table) copy_slot(rows + (u + 1) * F12_WORDS, f, s, false);
    }
  }
  if (live) group_store_slot(f, out + lane, n, s);
}

template <int ROWS, int WARPS, int MIN_BLOCKS>
static int launch_w4_res(const int32_t* m, const int32_t* digits, int n_digits, int32_t* out,
                         int lanes, cudaStream_t st) {
  constexpr int LANES = WARPS * GROUP_LANES;
  constexpr int BYTES = LANES * ((2 + ROWS) * F12_WORDS + 1) * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      k_w4_res<ROWS, WARPS, MIN_BLOCKS>, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return (int)err;
  k_w4_res<ROWS, WARPS, MIN_BLOCKS><<<(lanes + LANES - 1) / LANES, WARPS * 32, BYTES, st>>>(
      m, digits, n_digits, out, lanes);
  return (int)cudaGetLastError();
}

}  // namespace pt

// K16, ``reps`` launches back to back. kind: 0 the old kernel, 1 the
// committed entry (m and mc resident), 2 m or mc staged per digit.
extern "C" int h_naf(int kind, const int32_t* m, const int32_t* mc, const int32_t* digits,
                     int n_digits, int32_t* out, int lanes, int reps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  for (int r = 0; r < reps; ++r) {
    int err = 0;
    if (kind == 0) {
      pt::k_naf_old<<<(lanes + pt::BLOCK - 1) / pt::BLOCK, pt::BLOCK, 0, st>>>(
          m, mc, digits, n_digits, out, lanes);
      err = (int)cudaGetLastError();
    } else if (kind == 1) {
      err = pt_pow_ladder(m, mc, digits, n_digits, out, lanes, stream);
    } else {
      pt::k_naf_staged<<<(lanes + 19) / 20, 128, 0, st>>>(m, mc, digits, n_digits, out, lanes);
      err = (int)cudaGetLastError();
    }
    if (err != 0) return err;
  }
  return 0;
}

// K17, ``reps`` launches back to back. kind: 0 the old kernel (``tab`` [4,
// 12, 21, lanes]), 1 the committed entry (``tab`` [3, 12, 21, tab_cols]), 2
// the table built before the loop, 3 every row in the scratch (``tab`` [4,
// 12, 21, tab_cols]), 4 three rows resident, 5 four rows resident in blocks
// of 4 warps, 6 four rows resident in blocks of 2 warps.
extern "C" int h_w4(int kind, const int32_t* m, const int32_t* digits, int n_digits,
                    int32_t* tab, int tab_cols, int32_t* out, int lanes, int reps,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (lanes + pt::K17_LANES - 1) / pt::K17_LANES;
  for (int r = 0; r < reps; ++r) {
    int err = 0;
    switch (kind) {
      case 0:
        pt::k_w4_old<<<(lanes + pt::BLOCK - 1) / pt::BLOCK, pt::BLOCK, 0, st>>>(
            m, digits, n_digits, tab, out, lanes);
        err = (int)cudaGetLastError();
        break;
      case 1:
        err = pt_pow_ladder_w4(m, digits, n_digits, tab, tab_cols, out, lanes, stream);
        break;
      case 2:
      case 3:
        if (tab_cols < blocks * pt::K17_LANES) return (int)cudaErrorInvalidValue;
        if (kind == 2) {
          err = (int)cudaFuncSetAttribute(pt::k_w4_two_phase,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)pt::K17_SMEM);
          if (err == 0)
            pt::k_w4_two_phase<<<blocks, pt::K17_THREADS, pt::K17_SMEM, st>>>(
                m, digits, n_digits, tab, tab_cols, out, lanes);
        } else {
          err = (int)cudaFuncSetAttribute(pt::k_w4_scratch4,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          (int)pt::K17_SMEM);
          if (err == 0)
            pt::k_w4_scratch4<<<blocks, pt::K17_THREADS, pt::K17_SMEM, st>>>(
                m, digits, n_digits, tab, tab_cols, out, lanes);
        }
        if (err == 0) err = (int)cudaGetLastError();
        break;
      case 4:
        err = pt::launch_w4_res<3, 4, 2>(m, digits, n_digits, out, lanes, st);
        break;
      case 5:
        err = pt::launch_w4_res<4, 4, 1>(m, digits, n_digits, out, lanes, st);
        break;
      default:
        err = pt::launch_w4_res<4, 2, 3>(m, digits, n_digits, out, lanes, st);
    }
    if (err != 0) return err;
  }
  return 0;
}
