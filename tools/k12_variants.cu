// Kernel K12's design variants beside its one-thread-per-lane predecessor,
// for tools/k12_variants.py: the same ladder, the same digits.
//
// * k_exp_bits_old: the one-thread-per-lane kernel that csrc/exp_bits.cu
//   replaced (x and two Fq12 rows in local memory, field.cuh's routines).
// * k_var<RESIDENT, STORE>: the six-thread group core of csrc/exp_bits.cu.
//   RESIDENT keeps x in a third shared region a lane, loaded once (the
//   committed design); otherwise x is staged in the scratch on every set
//   bit, as kernel D stages its stream row. STORE 1 writes every row, each
//   rank its own slot (the committed design); 0 writes the last row only;
//   2 stages the block's 20 lanes and writes each row as 80-byte runs,
//   with two __syncthreads a step.
#include <cuda_runtime.h>

#include "field_group.cuh"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_exp_bits_old(const int32_t* __restrict__ x_src, const int32_t* __restrict__ bits, int n_bits,
               int32_t* __restrict__ rows, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  const size_t row_words = 12 * NL * n;
  Fq12 x, f0, f1;
  Fq12* f = &f0;
  Fq12* g = &f1;
  load_fq12(x, x_src + lane, n);
  fq12_set_one(*f);
#pragma unroll 1
  for (int s = 0; s < n_bits; ++s) {
    fq12_cyc_sq(*f, *g);
    if (__ldg(bits + s) != 0) {
      fq12_mul(*g, x, DENSE, *f);
    } else {
      Fq12* tmp = f;
      f = g;
      g = tmp;
    }
    store_fq12(*f, rows + s * row_words + lane, n);
  }
}

// Block-wide row store: the block's 20 lanes of one row, 80-byte runs.
static __device__ __forceinline__ void block_store_row(const uint32_t* smem, int stride,
                                                       int32_t* __restrict__ dst, int lane0,
                                                       int lanes) {
#pragma unroll 1
  for (int w = threadIdx.x; w < F12_WORDS * 20; w += 128) {
    const int cl = w / 20, li = w - cl * 20;
    const int lane = lane0 + li;
    if (lane < lanes) dst[(size_t)cl * lanes + lane] = (int32_t)smem[li * stride + cl];
  }
}

// Threads 30 and 31 of a warp stay only where they must reach
// __syncthreads (STORE 2).
template <bool RESIDENT, int STORE>
__global__ void __launch_bounds__(128, 2)
k_var(const int32_t* __restrict__ x_src, const int32_t* __restrict__ bits, int n_bits,
      int32_t* __restrict__ rows, int lanes) {
  extern __shared__ uint32_t smem[];
  constexpr int STRIDE = RESIDENT ? 3 * F12_WORDS + 1 : GROUP_STRIDE;
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;
  const bool idle = t32 >= GROUP * GROUP_LANES;
  if (idle && STORE != 2) return;
  const int g = idle ? 0 : t32 / GROUP, s = idle ? 0 : t32 % GROUP;
  const int lane = (blockIdx.x * 4 + warp) * GROUP_LANES + g;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  uint32_t* f = smem + (warp * GROUP_LANES + g) * STRIDE;
  uint32_t* scr = f + F12_WORDS;
  uint32_t* xs = RESIDENT ? scr + F12_WORDS : scr;
  const size_t row_words = 12 * NL * n;
  if (!idle) {
    group_set_one(f, s);
    if (RESIDENT) group_load_slot(xs, x_src + col, n, s);
    __syncwarp(GROUP_MASK);
  }
#pragma unroll 1
  for (int t = 0; t < n_bits; ++t) {
    if (!idle) {
      group_cyc_sq(f, scr, s);
      if (__ldg(bits + t) != 0) {
        if (!RESIDENT) {
          group_load_slot(scr, x_src + col, n, s);
          __syncwarp(GROUP_MASK);
        }
        group_fq12_mul(f, xs, s);
      }
      if (STORE == 1 && live) group_store_slot(f, rows + t * row_words + lane, n, s);
    }
    if (STORE == 2) {
      __syncthreads();
      block_store_row(smem, STRIDE, rows + t * row_words, blockIdx.x * 20, lanes);
      __syncthreads();
    }
  }
  if (STORE == 0 && !idle && live)
    group_store_slot(f, rows + (size_t)(n_bits - 1) * row_words + lane, n, s);
}

// The variant's shared memory is dynamic: 40,400 B a block, or 60,560 B
// with x resident (over 48 KB: set at each launch).
template <bool R, int S>
static int launch(const int32_t* x, const int32_t* bits, int n_bits, int32_t* rows, int lanes,
                  cudaStream_t st) {
  const int bytes = 20 * (R ? 3 * F12_WORDS + 1 : GROUP_STRIDE) * 4;
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(k_var<R, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  k_var<R, S><<<(lanes + 19) / 20, 128, bytes, st>>>(x, bits, n_bits, rows, lanes);
  return (int)cudaGetLastError();
}

}  // namespace pt

extern "C" int h_old(const int32_t* x, const int32_t* bits, int n_bits, int32_t* rows,
                     int lanes, void* stream) {
  pt::k_exp_bits_old<<<(lanes + pt::BLOCK - 1) / pt::BLOCK, pt::BLOCK, 0,
                       (cudaStream_t)stream>>>(x, bits, n_bits, rows, lanes);
  return (int)cudaGetLastError();
}

extern "C" int h_var(int resident, int store, const int32_t* x, const int32_t* bits, int n_bits,
                     int32_t* rows, int lanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (resident) {
    if (store == 0) return pt::launch<true, 0>(x, bits, n_bits, rows, lanes, st);
    if (store == 1) return pt::launch<true, 1>(x, bits, n_bits, rows, lanes, st);
    return pt::launch<true, 2>(x, bits, n_bits, rows, lanes, st);
  }
  if (store == 0) return pt::launch<false, 0>(x, bits, n_bits, rows, lanes, st);
  if (store == 1) return pt::launch<false, 1>(x, bits, n_bits, rows, lanes, st);
  return pt::launch<false, 2>(x, bits, n_bits, rows, lanes, st);
}
