// Design variants of kernels F (Fq power) and B (cyclotomic square) beside
// the one-thread-per-lane kernels they replaced, and a 32-bit IMAD
// throughput loop, for tools/fb_variants.py. The library's sources are
// included, so the committed kernels and their routines are the ones built
// here.
//
// F:
// * k_f_old: the one-thread-per-lane kernel that csrc/fp_pow.cu replaced
//   (field.cuh's fp_pow_bits: 64-bit columns, a bit at a time, the bits
//   after the leading one read from device memory at every step).
// * pt_fp_pow_bits: the committed entry (fp32_pow_w4, the exponent's words
//   read from a device array).
// * k_f_param: the same chain with up to F_PARAM_WORDS words by value in a
//   __grid_constant__ kernel parameter, the constant bank.
// * k_f_pm2: p - 2 compiled in, field32.cuh's fp32_inv (kernel G's chain
//   kernel): what run-time digits cost.
//
// B:
// * k_b_old: the one-thread-per-lane kernel that csrc/cyc_sq.cu replaced
//   (field.cuh's fq12_cyc_sq, 64-bit columns).
// * pt_fq12_cyc_sq: the committed kernel, the block's 12 input rows staged
//   once in shared memory.
// * k_b_l1: the same threads with every operand read from device memory
//   through L1 and carried at each use, as kernel A reads (l1_term.cuh:
//   the term loop on another row source); a lane past the batch edge
//   returns.
//
// k_imad_rate: IMAD_CHAINS independent chains of 32-bit multiply-adds a
// thread (mad.lo.u32), for the card's IMAD rate per SM and clock.
#include "fp_pow.cu"
#include "cyc_sq.cu"
#include "l1_term.cuh"

namespace pt {

// ---------------------------------------------------------------------------
// F
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK)
k_f_old(const int32_t* __restrict__ a, const int32_t* __restrict__ bits, int n_bits,
        int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fp x;
  load_fp(x, a + lane, n);
  store_fp(fp_pow_bits(x, bits, n_bits), out + lane, n);
}

constexpr int F_PARAM_WORDS = 16;  // exponents below 2^512 by value

// words[k] of an exponent passed by value (a __grid_constant__ parameter).
struct ParamWords {
  uint32_t w[F_PARAM_WORDS];
  __device__ __forceinline__ uint32_t operator[](int k) const { return w[k]; }
};

__global__ void __launch_bounds__(BLOCK)
k_f_param(const int32_t* __restrict__ a, const __grid_constant__ ParamWords words, int top,
          int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fp x;
  load_fp(x, a + lane, n);
  store_fp(fp32_pow_w4(x, words, top), out + lane, n);
}

__global__ void __launch_bounds__(BLOCK)
k_f_pm2(const int32_t* __restrict__ a, int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fp x;
  load_fp(x, a + lane, n);
  store_fp(fp32_inv(x), out + lane, n);
}

// ---------------------------------------------------------------------------
// B
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK)
k_b_old(const int32_t* __restrict__ a, int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fq12 x, z;
  load_fq12(x, a + lane, n);
  fq12_cyc_sq(x, z);
  store_fq12(z, out + lane, n);
}

// cyc_sq.cu's cyc_component on l1_term.
__global__ void __launch_bounds__(B_THREADS, 1)
k_b_l1(const int32_t* __restrict__ a, int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * B_LANES + threadIdx.x;
  if (lane >= lanes) return;
  const int k = threadIdx.y, i = k >> 1, comp = k & 1;
  const size_t n = (size_t)lanes;
  const int32_t* src = a + lane;
  const BSlot slot = B_SLOTS[i];
  Wide32 w;
  w32_zero(w);
#pragma unroll 1
  for (int j = 0; j < slot.count; ++j) {
    if (j) w32_fold(w);
    l1_term(w, src, n, B_TERMS[slot.first + j], comp);
  }
  Fp t, s;
  w32_reduce_imm(w, t);
  load_fp(s, src + k * NL * n, n);
  const Fp t3 = small<3>(t), s2 = small<2>(s);
  store_fp((i & 1) ? fp_add(t3, s2) : fp_sub(t3, s2), out + k * NL * n + lane, n);
}

// ---------------------------------------------------------------------------
// IMAD throughput
// ---------------------------------------------------------------------------

constexpr int IMAD_CHAINS = 8, IMAD_UNROLL = 16, IMAD_THREADS = 256;

__global__ void __launch_bounds__(IMAD_THREADS)
k_imad_rate(uint32_t* __restrict__ out, uint32_t m, uint32_t c, int iters) {
  uint32_t v[IMAD_CHAINS];
#pragma unroll
  for (int j = 0; j < IMAD_CHAINS; ++j) v[j] = threadIdx.x * (j + 1) + blockIdx.x;
#pragma unroll 1
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int u = 0; u < IMAD_UNROLL; ++u)
#pragma unroll
      for (int j = 0; j < IMAD_CHAINS; ++j) {
#ifdef __CUDA_ARCH__
        asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(v[j]) : "r"(m), "r"(c));
#else
        v[j] = v[j] * m + c;
#endif
      }
  uint32_t s = 0;
#pragma unroll
  for (int j = 0; j < IMAD_CHAINS; ++j) s ^= v[j];
  out[blockIdx.x * IMAD_THREADS + threadIdx.x] = s;
}

}  // namespace pt

// kind: 0 the old kernel (``bits``: e's bits after its leading one), 1 the
// committed entry (``words``: the n_words words of e in device memory), 2
// the chain with the words by value (``host_words``, at most F_PARAM_WORDS
// of them), 3 p - 2 compiled in (e is p - 2; words ignored).
extern "C" int h_fpow(int kind, const int32_t* a, const int32_t* bits, int n_bits,
                      const int32_t* words, const int32_t* host_words, int n_words, int top,
                      int32_t* out, int lanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
  switch (kind) {
    case 0: pt::k_f_old<<<blocks, pt::BLOCK, 0, st>>>(a, bits, n_bits, out, lanes); break;
    case 1: return pt_fp_pow_bits(a, words, n_words, top, out, lanes, stream);
    case 2: {
      if (n_words > pt::F_PARAM_WORDS) return (int)cudaErrorInvalidValue;
      pt::ParamWords w{};
      for (int k = 0; k < n_words; ++k) w.w[k] = (uint32_t)host_words[k];
      pt::k_f_param<<<blocks, pt::BLOCK, 0, st>>>(a, w, top, out, lanes);
      break;
    }
    case 3: pt::k_f_pm2<<<blocks, pt::BLOCK, 0, st>>>(a, out, lanes); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// kind: 0 the old kernel, 1 the committed kernel (rows staged in shared
// memory), 2 every operand through L1.
extern "C" int h_cyc(int kind, const int32_t* a, int32_t* out, int lanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int b32 = (lanes + pt::B_LANES - 1) / pt::B_LANES;
  switch (kind) {
    case 0:
      pt::k_b_old<<<(lanes + pt::BLOCK - 1) / pt::BLOCK, pt::BLOCK, 0, st>>>(a, out, lanes);
      break;
    case 1: return pt_fq12_cyc_sq(a, out, lanes, stream);
    case 2: pt::k_b_l1<<<b32, dim3(pt::B_LANES, pt::B_COMPS), 0, st>>>(a, out, lanes); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// ``out``: blocks x 256 words.
extern "C" int h_imad(uint32_t* out, uint32_t m, uint32_t c, int iters, int blocks,
                      void* stream) {
  pt::k_imad_rate<<<blocks, pt::IMAD_THREADS, 0, (cudaStream_t)stream>>>(out, m, c, iters);
  return (int)cudaGetLastError();
}

extern "C" int h_imad_per_thread_iter() { return pt::IMAD_CHAINS * pt::IMAD_UNROLL; }
