// Design variants of kernels I (prefix products) and G (Fq12 inverse) beside
// the one-thread-per-lane kernels they replaced, for tools/ig_variants.py.
// The library's sources are included, so the committed kernels and their
// routines are the ones built here.
//
// I:
// * k_i_old: the one-thread-per-lane kernel that csrc/norm.cu replaced
//   (the running product in registers, field.cuh's fp2_mul).
// * k_i2<MINB>: the committed design (two ranks a lane, 16 lanes a warp)
//   under __launch_bounds__(128, MINB); MINB 1 caps nothing.
// * k_i4<MINB>: four ranks a lane, 8 lanes a warp; ranks h and h + 2 each
//   compute one of component h's two Fq products and add their column sums
//   by shuffle before both reduce.
//
// G:
// * fp32_inv_bits: field.cuh's fp_pow_bits for p - 2 on field32.cuh's
//   32-bit square and product, a bit at a time (the same steps and digits).
// * k_g_old<CHAIN32>: the one-thread-per-lane kernel that csrc/fq12_inv.cu
//   replaced; CHAIN32 swaps only its Fermat chain for fp32_inv_bits.
// * the committed three stages, with the committed 4-bit window chain
//   (field32.cuh's fp32_inv) or k_chain_bits in the middle, launched
//   together or one stage alone.
// * k_g_fused<W4>: the three stages in one kernel of 12 warps, the chain on
//   warp 0 while the others wait at __syncthreads, nothing in device memory
//   between them.
#include "norm.cu"
#include "fq12_inv.cu"

namespace pt {

// ---------------------------------------------------------------------------
// I
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK)
k_i_old(const int32_t* __restrict__ z, int n_steps, int32_t* __restrict__ prefix,
        int32_t* __restrict__ total, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  const size_t step = 2 * NL * n;
  Fp2 c;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    c.c0.v[l] = KP[KP_ONE][l];
    c.c1.v[l] = 0u;
  }
#pragma unroll 1
  for (int i = 0; i < n_steps; ++i) {
    store_fp2(c, prefix + i * step + lane, n);
    c = fp2_mul(c, load_fp2(z + i * step + lane, n));
  }
  store_fp2(c, total + lane, n);
}

template <int MINB>
__global__ void __launch_bounds__(I_THREADS, MINB)
k_i2(const int32_t* __restrict__ z, int n_steps, int32_t* __restrict__ prefix,
     int32_t* __restrict__ total, int lanes) {
  __shared__ uint32_t cs[I_WARPS * 2 * I_VAL];
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;
  const int g = t32 & (I_LANES - 1), h = t32 >> 4;
  const int lane = (blockIdx.x * I_WARPS + warp) * I_LANES + g;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  const size_t step = 2 * NL * n;
  uint32_t* buf = cs + warp * 2 * I_VAL + g;
  Fp v;
#pragma unroll
  for (int l = 0; l < NL; ++l) v.v[l] = h ? 0u : KP[KP_ONE][l];
#pragma unroll
  for (int l = 0; l < NL; ++l) buf[h * I_COMP + l * I_LANES] = v.v[l];
  int cur = 0;
#pragma unroll 1
  for (int i = 0; i < n_steps; ++i) {
    if (live) store_fp(v, prefix + i * step + h * NL * n + lane, n);
    __syncwarp();
    v = mul_part<I_LANES>(buf + cur * I_VAL, z + i * step + col, n, h);
    uint32_t* o = buf + (1 - cur) * I_VAL + h * I_COMP;
#pragma unroll
    for (int l = 0; l < NL; ++l) o[l * I_LANES] = v.v[l];
    cur = 1 - cur;
  }
  if (live) store_fp(v, total + h * NL * n + lane, n);
}

constexpr int I4_LANES = 8, I4_COMP = NL * I4_LANES, I4_VAL = 2 * I4_COMP;

// Threads 8r + g of a warp are rank r = h + 2q of lane g: component h,
// product q (q = 0: c0 z_h; q = 1: c1 (2p - z1) for h = 0, c1 z0 for h = 1).
// The two ranks of a component are 16 threads apart.
template <int MINB>
__global__ void __launch_bounds__(128, MINB)
k_i4(const int32_t* __restrict__ z, int n_steps, int32_t* __restrict__ prefix,
     int32_t* __restrict__ total, int lanes) {
  __shared__ uint32_t cs[4 * 2 * I4_VAL];
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;
  const int g = t32 & (I4_LANES - 1), r = t32 >> 3, h = r & 1, q = r >> 1;
  const int lane = (blockIdx.x * 4 + warp) * I4_LANES + g;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  const size_t step = 2 * NL * n;
  uint32_t* buf = cs + warp * 2 * I4_VAL + g;
  Fp v;
#pragma unroll
  for (int l = 0; l < NL; ++l) v.v[l] = h ? 0u : KP[KP_ONE][l];
  if (q == 0) {
#pragma unroll
    for (int l = 0; l < NL; ++l) buf[h * I4_COMP + l * I4_LANES] = v.v[l];
  }
  int cur = 0;
#pragma unroll 1
  for (int i = 0; i < n_steps; ++i) {
    if (live && q == 0) store_fp(v, prefix + i * step + h * NL * n + lane, n);
    __syncwarp();
    const uint32_t* c = buf + cur * I4_VAL + q * I4_COMP;
    Fp x, y;
#pragma unroll
    for (int l = 0; l < NL; ++l) x.v[l] = c[l * I4_LANES];
    load_fp(y, z + i * step + (q ? 1 - h : h) * NL * n + col, n);
    const Fp ny = fp_neg(y);
    const bool neg = q == 1 && h == 0;
#pragma unroll
    for (int l = 0; l < NL; ++l) y.v[l] = neg ? ny.v[l] : y.v[l];
    Wide32 w;
    w32_zero(w);
    w32_mac(w, x, y);
#pragma unroll
    for (int k = 0; k < 2 * NL - 1; ++k) w.t[k] += __shfl_xor_sync(0xffffffffu, w.t[k], 16);
    w32_reduce(w, v);
    if (q == 0) {
      uint32_t* o = buf + (1 - cur) * I4_VAL + h * I4_COMP;
#pragma unroll
      for (int l = 0; l < NL; ++l) o[l * I4_LANES] = v.v[l];
    }
    cur = 1 - cur;
  }
  if (live && q == 0) store_fp(v, total + h * NL * n + lane, n);
}

// ---------------------------------------------------------------------------
// G
// ---------------------------------------------------------------------------

static __device__ __forceinline__ Fp fp32_inv_bits(const Fp& x) {
  Fp r = x;
#pragma unroll 1
  for (int i = PM2_TOP - 1; i >= 0; --i) {
    r = fp32_sq(r);
    if ((PM2_WORDS[i >> 5] >> (i & 31)) & 1u) r = fp32_mul(r, x);
  }
  return r;
}

__global__ void __launch_bounds__(BLOCK)
k_chain_bits(const int32_t* __restrict__ nrm, int32_t* __restrict__ ninv, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fp x;
  load_fp(x, nrm + lane, n);
  store_fp(fp32_inv_bits(x), ninv + lane, n);
}

struct Fp6 { Fp2 c[3]; };

static __device__ __noinline__ void fq6_mul(const Fp6& x, const Fp6& y, Fp6& r) {
  const Fp2 a = fp2_add(fp2_mul(x.c[1], y.c[2]), fp2_mul(x.c[2], y.c[1]));
  r.c[0] = fp2_add(fp2_mul(x.c[0], y.c[0]), fp2_mul_xi(a));
  r.c[1] = fp2_add(fp2_add(fp2_mul(x.c[0], y.c[1]), fp2_mul(x.c[1], y.c[0])),
                   fp2_mul_xi(fp2_mul(x.c[2], y.c[2])));
  r.c[2] = fp2_add(fp2_add(fp2_mul(x.c[0], y.c[2]), fp2_mul(x.c[2], y.c[0])),
                   fp2_mul(x.c[1], y.c[1]));
}

// field.cuh's fp2_inv with the chain fp_pow_bits (bits from device memory)
// or fp32_inv_bits.
template <bool CHAIN32>
static __device__ __noinline__ Fp2 fp2_inv_v(const Fp2& a, const int32_t* __restrict__ bits,
                                             int n) {
  Wide w;
  wide_zero(w);
  wide_mac(w, a.c0, a.c0);
  wide_mac(w, a.c1, a.c1);
  Fp norm;
  mont_reduce(w, norm);
  const Fp ninv = CHAIN32 ? fp32_inv_bits(norm) : fp_pow_bits(norm, bits, n);
  return Fp2{fp_mul(a.c0, ninv), fp_mul(fp_neg(a.c1), ninv)};
}

template <bool CHAIN32>
static __device__ __noinline__ void fq6_inv(const Fp6& x, const int32_t* __restrict__ bits,
                                            int n_bits, Fp6& r) {
  const Fp2 &c0 = x.c[0], &c1 = x.c[1], &c2 = x.c[2];
  const Fp2 t0 = fp2_sub(fp2_sq(c0), fp2_mul_xi(fp2_mul(c1, c2)));
  const Fp2 t1 = fp2_sub(fp2_mul_xi(fp2_sq(c2)), fp2_mul(c0, c1));
  const Fp2 t2 = fp2_sub(fp2_sq(c1), fp2_mul(c0, c2));
  const Fp2 norm = fp2_add(fp2_mul(c0, t0),
                           fp2_mul_xi(fp2_add(fp2_mul(c1, t2), fp2_mul(c2, t1))));
  const Fp2 ninv = fp2_inv_v<CHAIN32>(norm, bits, n_bits);
  r.c[0] = fp2_mul(t0, ninv);
  r.c[1] = fp2_mul(t1, ninv);
  r.c[2] = fp2_mul(t2, ninv);
}

template <bool CHAIN32>
__global__ void __launch_bounds__(BLOCK)
k_g_old(const int32_t* __restrict__ a, const int32_t* __restrict__ bits, int n_bits,
        int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fp6 A, B, t, u;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    A.c[k] = load_fp2(a + (4 * k) * NL * n + lane, n);
    B.c[k] = load_fp2(a + (4 * k + 2) * NL * n + lane, n);
  }
  fq6_mul(B, B, t);
  fq6_mul(A, A, u);
  const Fp2 b2c2 = t.c[2];
  t.c[2] = fp2_sub(u.c[2], t.c[1]);
  t.c[1] = fp2_sub(u.c[1], t.c[0]);
  t.c[0] = fp2_sub(u.c[0], fp2_mul_xi(b2c2));
  fq6_inv<CHAIN32>(t, bits, n_bits, u);
  fq6_mul(A, u, t);
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    store_fp2(t.c[k], out + (4 * k) * NL * n + lane, n);
    B.c[k] = fp2_neg(B.c[k]);
  }
  fq6_mul(B, u, t);
#pragma unroll 1
  for (int k = 0; k < 3; ++k) store_fp2(t.c[k], out + (4 * k + 2) * NL * n + lane, n);
}

template <bool W4>
__global__ void __launch_bounds__(G_LANES * G_OUT_COMPS, 1)
k_g_fused(const int32_t* __restrict__ a, int32_t* __restrict__ out, int lanes) {
  const int k = threadIdx.y;
  const int lane = blockIdx.x * G_LANES + threadIdx.x;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  stage_row(a + k * NL * n + col, n, k);
  if (k == 9) sm_store(Fp{}, R_ZERO);
  __syncthreads();
  run_levels<0, G_NORM_LEVELS>(k, nullptr, n, lane, live);
  if (k == 0) {
    Fp x;
    sm_load(x, R_NN);
    sm_store(W4 ? fp32_inv(x) : fp32_inv_bits(x), R_NN);
  }
  __syncthreads();
  run_levels<G_NORM_LEVELS, G_OUT_LEVELS>(k, out, n, lane, live);
}

template <bool W4>
static int launch_fused(const int32_t* a, int32_t* out, int lanes, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      k_g_fused<W4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G_SMEM);
  if (err != cudaSuccess) return (int)err;
  k_g_fused<W4><<<(lanes + G_LANES - 1) / G_LANES, dim3(G_LANES, G_OUT_COMPS), G_SMEM, st>>>(
      a, out, lanes);
  return (int)cudaGetLastError();
}

// One stage of the committed kernel, or all three (stage 0), with the
// chosen chain.
static int launch_stages(int stage, bool w4, const int32_t* a, int32_t* scratch, int32_t* out,
                         int lanes, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(k_fq12_inv_norm,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k_fq12_inv_out, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)G_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (lanes + G_LANES - 1) / G_LANES;
  const size_t n = (size_t)lanes;
  if (stage == 0 || stage == 1)
    k_fq12_inv_norm<<<blocks, dim3(G_LANES, G_NORM_COMPS), G_SMEM, st>>>(a, scratch, lanes);
  if (stage == 0 || stage == 2) {
    const int cb = (lanes + BLOCK - 1) / BLOCK;
    if (w4)
      k_fq12_inv_chain<<<cb, BLOCK, 0, st>>>(scratch + SC_NN * NL * n,
                                            scratch + SC_NINV * NL * n, lanes);
    else
      k_chain_bits<<<cb, BLOCK, 0, st>>>(scratch + SC_NN * NL * n, scratch + SC_NINV * NL * n,
                                        lanes);
  }
  if (stage == 0 || stage == 3)
    k_fq12_inv_out<<<blocks, dim3(G_LANES, G_OUT_COMPS), G_SMEM, st>>>(a, scratch, out, lanes);
  return (int)cudaGetLastError();
}

}  // namespace pt

// kind: 0 the old kernel, 1 k_i2<1>, 2 k_i2<8>, 3 k_i4<1>, 4 k_i4<8>.
extern "C" int h_prefix(int kind, const int32_t* z, int n_steps, int32_t* prefix, int32_t* total,
                        int lanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int b2 = (lanes + pt::I_BLOCK_LANES - 1) / pt::I_BLOCK_LANES;
  const int b4 = (lanes + 4 * pt::I4_LANES - 1) / (4 * pt::I4_LANES);
  switch (kind) {
    case 0:
      pt::k_i_old<<<(lanes + pt::BLOCK - 1) / pt::BLOCK, pt::BLOCK, 0, st>>>(z, n_steps, prefix,
                                                                            total, lanes);
      break;
    case 1: pt::k_i2<1><<<b2, 128, 0, st>>>(z, n_steps, prefix, total, lanes); break;
    case 2: pt::k_i2<8><<<b2, 128, 0, st>>>(z, n_steps, prefix, total, lanes); break;
    case 3: pt::k_i4<1><<<b4, 128, 0, st>>>(z, n_steps, prefix, total, lanes); break;
    case 4: pt::k_i4<8><<<b4, 128, 0, st>>>(z, n_steps, prefix, total, lanes); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// kind: 0 the old kernel, 1 the old kernel with fp32_inv_bits, 2 the three
// stages with the bit chain, 3 with the window, 4 fused with the bit chain,
// 5 fused with the window; 6-8 stage 1, the bit chain, stage 3 alone, 9
// the window chain alone. ``bits`` (p - 2's after its leading one) serve
// kind 0.
extern "C" int h_inv(int kind, const int32_t* a, const int32_t* bits, int n_bits,
                     int32_t* scratch, int32_t* out, int lanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int b1 = (lanes + pt::BLOCK - 1) / pt::BLOCK;
  switch (kind) {
    case 0: pt::k_g_old<false><<<b1, pt::BLOCK, 0, st>>>(a, bits, n_bits, out, lanes); break;
    case 1: pt::k_g_old<true><<<b1, pt::BLOCK, 0, st>>>(a, bits, n_bits, out, lanes); break;
    case 2: return pt::launch_stages(0, false, a, scratch, out, lanes, st);
    case 3: return pt::launch_stages(0, true, a, scratch, out, lanes, st);
    case 4: return pt::launch_fused<false>(a, out, lanes, st);
    case 5: return pt::launch_fused<true>(a, out, lanes, st);
    case 6: return pt::launch_stages(1, false, a, scratch, out, lanes, st);
    case 7: return pt::launch_stages(2, false, a, scratch, out, lanes, st);
    case 8: return pt::launch_stages(3, false, a, scratch, out, lanes, st);
    case 9: return pt::launch_stages(2, true, a, scratch, out, lanes, st);
    default: return -1;
  }
  return (int)cudaGetLastError();
}
