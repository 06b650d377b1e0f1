// Kernel K13: the witness path's affine export of the Miller trajectory,
// (x, y) = (X zi^2, Y zi^3) for every stack state and lane.
//
// Replaces pairing_tpu/ops/fq2_vm.py:vm_apply_stacked (pallas_call at :334,
// body _vm_kernel_stacked), which on the witness path runs only
// miller_loop._affine_export_program (:213): zi^2, zi^3, X zi^2, Y zi^3 on
// the fq2_vm interpreter, once per (stack entry, batch tile). The TPU used an
// interpreter to keep kernel IR small for long Fq2 programs; a GPU thread
// runs straight-line code, and this program is four Fq2 operations, so it is
// written out here and the general interpreter is not carried over. It has
// no other caller on the port's paths.
//
// Inputs: the stack as up to K13_MAX_SEGS segments (the Miller loop's tops,
// post-doubles, end and end + Q1 where they lie, no copy), each state's
// first four component rows X.c0, X.c1, Y.c0, Y.c1, ``rows`` rows from one
// state to the next; zinv [S, 2, 21, lanes] (1 / Z from the Phase N passes).
// Output [S, 4, 21, lanes] (x.c0, x.c1, y.c0, y.c1).
//
// Bound on the H100: integer multiply-adds. One Fq2 square and three Fq2
// products need at least 8,547 32-bit IMADs per state and lane (complex
// squaring and Karatsuba, each output coefficient reduced once; the count
// in chip_smoke.py), against 504 bytes read and 336 written: above the
// card's op-per-byte line. The first port ran field.cuh's out-of-line
// fp2_sq and fp2_mul on 64-bit columns (about 20 k IMADs, 190 registers,
// 840 B of stack).
//
// Design: one thread per (state, lane), blockIdx.y the state, 128 lanes a
// block, every step on 32-bit columns (field32.cuh) and reduced once an
// output coefficient: zi^2 by complex squaring (fp2_sq32, field.cuh's
// fp2_sq on the same integers), then one loop body of three Karatsuba
// products (fp2_mul_kara): x = X zi^2, zi^3 = zi zi^2, y = Y zi^3, the
// right operand in this thread's column of shared memory, the left read
// from device memory, so that no more than two accumulators and two
// operands are live (168 registers, no stack). tools/ek13_variants.py
// times this layout against the right operand in registers and against
// two threads per (state, lane), one for x and one for y, sharing zi^2 in
// shared memory. The products' digits may differ by p from the first
// port's (Karatsuba sums another multiple of p); the values are the same.
#include <cuda_runtime.h>

#include "field32.cuh"

namespace pt {

constexpr int K13_LANES = 128;    // lanes per block; blockIdx.y is the state
constexpr int K13_MAX_SEGS = 4;

// The stack: states [first[g], first[g + 1]) lie at base[g], rows[g]
// component rows apart; unused segments have first = the state count.
struct K13Segs {
  const int32_t* base[K13_MAX_SEGS];
  int first[K13_MAX_SEGS + 1];
  int rows[K13_MAX_SEGS];
};

// Column i of N p, the offset that keeps a0 b0 - a1 b1 non-negative in
// every column: column i of N p is at least the largest column i of a
// product of two values below 2^255 (digits 2^13 - 1 up to 18, 255 at 19,
// 0 at 20), N the least such multiple of p (tests/test_torch_slot_kernels.py
// derives it again). N p < 2^510, so a0 b0 - a1 b1 + N p < R p.
static __device__ __forceinline__ uint32_t kc_column(int i) {
  constexpr uint32_t d[2 * NL] = {
      67096489u,   134190186u,  201284689u,  268374982u,  335468669u,  402557971u,
      469654124u,  536741900u,  603840211u,  670930882u,  738018320u,  805112605u,
      872203310u,  939300851u,  1006392488u, 1073483083u, 1140576030u, 1207665237u,
      1274760930u, 1211842068u, 1144749587u, 1077657106u, 1010564625u, 943472144u,
      876379663u,  809287182u,  742194701u,  675102220u,  608009739u,  540917258u,
      473824777u,  406732296u,  339639815u,  272547334u,  205454853u,  138362372u,
      71269891u,   4177410u,    65025u,      0u,          0u,          0u};
  return d[i];
}

// a^2 = ((a0 + a1)(a0 - a1 + 2p), 2 a0 a1): field.cuh's fp2_sq on 32-bit
// columns, the same sums, the same digits.
static __device__ __forceinline__ Fp2 fp2_sq32(const Fp2& a) {
  Fp s, d, t;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    s.v[l] = a.c0.v[l] + a.c1.v[l];
    d.v[l] = a.c0.v[l] + KP[KP_2][l] - a.c1.v[l];
    t.v[l] = 2 * a.c0.v[l];
  }
  fp_carry(s);
  fp_carry(d);
  fp_carry(t);
  Fp2 r;
  Wide32 w;
  w32_zero(w);
  w32_mac(w, s, d);
  w32_reduce_imm(w, r.c0);
  w32_zero(w);
  w32_mac(w, t, a.c1);
  w32_reduce_imm(w, r.c1);
  return r;
}

// a b by Karatsuba on 32-bit columns, a at ``a`` (c0's row, c1's ``a_row``
// words on, digits ``a_n`` apart), b at ``b`` (rows NL bn words apart,
// digits bn apart; shared memory), both below 2p. Plain loads that carry
// (load_fp_rw): after the memory clobber they are made again, not kept in
// registers.
//
//   u = a0 b0, v = a1 b1, c0 = u - v + N p, c1 = (a0 + a1)(b0 + b1) - u - v.
//
// Column by column (a0 + a1)(b0 + b1) - u - v is a0 b1 + a1 b0 exactly, so
// its columns, summed modulo 2^32 from -(u + v), end below 42 (2^13 - 1)^2
// whatever the sums before; u - v + N p is non-negative in every column
// (kc_column). With the reduction's terms and one carry every column stays
// below 2^32 (the numpy model in tests/test_torch_slot_kernels.py checks
// both at the extreme digits). Three Fq products where field.cuh's fp2_mul
// takes four. The operands are read twice, for u and v and then for the
// sums a0 + a1 and b0 + b1, so that no more than u, v and two operands are
// live at once.
static __device__ __forceinline__ Fp2 fp2_mul_kara(const int32_t* a, size_t a_row, size_t a_n,
                                                   const int32_t* b, int bn) {
  const size_t b_row = (size_t)NL * bn;
  Fp x, y;
  Wide32 u, v;
  load_fp_rw(x, a, a_n);
  load_fp_rw(y, b, bn);
  w32_zero(u);
  w32_mac(u, x, y);
  load_fp_rw(x, a + a_row, a_n);
  load_fp_rw(y, b + b_row, bn);
  w32_zero(v);
  w32_mac(v, x, y);
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) {
    const uint32_t p0 = u.t[i], p1 = v.t[i];
    v.t[i] = p0 - p1 + kc_column(i);
    u.t[i] = 0u - p0 - p1;
  }
  Fp2 r;
  w32_reduce_imm(v, r.c0);
  asm volatile("" ::: "memory");
  Fp z;
  load_fp_rw(x, a, a_n);
  load_fp_rw(z, a + a_row, a_n);
  load_fp_rw(y, b, bn);
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] += z.v[l];
  load_fp_rw(z, b + b_row, bn);
#pragma unroll
  for (int l = 0; l < NL; ++l) y.v[l] += z.v[l];
  w32_mac(u, x, y);
  w32_reduce_imm(u, r.c1);
  return r;
}

__global__ void __launch_bounds__(K13_LANES, 3)
k_affine_export(const __grid_constant__ K13Segs segs, const int32_t* __restrict__ zinv,
                int32_t* __restrict__ out, int lanes) {
  // The right operand of each product, this thread's column: zi^2, then zi^3.
  __shared__ int32_t bsm[2 * NL * K13_LANES];
  const int lane = blockIdx.x * K13_LANES + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes, row = NL * n;
  const int s = blockIdx.y;
  int g = 0;
#pragma unroll
  for (int q = 1; q < K13_MAX_SEGS; ++q) g += s >= segs.first[q];
  const int32_t* xy = segs.base[g] + (size_t)(s - segs.first[g]) * segs.rows[g] * row + lane;
  const int32_t* zi = zinv + (size_t)s * 2 * row + lane;
  int32_t* dst = out + (size_t)s * 4 * row + lane;
  int32_t* b = bsm + threadIdx.x;
  Fp2 z;
  load_fp_rw(z.c0, zi, n);
  load_fp_rw(z.c1, zi + row, n);
  store_fp2(fp2_sq32(z), b, K13_LANES);
  // x = X zi^2, zi^3 = zi zi^2, y = Y zi^3
#pragma unroll 1
  for (int step = 0; step < 3; ++step) {
    const int32_t* src = step == 0 ? xy : step == 1 ? zi : xy + 2 * row;
    const Fp2 r = fp2_mul_kara(src, row, n, b, K13_LANES);
    if (step == 1)
      store_fp2(r, b, K13_LANES);
    else
      store_fp2(r, dst + (step == 0 ? 0 : 2 * row), n);
  }
}

}  // namespace pt

// ``segs``: n_segs rows of (device pointer, states, rows a state) in host
// memory, the states in stack order; their sum is n_states.
extern "C" int pt_affine_export(const int64_t* segs, int n_segs, const int32_t* zinv,
                                int n_states, int32_t* out, int lanes, void* stream) {
  if (n_segs < 1 || n_segs > pt::K13_MAX_SEGS) return (int)cudaErrorInvalidValue;
  pt::K13Segs s{};
  int first = 0;
  for (int g = 0; g < pt::K13_MAX_SEGS; ++g) {
    s.first[g] = first;
    if (g < n_segs) {
      s.base[g] = reinterpret_cast<const int32_t*>(segs[3 * g]);
      s.rows[g] = (int)segs[3 * g + 2];
      first += (int)segs[3 * g + 1];
    }
  }
  s.first[pt::K13_MAX_SEGS] = first;
  if (first != n_states) return (int)cudaErrorInvalidValue;
  if (lanes > 0 && n_states > 0) {
    const dim3 grid((lanes + pt::K13_LANES - 1) / pt::K13_LANES, n_states);
    pt::k_affine_export<<<grid, pt::K13_LANES, 0, (cudaStream_t)stream>>>(s, zinv, out, lanes);
  }
  return (int)cudaGetLastError();
}
