// Design variants of kernels E (conjugate and Frobenius) and K13 (affine
// export) beside the one-thread-per-lane kernels they replaced, for
// tools/ek13_variants.py. The library's sources are included, so the
// committed kernels and their routines are the ones built here.
//
// E:
// * k_e_old: the one-thread-per-lane kernel that csrc/slotwise.cu replaced
//   (per slot: negations, then field.cuh's fp2_mul by the constant, 64-bit
//   columns; the program and constants in device memory).
// * pt_fq12_slotwise: the committed entry (one thread per (output
//   component, lane), a block 128 lanes of one component).
// * k_e_mixed: the same threads, a block 32 lanes x 12 components
//   (threadIdx.y the component, as kernels A and B), so both components of
//   a slot read its rows in one block.
//
// K13:
// * k_k13_old: the one-thread-per-(state, lane) kernel that
//   csrc/affine_export.cu replaced (field.cuh's fp2_sq and fp2_mul).
// * pt_affine_export: the committed entry (one thread per (state, lane),
//   the right operand of each Karatsuba product in shared memory).
// * k_k13_reg: the same thread with the right operand in registers, the
//   left one loaded once.
// * k_k13_pair: two threads per (state, lane), threadIdx.y the rank, 64
//   lanes a block: rank 0 squares zi and computes x = X zi^2, rank 1
//   computes t = Y zi and then y = t zi^2, zi^2 from rank 0's column of
//   shared memory after one __syncthreads.
#include "slotwise.cu"
#include "affine_export.cu"

namespace pt {

// ---------------------------------------------------------------------------
// E
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK)
k_e_old(const int32_t* __restrict__ a, const int32_t* __restrict__ prog,
        const int32_t* __restrict__ consts, int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
#pragma unroll 1
  for (int i = 0; i < 6; ++i) {
    const int op = __ldg(prog + i);
    Fp2 x = load_fp2(a + 2 * i * NL * n + lane, n);
    if (op & 1) x.c0 = fp_neg(x.c0);
    if (op & 2) x.c1 = fp_neg(x.c1);
    if (op & 4) x = fp2_mul(x, load_fp2(consts + 2 * i * NL, 1));
    store_fp2(x, out + 2 * i * NL * n + lane, n);
  }
}

constexpr int E_MIXED_LANES = 32;

__global__ void __launch_bounds__(E_MIXED_LANES * 12, 1)
k_e_mixed(const int32_t* __restrict__ a, const __grid_constant__ ETable tab,
          int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * E_MIXED_LANES + threadIdx.x;
  if (lane >= lanes) return;
  slot_component(a + lane, tab, threadIdx.y, (size_t)lanes, out + lane);
}

// ---------------------------------------------------------------------------
// K13
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(BLOCK)
k_k13_old(const int32_t* __restrict__ xy, const int32_t* __restrict__ zinv,
          int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  const size_t s = blockIdx.y;
  const int32_t* src = xy + s * 4 * NL * n + lane;
  int32_t* dst = out + s * 4 * NL * n + lane;
  const Fp2 zi = load_fp2(zinv + s * 2 * NL * n + lane, n);
  const Fp2 zi2 = fp2_sq(zi);
  const Fp2 zi3 = fp2_mul(zi2, zi);
  store_fp2(fp2_mul(load_fp2(src, n), zi2), dst, n);
  store_fp2(fp2_mul(load_fp2(src + 2 * NL * n, n), zi3), dst + 2 * NL * n, n);
}

// fp2_mul_kara with b in registers and a loaded once.
static __device__ __forceinline__ Fp2 fp2_mul_kara_reg(const int32_t* a, size_t row, size_t n,
                                                       const Fp2& b) {
  Fp x0, x1;
  load_fp_rw(x0, a, n);
  load_fp_rw(x1, a + row, n);
  Wide32 u, v;
  w32_zero(u);
  w32_mac(u, x0, b.c0);
  w32_zero(v);
  w32_mac(v, x1, b.c1);
#pragma unroll
  for (int i = 0; i < 2 * NL; ++i) {
    const uint32_t p0 = u.t[i], p1 = v.t[i];
    v.t[i] = p0 - p1 + kc_column(i);
    u.t[i] = 0u - p0 - p1;
  }
  Fp2 r;
  w32_reduce_imm(v, r.c0);
  Fp t;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    x0.v[l] += x1.v[l];
    t.v[l] = b.c0.v[l] + b.c1.v[l];
  }
  w32_mac(u, x0, t);
  w32_reduce_imm(u, r.c1);
  return r;
}

// One segment: xy [S, 4, 21, lanes] (the tool times the single-tensor form).
__global__ void __launch_bounds__(K13_LANES, 3)
k_k13_reg(const int32_t* __restrict__ xy_all, const int32_t* __restrict__ zinv,
          int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * K13_LANES + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes, row = NL * n, s = blockIdx.y;
  const int32_t* xy = xy_all + s * 4 * row + lane;
  const int32_t* zi = zinv + s * 2 * row + lane;
  int32_t* dst = out + s * 4 * row + lane;
  Fp2 b;
  load_fp_rw(b.c0, zi, n);
  load_fp_rw(b.c1, zi + row, n);
  b = fp2_sq32(b);
#pragma unroll 1
  for (int step = 0; step < 3; ++step) {
    const int32_t* src = step == 0 ? xy : step == 1 ? zi : xy + 2 * row;
    const Fp2 r = fp2_mul_kara_reg(src, row, n, b);
    if (step == 1)
      b = r;
    else
      store_fp2(r, dst + (step == 0 ? 0 : 2 * row), n);
  }
}

constexpr int K13_PAIR_LANES = 64;

// No __restrict__ here: a left operand is a select between device and
// shared memory, read with generic loads.
__global__ void __launch_bounds__(K13_PAIR_LANES * 2, 3)
k_k13_pair(const int32_t* xy_all, const int32_t* zinv, int32_t* out, int lanes) {
  // [rank][2 components][NL][lanes]: rank 0's column zi^2, rank 1's zi then t
  __shared__ int32_t bsm[2 * 2 * NL * K13_PAIR_LANES];
  const int rank = threadIdx.y;
  const int lane = blockIdx.x * K13_PAIR_LANES + threadIdx.x;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes, row = NL * n, s = blockIdx.y;
  const size_t col = live ? (size_t)lane : n - 1;
  const int32_t* xy = xy_all + s * 4 * row + col;
  const int32_t* zi = zinv + s * 2 * row + col;
  const int32_t* zi2 = bsm + threadIdx.x;
  int32_t* mine = bsm + rank * 2 * NL * K13_PAIR_LANES + threadIdx.x;
  Fp2 z;
  load_fp_rw(z.c0, zi, n);
  load_fp_rw(z.c1, zi + row, n);
  store_fp2(rank == 0 ? fp2_sq32(z) : z, mine, K13_PAIR_LANES);
#pragma unroll 1
  for (int step = 0; step < 2; ++step) {
    if (step == 1) __syncthreads();
    if (step == 0 && rank == 0) continue;
    const int32_t* src = step == 0 ? xy + 2 * row : rank == 0 ? xy : zi2;
    const size_t srow = step == 1 && rank == 1 ? (size_t)NL * K13_PAIR_LANES : row;
    const size_t sn = step == 1 && rank == 1 ? (size_t)K13_PAIR_LANES : n;
    const Fp2 r = fp2_mul_kara(src, srow, sn, mine, K13_PAIR_LANES);
    if (step == 0)
      store_fp2(r, mine, K13_PAIR_LANES);
    else if (live)
      store_fp2(r, out + s * 4 * row + lane + rank * 2 * row, n);
  }
}

}  // namespace pt

// kind: 0 the old kernel (``prog`` and ``consts`` in device memory), 1 the
// committed entry, 2 blocks of 32 lanes x 12 components (``prog`` and
// ``consts`` in host memory for 1 and 2). ``reps`` launches back to back,
// so that a timing sees the card and not the host's calls.
static int slot_once(int kind, const int32_t* a, const int32_t* prog, const int32_t* consts,
                     int32_t* out, int lanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0:
      pt::k_e_old<<<(lanes + pt::BLOCK - 1) / pt::BLOCK, pt::BLOCK, 0, st>>>(a, prog, consts,
                                                                            out, lanes);
      break;
    case 1: return pt_fq12_slotwise(a, prog, consts, out, lanes, stream);
    case 2: {
      pt::ETable tab;
      if (!pt::fold_program(prog, consts, tab)) return (int)cudaErrorInvalidValue;
      const int blocks = (lanes + pt::E_MIXED_LANES - 1) / pt::E_MIXED_LANES;
      pt::k_e_mixed<<<blocks, dim3(pt::E_MIXED_LANES, 12), 0, st>>>(a, tab, out, lanes);
      break;
    }
    default: return -1;
  }
  return (int)cudaGetLastError();
}

extern "C" int h_slot(int kind, const int32_t* a, const int32_t* prog, const int32_t* consts,
                      int32_t* out, int lanes, int reps, void* stream) {
  for (int r = 0; r < reps; ++r) {
    const int err = slot_once(kind, a, prog, consts, out, lanes, stream);
    if (err != 0) return err;
  }
  return 0;
}

// kind: 0 the old kernel, 1 the committed entry (one segment), 2 the right
// operand in registers, 3 two threads per (state, lane). xy [S, 4, 21,
// lanes], zinv [S, 2, 21, lanes].
extern "C" int h_k13(int kind, const int32_t* xy, const int32_t* zinv, int n_states,
                     int32_t* out, int lanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid128((lanes + pt::K13_LANES - 1) / pt::K13_LANES, n_states);
  switch (kind) {
    case 0:
      pt::k_k13_old<<<dim3((lanes + pt::BLOCK - 1) / pt::BLOCK, n_states), pt::BLOCK, 0, st>>>(
          xy, zinv, out, lanes);
      break;
    case 1: {
      const int64_t seg[3] = {(int64_t)xy, n_states, 4};
      return pt_affine_export(seg, 1, zinv, n_states, out, lanes, stream);
    }
    case 2: pt::k_k13_reg<<<grid128, pt::K13_LANES, 0, st>>>(xy, zinv, out, lanes); break;
    case 3: {
      const dim3 grid((lanes + pt::K13_PAIR_LANES - 1) / pt::K13_PAIR_LANES, n_states);
      pt::k_k13_pair<<<grid, dim3(pt::K13_PAIR_LANES, 2), 0, st>>>(xy, zinv, out, lanes);
      break;
    }
    default: return -1;
  }
  return (int)cudaGetLastError();
}
