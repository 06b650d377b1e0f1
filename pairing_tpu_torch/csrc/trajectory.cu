// Kernel H: the Miller loop's point trajectory (Phase B) in Jacobian
// coordinates over Fq2.
//
// Replaces pairing_tpu/ops/curve_kernels.py:trajectory_pallas (pallas_call
// at :214, body _traj_kernel). Per NAF step t the running point R is
// emitted as the loop top, doubled (dbl-2009-l, a = 0), the double emitted,
// and on a nonzero digit d the affine Q or -Q is added (madd-2007-bl):
//
//   tops[t] = R;  dbls[t] = 2R;  R = d ? 2R + sign(d) Q : 2R;  end = R.
//
// On the TPU the step axis was a sequential grid axis with R in a VMEM
// register file, and the step's Fq2 arithmetic ran on the fq2_vm
// instruction interpreter to keep the kernel IR small.
//
// The end-only mode (k_trajectory<false>; pt_trajectory with tops and dbls
// null) runs the same ladder for any digit string and stores only end: the
// G2 subgroup check's [6x^2] Q over the 127 digits of get_naf(6 x^2), whose
// tops and post-doubles (2 x 127 states a lane, about 2.1 GB at 16384
// lanes) nobody reads. The template flag removes the stores at compile
// time; the main path's instantiation k_trajectory<true> is the kernel as
// it was.
//
// Bound on the H100: integer multiply-adds, 5 Fq2 squares and 2 products a
// doubling, 4 and 7 an addition (about 1.41 ms for 16384 lanes over the 64
// steps of the Miller loop), against 2 x 1008 bytes written per step and
// lane (about 0.32 ms). The step loop is serial within a lane: each step
// needs the one before. One thread per lane left a 16384-lane batch at 512
// warps, four per SM, one per scheduler, with nothing to hide the latency
// of the dependent multiply-add chains, and its Jacobian states in local
// memory.
//
// Design: two threads per lane, rank h = 0, 1 computes component h of every
// Fq2 value of the step. A component of an Fq2 product is two Fq products
// into one accumulator and one Montgomery reduction (fp2_mul), of an Fq2
// square one product (fp2_sq), and every linear operation (add, sub, small
// multiple, negation) works one component at a time. So each rank does
// exactly half of each step and the lane's chain is half as long. A warp
// holds 16 lanes: threads 0-15 are rank 0 of lanes 0-15, threads 16-31
// rank 1 of the same lanes, so a component row of 16 neighbouring lanes is
// one 64-byte store. 16384 lanes make 1,024 warps, one round of 8 warps
// per SM (2 per scheduler) at up to 255 registers.
//
// The lane's live Fq2 values (two Jacobian states, four temporaries) live
// in shared memory, both components, laid out [slot][comp][limb][16 lanes]
// per warp: 1,680 bytes a lane, 107,520 bytes a 64-lane block, two blocks
// an SM. The two components of a limb are 336 words apart, 16 banks, so
// the 32 threads of a warp hit 32 banks. A rank keeps in registers only its
// accumulator, the operand pair of its current product and the values of
// the current stage. The accumulator's columns are 32-bit: with 13-bit
// digits an Fq2 component's column sum, reduction included, stays below
// 2^32, so each limb product is one 32-bit multiply-add where field.cuh
// issues a 64-bit one (IMAD.WIDE), at half the registers (field32.cuh,
// shared with kernel K).
//
// Each stage writes the components that the next stage reads whole; a
// __syncwarp follows, and every thread reaches every barrier: a lane past
// the batch edge computes on the last lane's data and stores nothing. Both
// ranks run the same instructions: operands are selected limb by limb,
// never by a branch on the rank. The digit is the same in every lane, so
// its branch is uniform.
//
// The slot arithmetic and the mixed addition live in trajectory.cuh, which
// the Miller loop's epilogue points (miller_epilogue.cu) share; the doubling
// is H's alone.
//
// The operations, their operands' order and every reduction are those of
// field.cuh's fp2_mul / fp2_sq / fp_add / fp_sub / fp_small / fp_neg in the
// one-thread kernel this replaces, and each computes the same integers, so
// the digits of every output are those it wrote.
#include <cuda_runtime.h>

#include "trajectory.cuh"

namespace pt {

constexpr int H_WARPS = 4;                      // warps per block
constexpr int H_THREADS = 32 * H_WARPS;
constexpr int H_BLOCK_LANES = H_LANES * H_WARPS;
// Slots per lane: the states R (0-2) and S (3-5), X, Y, Z each, and four
// temporaries.
constexpr int H_SLOTS = 10;
constexpr int H_WARP_WORDS = H_SLOTS * H_SLOT;
constexpr size_t H_SMEM = (size_t)H_WARPS * H_WARP_WORDS * sizeof(uint32_t);

// jac_double: state p (slots px, py, pz) into state r; t0..t3 temporaries.
static __device__ __forceinline__ void lane_double(const uint32_t* p, uint32_t* r, uint32_t* t,
                                                   int h) {
  const uint32_t *X = p, *Y = p + H_SLOT, *Z = p + 2 * H_SLOT;
  uint32_t *rX = r, *rY = r + H_SLOT, *rZ = r + 2 * H_SLOT;
  uint32_t *tB = t, *tE = t + H_SLOT, *tC = t + 2 * H_SLOT, *tW = t + 3 * H_SLOT;
  // stage 1: A = X^2 (kept in rX's own component), E = 3A, B = Y^2,
  // Z3 = 2 Y Z
  {
    const Fp A = sq_part(X, h);
    st(A, rX, h);
    st(small<3>(A), tE, h);
  }
  st(sq_part(Y, h), tB, h);
  st(small<2>(mul_part(Y, Z, h)), rZ, h);
  __syncwarp();
  // stage 2: C = B^2 (kept), D = 2((X + B)^2 - A - C) (kept in rY),
  // X3 = E^2 - 2D, W = D - X3
  {
    const Fp C = sq_part(tB, h);
    st(C, tC, h);
    Fp A;
    ld(A, rX, h);
    const Fp D = small<2>(fp_sub(fp_sub(sq_sum_part(X, tB, h), A), C));
    st(D, rY, h);
  }
  {
    const Fp F = sq_part(tE, h);
    Fp D;
    ld(D, rY, h);
    const Fp X3 = fp_sub(F, small<2>(D));
    st(X3, rX, h);
    st(fp_sub(D, X3), tW, h);
  }
  __syncwarp();
  // stage 3: Y3 = E W - 8C
  {
    const Fp m = mul_part(tE, tW, h);
    Fp C;
    ld(C, tC, h);
    st(fp_sub(m, small<8>(C)), rY, h);
  }
  __syncwarp();
}

// kStore: every loop top and post-double is stored (the Miller loop's
// trajectory); without it only the end state is (the G2 subgroup check's
// ladder), and tops and dbls are not read.
template <bool kStore>
__global__ void __launch_bounds__(H_THREADS, 2)
k_trajectory(const int32_t* __restrict__ q, const int32_t* __restrict__ digits, int n_steps,
             int32_t* __restrict__ tops, int32_t* __restrict__ dbls,
             int32_t* __restrict__ end, int lanes) {
  extern __shared__ uint32_t traj_smem[];
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;
  const int g = t32 & (H_LANES - 1), h = t32 >> 4;
  const int lane = (blockIdx.x * H_WARPS + warp) * H_LANES + g;
  // A lane past the batch edge works on the last lane's data, reaches every
  // barrier with its partner and stores nothing.
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  const size_t state_words = 6 * NL * n;
  uint32_t* base = traj_smem + warp * H_WARP_WORDS + g;
  uint32_t* cur = base;                 // R
  uint32_t* nxt = base + 3 * H_SLOT;    // 2R
  uint32_t* tmp = base + 6 * H_SLOT;
  const int32_t* qc = q + col;
  {
    Fp x;
    load_fp(x, qc + h * NL * n, n);
    st(x, cur, h);
    load_fp(x, qc + (2 + h) * NL * n, n);
    st(x, cur + H_SLOT, h);
#pragma unroll
    for (int l = 0; l < NL; ++l) x.v[l] = h ? 0u : KP[KP_ONE][l];
    st(x, cur + 2 * H_SLOT, h);
  }
  __syncwarp();
#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    if (kStore && live) store_state(cur, tops + t * state_words + lane, n, h);
    lane_double(cur, nxt, tmp, h);
    if (kStore && live) store_state(nxt, dbls + t * state_words + lane, n, h);
    const int d = __ldg(digits + t);
    if (d != 0) {
      lane_mixed_add(nxt, QRows{qc, n}, d < 0, cur, tmp, h);
    } else {
      uint32_t* s = cur;
      cur = nxt;
      nxt = s;
    }
  }
  if (live) store_state(cur, end + lane, n, h);
}

// Both instantiations ask for the same dynamic shared memory; the attribute
// is set on the device that is current at the launch.
template <bool kStore>
static int launch_trajectory(const int32_t* q, const int32_t* digits, int n_steps, int32_t* tops,
                             int32_t* dbls, int32_t* end, int lanes, void* stream) {
  if (lanes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        k_trajectory<kStore>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)H_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (lanes + H_BLOCK_LANES - 1) / H_BLOCK_LANES;
    k_trajectory<kStore><<<blocks, H_THREADS, H_SMEM, (cudaStream_t)stream>>>(
        q, digits, n_steps, tops, dbls, end, lanes);
  }
  return (int)cudaGetLastError();
}

}  // namespace pt

// tops and dbls both null select the end-only mode: only ``end`` [6, 21,
// lanes] is written. One of them null alone is refused.
extern "C" int pt_trajectory(const int32_t* q, const int32_t* digits, int n_steps, int32_t* tops,
                             int32_t* dbls, int32_t* end, int lanes, void* stream) {
  if ((tops == nullptr) != (dbls == nullptr)) return (int)cudaErrorInvalidValue;
  if (tops == nullptr)
    return pt::launch_trajectory<false>(q, digits, n_steps, nullptr, nullptr, end, lanes, stream);
  return pt::launch_trajectory<true>(q, digits, n_steps, tops, dbls, end, lanes, stream);
}

// The dynamic shared memory a block of k_trajectory asks for at launch
// (ptxas reports static shared memory only).
extern "C" int pt_trajectory_shared_bytes() { return (int)pt::H_SMEM; }
