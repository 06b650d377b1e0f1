// Kernel K15: the whole hard-part chain of the final exponentiation in one
// launch, given m and its three x-powers mx, mx2, mx3 (final_exp_native.rs
// :130-169 with the x-powers precomputed).
//
// Replaces pairing_tpu/ops/fused_kernels.py:hard_chain_pallas (pallas_call
// at :953, body _chain_kernel :824), which final_exp.hard_part_chain_k runs
// when PAIRING_FUSED_CHAIN is set. As there, the kernel interprets a register
// program: rows (op, dst, a, b) over an Fq12 register file whose registers
// 0..3 start as m, mx, mx2, mx3 and 4..7 as zero (fused_kernels.py
// HARD_CHAIN_PROG: 13 products, 4 cyclotomic squares, 5 conjugates,
// 7 Frobenius maps). Opcodes:
//
//   0 MUL   regs[dst] = regs[a] * regs[b]         (dense)
//   1 CYC   regs[dst] = regs[a]^2                 (Granger-Scott)
//   2..5    regs[dst] = slot map (op - 2) of regs[a]: the conjugate, then
//           frobenius_map 1, 2, 3, as kernel E's slot programs.
//
// Bound on the H100: integer multiply-adds. 13 dense products, 4 cyclotomic
// squares and the Frobenius maps' 35 Fq2 products by constants per lane,
// about 0.50 ms at 16384 lanes (the least count in chip_smoke.py), against
// 4 x 1008 bytes read and 1008 written per lane. The first port ran it one
// thread per lane with field.cuh's Fq12 routines and the register file in a
// global scratch [8, 12, 21, lanes] (255 registers, 5,760 B of stack, 1,584
// B spilled), slower than the 29 launches of A, B and E it replaces.
//
// Design: the 29 launches' threads in one launch. A block is kernel A's and
// B's, 32 lanes x 12 output components (threadIdx.x the lane, threadIdx.y
// the component k), and runs the whole program for its 32 lanes. Every
// operation computes, in each thread, output component k of the lane from
// the operands' rows, and stores it after a barrier; the op is the same in
// the whole block, so every dispatch is a uniform branch. Bodies, one call
// site each, their loops not unrolled (kernel K ran at half speed with its
// routines inlined whole):
//
//   MUL    kernel A's term loop (fq12_mul.cu: a_i b_j, xi a_i where i > s,
//          one fold between terms, one reduction) on the registers' rows;
//   CYC    kernel B's cyc_component (fq12_terms.cuh) on a shared register;
//   slot   kernel E's component (slotwise.cu) over the four programs,
//          folded on the host into ETables (slot_table.cuh) that travel in
//          the kernel's parameter (8,256 B: above the classic 4 KB, within
//          the 32,764 B that CUDA 12.1 and later allow on sm_70 and up).
//
// Register file: registers 0-2 (m, mx, mx2) are only read, in place from
// the inputs, carried at each load. The program writes only registers 3-7;
// they live in dynamic shared memory, a register 12 rows of 21 limbs x 32
// lanes (32,256 B), 161,280 B a block: one block an SM, 12 warps, as kernel
// A. r3 starts as mx3, staged and carried, r4-r7 as zero. An operand row is
// read through a generic pointer (``Rows``: the input in device memory or
// the shared register), so one body serves both.
//
// Barriers: an operation's component is computed from the state before the
// operation, then stored. A block barrier follows every store; an operation
// whose destination is one of its sources (the chain's in-place conjugates)
// passes a second barrier between its reads and its store, so any aliasing
// is exact. A lane past the batch edge computes on the last lane's data,
// passes every barrier and stores nothing.
//
// The C entry refuses (cudaErrorInvalidValue) a program that writes
// registers 0-2, squares one of them (CYC reads shared rows only), names a
// register above 7 or an opcode above 5, or has more than HC_MAX_OPS
// operations; fused_kernels.check_chain_program mirrors it.
//
// Columns: every operand row holds digits below 2^13 and a value below 2p
// (the inputs are carried on load; A, B and E emit that), so A's, B's and
// E's 32-bit column bounds carry over unchanged (tests/test_torch_line_
// kernels.py, test_torch_cyc_kernels.py, test_torch_slot_kernels.py).
#include <cuda_runtime.h>

#include "fq12_terms.cuh"
#include "slot_table.cuh"

namespace pt {

enum { OP_MUL = 0, OP_CYC = 1, OP_SLOT = 2, OP_COUNT = 6 };
constexpr int HC_INPUTS = 3;                      // registers 0-2, read in place
constexpr int HC_REGS = 8;
constexpr int HC_FILE = HC_REGS - HC_INPUTS;      // registers 3-7, in the block's file
constexpr int HC_MAX_OPS = 64;
constexpr int HC_REG_WORDS = B_COMPS * B_ROW;     // one register of 32 lanes
constexpr int HC_SMEM = HC_FILE * HC_REG_WORDS * 4;  // 161,280 B

// The program and its slot maps, by value in the kernel's parameter.
struct HCParams {
  ETable slot[4];                // OP_SLOT + i: the conjugate, then p, p^2, p^3
  uint8_t op[HC_MAX_OPS][4];     // (op, dst, a, b)
  int n_ops;
};

// Register rows of one lane: ``p`` at component 0, limb 0; ``stride`` the
// words between limbs (a row is NL strides); ``carry`` for an input, whose
// limbs may be settled above 2^13.
struct Rows {
  const uint32_t* p;
  size_t stride;
  bool carry;
};

static __device__ __forceinline__ void load_reg_row(Fp& x, const Rows& r, int row) {
  const uint32_t* src = r.p + row * NL * r.stride;
#pragma unroll
  for (int l = 0; l < NL; ++l) x.v[l] = src[l * r.stride];
  if (r.carry) fp_carry(x);
}

// w += the Fq2 term of component ``comp``: left slot i of a (xi-folded when
// ``fold``), right slot j of b; kernel A's mac_term on register rows.
static __device__ __forceinline__ void mul_term(Wide32& w, const Rows& a, const Rows& b, int i,
                                                int j, bool fold, int comp) {
  Fp x0, x1;
  load_reg_row(x0, a, 2 * i);
  load_reg_row(x1, a, 2 * i + 1);
  if (fold) {  // fp2_mul_xi_wide
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      const uint32_t u0 = x0.v[l], u1 = x1.v[l];
      x0.v[l] = 9 * u0 + KP[KP_2][l] - u1;
      x1.v[l] = u0 + 9 * u1;
    }
    fp_carry(x0);
    fp_carry(x1);
  }
  Fp y;
  load_reg_row(y, b, 2 * j + comp);  // b0 for c0, b1 for c1
  w32_mac(w, x0, y);
  load_reg_row(y, b, 2 * j + 1 - comp);
  if (comp == 0) y = fp_neg(y);  // 2p - b1 for c0, b0 for c1
  w32_mac(w, x1, y);
}

// Component k of a * b (kernel A's k loop, every slot of b present).
static __device__ __forceinline__ Fp mul_component(int k, const Rows& a, const Rows& b) {
  const int s = k >> 1, comp = k & 1;
  Wide32 w;
  w32_zero(w);
#pragma unroll 1
  for (int i = 0; i < 6; ++i) {
    const bool fold = i > s;  // w^(i+j) with i + j >= 6 folds as xi
    if (i) w32_fold(w);
    mul_term(w, a, b, i, fold ? s - i + 6 : s - i, fold, comp);
  }
  Fp r;
  w32_reduce_imm(w, r);
  return r;
}

// Component k of a slot map of a (kernel E's slot_component, returned).
static __device__ __forceinline__ Fp slot_value(const Rows& a, const ETable& tab, int k) {
  const uint32_t mode = tab.mode[k];
  Fp x;
  if (!(mode & E_MUL)) {
    load_reg_row(x, a, k);
    return (mode & E_NEG) ? fp_neg(x) : x;
  }
  Wide32 w;
  w32_zero(w);
#pragma unroll 1
  for (int j = 0; j < 2; ++j) {
    if (!(mode & (E_T0 << j))) continue;
    load_reg_row(x, a, (k & ~1) + j);  // row 2i + j
    Fp g;
#pragma unroll
    for (int l = 0; l < NL; ++l) g.v[l] = tab.k[k][j][l];
    w32_mac(w, x, g);
  }
  Fp r;
  w32_reduce_imm(w, r);
  return r;
}

// The chain for the block's 32 lanes. ``file`` is this lane's word of
// register 3's row 0, limb 0, in a file of HC_FILE registers laid out as
// the block's shared rows: [register][component][limb][32 lanes]. The
// library's kernel keeps it in shared memory; tools/k1518_variants.cu also
// runs it on a global scratch of that layout, a tile a block.
static __device__ __forceinline__ void hard_chain_block(
    const int32_t* m, const int32_t* mx, const int32_t* mx2, const int32_t* mx3,
    const HCParams& P, int out_reg, int32_t* __restrict__ out, uint32_t* file, int lanes) {
  const int k = threadIdx.y;
  const int lane = blockIdx.x * B_LANES + threadIdx.x;
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  auto rows = [&](int r) -> Rows {  // a select, not an indexed array (local memory)
    if (r < HC_INPUTS)
      return {(const uint32_t*)(r == 0 ? m : r == 1 ? mx : mx2) + col, n, true};
    return {file + (r - HC_INPUTS) * HC_REG_WORDS, (size_t)B_LANES, false};
  };
  stage_row(file, mx3 + col, k, n);  // r3 = mx3
#pragma unroll 1
  for (int r = 1; r < HC_FILE; ++r) {  // r4..r7 = 0
    uint32_t* dst = file + r * HC_REG_WORDS + k * B_ROW;
#pragma unroll
    for (int l = 0; l < NL; ++l) dst[l * B_LANES] = 0;
  }
  __syncthreads();
#pragma unroll 1
  for (int t = 0; t < P.n_ops; ++t) {
    const int op = P.op[t][0], dst = P.op[t][1], a = P.op[t][2], b = P.op[t][3];
    Fp r;
    if (op == OP_MUL) {
      r = mul_component(k, rows(a), rows(b));
    } else if (op == OP_CYC) {
      r = cyc_component(k, file + (a - HC_INPUTS) * HC_REG_WORDS);
    } else {
      r = slot_value(rows(a), P.slot[op - OP_SLOT], k);
    }
    if (dst == a || (op == OP_MUL && dst == b)) __syncthreads();  // every read done
    uint32_t* row = file + (dst - HC_INPUTS) * HC_REG_WORDS + k * B_ROW;
#pragma unroll
    for (int l = 0; l < NL; ++l) row[l * B_LANES] = r.v[l];
    __syncthreads();
  }
  Fp x;
  load_reg_row(x, rows(out_reg), k);
  if (live) store_fp(x, out + k * NL * n + lane, n);
}

__global__ void __launch_bounds__(B_THREADS, 1)
k_hard_chain(const int32_t* __restrict__ m, const int32_t* __restrict__ mx,
             const int32_t* __restrict__ mx2, const int32_t* __restrict__ mx3,
             const __grid_constant__ HCParams P, int out_reg, int32_t* __restrict__ out,
             int lanes) {
  extern __shared__ uint32_t hc_file[];
  hard_chain_block(m, mx, mx2, mx3, P, out_reg, out, hc_file + threadIdx.x, lanes);
}

// The program's checks (see the header) and its slot maps folded into P.
// ``prog`` [n_ops, 4], ``slot_ops`` [4, 6] and ``slot_consts`` [4, 6, 2,
// 21] are host memory.
static bool hard_chain_params(const int32_t* prog, int n_ops, const int32_t* slot_ops,
                              const int32_t* slot_consts, int out_reg, HCParams& P) {
  if (n_ops < 0 || n_ops > HC_MAX_OPS || out_reg < 0 || out_reg >= HC_REGS) return false;
  for (int t = 0; t < n_ops; ++t) {
    const int32_t* row = prog + 4 * t;
    const int op = row[0], dst = row[1], a = row[2], b = row[3];
    if (op < 0 || op >= OP_COUNT || dst < HC_INPUTS || dst >= HC_REGS || a < 0 ||
        a >= HC_REGS || b < 0 || b >= HC_REGS || (op == OP_CYC && a < HC_INPUTS))
      return false;
    for (int c = 0; c < 4; ++c) P.op[t][c] = (uint8_t)row[c];
  }
  P.n_ops = n_ops;
  for (int i = 0; i < 4; ++i)
    if (!fold_program(slot_ops + 6 * i, slot_consts + 6 * 2 * NL * i, P.slot[i])) return false;
  return true;
}

}  // namespace pt

extern "C" int pt_hard_chain(const int32_t* m, const int32_t* mx, const int32_t* mx2,
                             const int32_t* mx3, const int32_t* prog, int n_ops,
                             const int32_t* slot_ops, const int32_t* slot_consts, int out_reg,
                             int32_t* out, int lanes, void* stream) {
  pt::HCParams P;
  if (!pt::hard_chain_params(prog, n_ops, slot_ops, slot_consts, out_reg, P))
    return (int)cudaErrorInvalidValue;
  if (lanes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        pt::k_hard_chain, cudaFuncAttributeMaxDynamicSharedMemorySize, pt::HC_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (lanes + pt::B_LANES - 1) / pt::B_LANES;
    pt::k_hard_chain<<<blocks, dim3(pt::B_LANES, pt::B_COMPS), pt::HC_SMEM,
                       (cudaStream_t)stream>>>(m, mx, mx2, mx3, P, out_reg, out, lanes);
  }
  return (int)cudaGetLastError();
}

extern "C" int pt_hard_chain_shared_bytes() { return pt::HC_SMEM; }
