// Kernels K18 and K15: their design variants beside the one-thread-per-lane
// kernels they replaced, for tools/k1518_variants.py: the same square, the
// same chain. The library's sources are included, so the committed kernels
// are the ones timed here.
//
// K18:
// * k_sq_old: the kernel that csrc/fq12_sq.cu replaced: one thread per
//   lane, field.cuh's fq12_sq (84 Fq products on 64-bit columns), the
//   operand in local memory.
// * pt_fq12_sq: the committed entry, the block's 12 input rows staged once
//   in shared memory.
// * k_sq_l1: the same threads with every operand read from device memory
//   through L1 and carried at each use (l1_term.cuh), as kernel A reads; a
//   lane past the batch edge returns.
//
// K15:
// * k_chain_old: the kernel that csrc/hard_chain.cu replaced: one thread
//   per lane, field.cuh's fq12_mul and fq12_cyc_sq, the register file in a
//   global scratch [8, 12, 21, lanes], the program and the slot programs
//   read from device memory.
// * pt_hard_chain: the committed entry, registers 3-7 in shared memory.
// * k_chain_global: the committed block (hard_chain_block) with registers
//   3-7 in a global scratch of the shared file's layout, a tile of 161,280
//   B a block, read with plain loads through L1.
#include <cuda_runtime.h>

#include "fq12_sq.cu"
#include "hard_chain.cu"
#include "l1_term.cuh"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_sq_old(const int32_t* __restrict__ a, int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fq12 x, z;
  load_fq12(x, a + lane, n);
  fq12_sq(x, z);
  store_fq12(z, out + lane, n);
}

__global__ void __launch_bounds__(B_THREADS, 1)
k_sq_l1(const int32_t* __restrict__ a, int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * B_LANES + threadIdx.x;
  if (lane >= lanes) return;
  const int k = threadIdx.y;
  const size_t n = (size_t)lanes;
  const BSlot slot = SQ_SLOTS[k >> 1];
  Wide32 w;
  w32_zero(w);
#pragma unroll 1
  for (int j = 0; j < slot.count; ++j) {
    if (j) w32_fold(w);
    l1_term(w, a + lane, n, SQ_TERMS[slot.first + j], k & 1);
  }
  Fp r;
  w32_reduce_imm(w, r);
  store_fp(r, out + k * NL * n + lane, n);
}

__global__ void __launch_bounds__(BLOCK)
k_chain_old(const int32_t* __restrict__ m, const int32_t* __restrict__ mx,
            const int32_t* __restrict__ mx2, const int32_t* __restrict__ mx3,
            const int32_t* __restrict__ prog, int n_ops, const int32_t* __restrict__ slot_ops,
            const int32_t* __restrict__ slot_consts, int32_t* regs, int out_reg,
            int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  const size_t reg_words = 12 * NL * n;
  int32_t* file = regs + lane;
  const int32_t* const inputs[4] = {m, mx, mx2, mx3};
#pragma unroll 1
  for (int r = 0; r < 4; ++r) {
    const int32_t* src = inputs[r] + lane;
#pragma unroll 1
    for (int w = 0; w < 12 * NL; ++w) file[r * reg_words + w * n] = __ldg(src + w * n);
  }
  Fq12 x, y, z;
#pragma unroll 1
  for (int t = 0; t < n_ops; ++t) {
    const int op = __ldg(prog + 4 * t);
    int32_t* dst = file + __ldg(prog + 4 * t + 1) * reg_words;
    const int32_t* a = file + __ldg(prog + 4 * t + 2) * reg_words;
    if (op == OP_MUL) {
      load_fq12_rw(x, a, n);
      load_fq12_rw(y, file + __ldg(prog + 4 * t + 3) * reg_words, n);
      fq12_mul(x, y, DENSE, z);
      store_fq12(z, dst, n);
    } else if (op == OP_CYC) {
      load_fq12_rw(x, a, n);
      fq12_cyc_sq(x, z);
      store_fq12(z, dst, n);
    } else {
      const int32_t* ops = slot_ops + 6 * (op - OP_SLOT);
      const int32_t* consts = slot_consts + 6 * 2 * NL * (op - OP_SLOT);
#pragma unroll 1
      for (int i = 0; i < 6; ++i) {
        const int sop = __ldg(ops + i);
        Fp2 s;
        load_fp_rw(s.c0, a + 2 * i * NL * n, n);
        load_fp_rw(s.c1, a + (2 * i + 1) * NL * n, n);
        if (sop & 1) s.c0 = fp_neg(s.c0);
        if (sop & 2) s.c1 = fp_neg(s.c1);
        if (sop & 4) s = fp2_mul(s, load_fp2(consts + 2 * i * NL, 1));
        store_fp2(s, dst + 2 * i * NL * n, n);
      }
    }
  }
  load_fq12_rw(x, file + out_reg * reg_words, n);
  store_fq12(x, out + lane, n);
}

__global__ void __launch_bounds__(B_THREADS, 1)
k_chain_global(const int32_t* __restrict__ m, const int32_t* __restrict__ mx,
               const int32_t* __restrict__ mx2, const int32_t* __restrict__ mx3,
               const __grid_constant__ HCParams P, int out_reg, int32_t* __restrict__ out,
               uint32_t* file, int lanes) {
  hard_chain_block(m, mx, mx2, mx3, P, out_reg, out,
                   file + (size_t)blockIdx.x * HC_FILE * HC_REG_WORDS + threadIdx.x, lanes);
}

}  // namespace pt

// K18, ``reps`` launches back to back. kind: 0 the old kernel, 1 the
// committed entry, 2 every operand through L1.
extern "C" int h_sq(int kind, const int32_t* a, int32_t* out, int lanes, int reps,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int b32 = (lanes + pt::B_LANES - 1) / pt::B_LANES;
  for (int r = 0; r < reps; ++r) {
    switch (kind) {
      case 0:
        pt::k_sq_old<<<(lanes + pt::BLOCK - 1) / pt::BLOCK, pt::BLOCK, 0, st>>>(a, out, lanes);
        break;
      case 1: {
        const int err = pt_fq12_sq(a, out, lanes, stream);
        if (err != 0) return err;
        continue;
      }
      case 2: pt::k_sq_l1<<<b32, dim3(pt::B_LANES, pt::B_COMPS), 0, st>>>(a, out, lanes); break;
      default: return -1;
    }
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// K15, ``reps`` launches back to back. The program, the slot programs and
// ``out_reg`` as the library's entry takes them (host memory), and as the
// old kernel reads them (``dprog``, ``dslot_ops``, ``dslot_consts``: device
// memory). kind: 0 the old kernel (``scratch`` [8, 12, 21, lanes]), 1 the
// committed entry, 2 registers 3-7 in a global scratch (``scratch``: a
// 161,280 B tile a block).
extern "C" int h_chain(int kind, const int32_t* m, const int32_t* mx, const int32_t* mx2,
                       const int32_t* mx3, const int32_t* prog, int n_ops,
                       const int32_t* slot_ops, const int32_t* slot_consts,
                       const int32_t* dprog, const int32_t* dslot_ops,
                       const int32_t* dslot_consts, int out_reg, int32_t* scratch,
                       int32_t* out, int lanes, int reps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  pt::HCParams P;
  if (!pt::hard_chain_params(prog, n_ops, slot_ops, slot_consts, out_reg, P))
    return (int)cudaErrorInvalidValue;
  const int b32 = (lanes + pt::B_LANES - 1) / pt::B_LANES;
  for (int r = 0; r < reps; ++r) {
    switch (kind) {
      case 0:
        pt::k_chain_old<<<(lanes + pt::BLOCK - 1) / pt::BLOCK, pt::BLOCK, 0, st>>>(
            m, mx, mx2, mx3, dprog, n_ops, dslot_ops, dslot_consts, scratch, out_reg, out,
            lanes);
        break;
      case 1: {
        const int err = pt_hard_chain(m, mx, mx2, mx3, prog, n_ops, slot_ops, slot_consts,
                                      out_reg, out, lanes, stream);
        if (err != 0) return err;
        continue;
      }
      case 2:
        pt::k_chain_global<<<b32, dim3(pt::B_LANES, pt::B_COMPS), 0, st>>>(
            m, mx, mx2, mx3, P, out_reg, out, (uint32_t*)scratch, lanes);
        break;
      default: return -1;
    }
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  return 0;
}

// Words of the global variant's scratch: a file of HC_FILE registers a block.
extern "C" long long h_chain_global_words(int lanes) {
  return (long long)((lanes + pt::B_LANES - 1) / pt::B_LANES) * pt::HC_FILE *
         pt::HC_REG_WORDS;
}
