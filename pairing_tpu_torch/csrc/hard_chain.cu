// Kernel K15: the whole hard-part chain of the final exponentiation in one
// launch, given m and its three x-powers mx, mx2, mx3 (final_exp_native.rs
// :130-169 with the x-powers precomputed).
//
// Replaces pairing_tpu/ops/fused_kernels.py:hard_chain_pallas (pallas_call
// at :953, body _chain_kernel :824), which final_exp.hard_part_chain_k runs
// when PAIRING_FUSED_CHAIN is set. As there, the kernel interprets a register
// program: ``prog`` [n_ops, 4] rows (op, dst, a, b) over an Fq12 register
// file whose registers 0..3 start as m, mx, mx2, mx3 (fused_kernels.py
// HARD_CHAIN_PROG: 13 products, 4 cyclotomic squares, 5 conjugates,
// 7 Frobenius maps). Opcodes:
//
//   0 MUL   regs[dst] = regs[a] * regs[b]         (dense, field.cuh:fq12_mul)
//   1 CYC   regs[dst] = regs[a]^2                 (Granger-Scott)
//   2..5    regs[dst] = slot map (op - 2) of regs[a]: the conjugate, then
//           frobenius_map 1, 2, 3, as kernel E's per-slot programs
//           ``slot_ops`` [4, 6] and ``slot_consts`` [4, 6, 2, 21].
//
// The op is the same in every lane, so each dispatch is a uniform branch.
// The register file (8 x 1008 bytes per lane) does not fit the register
// file of the SM: it lives in the global scratch ``regs`` [n_regs, 12, 21,
// lanes], batch last, so that a warp's loads of one word coalesce; each
// operation loads its operands into local memory and stores its result.
// Slot maps go slot by slot, so dst may alias a.
//
// Bound on the H100: integer multiply-adds. 13 dense products, 4 cyclotomic
// squares and the Frobenius maps' 35 Fq2 products by constants per lane,
// about 0.51 ms at 16384 lanes (the least count in chip_smoke.py), against
// 4 x 1008 bytes read and 1008 written per lane (the scratch not counted).
#include <cuda_runtime.h>

#include "field.cuh"

namespace pt {

enum { OP_MUL = 0, OP_CYC = 1, OP_SLOT = 2 };

__global__ void __launch_bounds__(BLOCK)
k_hard_chain(const int32_t* __restrict__ m, const int32_t* __restrict__ mx,
             const int32_t* __restrict__ mx2, const int32_t* __restrict__ mx3,
             const int32_t* __restrict__ prog, int n_ops,
             const int32_t* __restrict__ slot_ops, const int32_t* __restrict__ slot_consts,
             int32_t* regs, int out_reg, int32_t* __restrict__ out, int lanes) {
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

}  // namespace pt

extern "C" int pt_hard_chain(const int32_t* m, const int32_t* mx, const int32_t* mx2,
                             const int32_t* mx3, const int32_t* prog, int n_ops,
                             const int32_t* slot_ops, const int32_t* slot_consts, int32_t* regs,
                             int out_reg, int32_t* out, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
    pt::k_hard_chain<<<blocks, pt::BLOCK, 0, (cudaStream_t)stream>>>(
        m, mx, mx2, mx3, prog, n_ops, slot_ops, slot_consts, regs, out_reg, out, lanes);
  }
  return (int)cudaGetLastError();
}
