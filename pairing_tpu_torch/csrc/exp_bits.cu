// Kernel K12: the witness bit ladder, x^e for MSB-first bits shared by every
// lane, with every ladder row written out.
//
// Replaces pairing_tpu/ops/fused_kernels.py:_exp_bits_impl (pallas_call at
// :702, body _exp_bits_kernel :635), entry exp_bits_ladder_pallas. The C12
// exp-offload AIR (final_exp_target.rs:89-147) constrains the plain bit
// ladder, not the windowed NAF ladder of kernel D:
//
//   row_{-1} = 1;  row_s = row_{s-1}^2 * x^{b_s}  (s = 0..n-1);  rows[s] = row_s.
//
// Squares are Granger-Scott cyclotomic squares, equal to the dense square
// only on the cyclotomic subgroup: the ladder runs on easy-part outputs. The
// TPU walked the bits as a sequential grid axis with the row in VMEM
// scratch; here one thread per lane runs the whole ladder with x, the row
// and one temporary in local memory, and the bit is uniform across the warp,
// so the multiply branch does not diverge.
//
// Bound on the H100: integer multiply-adds. 64 cyclotomic squares and one
// dense product per set bit need at least about 1.7 M 32-bit IMADs per lane
// for BN_X (the least count in chip_smoke.py); this kernel issues about 6 M.
// Against that, 1008 bytes are read and 64 x 1008 bytes written per lane.
#include <cuda_runtime.h>

#include "field.cuh"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_exp_bits(const int32_t* __restrict__ x_src, const int32_t* __restrict__ bits, int n_bits,
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

}  // namespace pt

extern "C" int pt_exp_bits(const int32_t* x, const int32_t* bits, int n_bits, int32_t* rows,
                           int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
    pt::k_exp_bits<<<blocks, pt::BLOCK, 0, (cudaStream_t)stream>>>(x, bits, n_bits, rows,
                                                                  lanes);
  }
  return (int)cudaGetLastError();
}
