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
// Inputs: xy [S, 4, 21, lanes] (X.c0, X.c1, Y.c0, Y.c1 of each Jacobian
// state) and zinv [S, 2, 21, lanes] (1 / Z from the Phase N passes); output
// [S, 4, 21, lanes] (x.c0, x.c1, y.c0, y.c1). One thread per (state, lane):
// blockIdx.y is the state, so S x lanes threads in all.
//
// Bound on the H100: integer multiply-adds. One Fq2 square and three Fq2
// products need at least about 8.5 k 32-bit IMADs per state and lane (the
// least count in chip_smoke.py; this kernel issues about 20 k), against 504
// bytes read and 336 written: above the card's op-per-byte line.
#include <cuda_runtime.h>

#include "field.cuh"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_affine_export(const int32_t* __restrict__ xy, const int32_t* __restrict__ zinv,
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

}  // namespace pt

extern "C" int pt_affine_export(const int32_t* xy, const int32_t* zinv, int n_states,
                                int32_t* out, int lanes, void* stream) {
  if (lanes > 0 && n_states > 0) {
    const dim3 grid((lanes + pt::BLOCK - 1) / pt::BLOCK, n_states);
    pt::k_affine_export<<<grid, pt::BLOCK, 0, (cudaStream_t)stream>>>(xy, zinv, out, lanes);
  }
  return (int)cudaGetLastError();
}
