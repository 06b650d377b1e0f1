// Kernel K18: dense Fq12 square, out = a^2, on KF12 tensors [12, 21, lanes].
//
// Replaces pairing_tpu/ops/fq12_kernels.py:_pallas_sq (pallas_call at :290,
// core _sq_core_v3), reached through klayout.ksq; here also the square of
// final_exp.fq12_pow, whose operands need not lie in the cyclotomic subgroup.
//
// Bound on the H100: integer multiply-adds. The square needs at least 36 Fq
// products (two-level Karatsuba, as _sq_core_v3 has it) and 12 reductions,
// about 21 k 32-bit IMADs per lane (the least count in chip_smoke.py); this
// kernel issues 84 schoolbook Fq products (field.cuh:fq12_sq, the 21
// unordered slot pairs) of 441 IMAD.WIDE each, against 1008 bytes read and
// 1008 written per lane. One thread per lane, operands in local memory.
#include <cuda_runtime.h>

#include "field.cuh"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_fq12_sq(const int32_t* __restrict__ a, int32_t* __restrict__ out, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  Fq12 x, z;
  load_fq12(x, a + lane, n);
  fq12_sq(x, z);
  store_fq12(z, out + lane, n);
}

}  // namespace pt

extern "C" int pt_fq12_sq(const int32_t* a, int32_t* out, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
    pt::k_fq12_sq<<<blocks, pt::BLOCK, 0, (cudaStream_t)stream>>>(a, out, lanes);
  }
  return (int)cudaGetLastError();
}
