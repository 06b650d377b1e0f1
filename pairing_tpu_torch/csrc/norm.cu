// Kernels I and J: the two passes of Montgomery's batch inversion over a
// stack of Fq2 values z [n, 2, 21, lanes] (Phase N, the bulk Jacobian to
// affine normalization of the Miller trajectory).
//
// Replaces pairing_tpu/ops/norm_kernels.py:prefix_products_pallas
// (pallas_call at :116, body _fwd_kernel) and running_inverse_pallas
// (pallas_call at :156, body _bwd_kernel):
//
//   forward:  prefix[i] = z[0] ... z[i-1] (prefix[0] = 1), total = prefix[n];
//   backward: given tinv = 1 / total, from i = n-1 down:
//             zinv[i] = c * prefix[i], c <- c * z[i]   (c starts at tinv).
//
// The TPU walked the stack as a sequential grid axis with the running
// product in VMEM scratch; here one thread per lane walks it in a loop with
// the running product in registers. The one Fermat inversion of the total
// between the passes is kernel F (fp_pow.cu).
//
// Bound on the H100: integer multiply-adds, narrowly. One (forward) or two
// (backward) Fq2 products, at least 2.2 k or 4.5 k 32-bit IMADs, per step
// against 168 bytes read and 168 written per step and lane (the backward
// pass also reads the prefix); at 130 steps x 16384 lanes each pass moves
// about 0.7 GB. Neighbouring
// threads read neighbouring words of every row.
#include <cuda_runtime.h>

#include "field.cuh"

namespace pt {

__global__ void __launch_bounds__(BLOCK)
k_prefix_products(const int32_t* __restrict__ z, int n_steps, int32_t* __restrict__ prefix,
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

__global__ void __launch_bounds__(BLOCK)
k_running_inverse(const int32_t* __restrict__ z, const int32_t* __restrict__ prefix,
                  const int32_t* __restrict__ tinv, int n_steps, int32_t* __restrict__ zinv,
                  int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const size_t n = (size_t)lanes;
  const size_t step = 2 * NL * n;
  Fp2 c = load_fp2(tinv + lane, n);
#pragma unroll 1
  for (int i = n_steps - 1; i >= 0; --i) {
    store_fp2(fp2_mul(c, load_fp2(prefix + i * step + lane, n)), zinv + i * step + lane, n);
    c = fp2_mul(c, load_fp2(z + i * step + lane, n));
  }
}

}  // namespace pt

extern "C" int pt_prefix_products(const int32_t* z, int n_steps, int32_t* prefix,
                                  int32_t* total, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
    pt::k_prefix_products<<<blocks, pt::BLOCK, 0, (cudaStream_t)stream>>>(z, n_steps, prefix,
                                                                         total, lanes);
  }
  return (int)cudaGetLastError();
}

extern "C" int pt_running_inverse(const int32_t* z, const int32_t* prefix, const int32_t* tinv,
                                  int n_steps, int32_t* zinv, int lanes, void* stream) {
  if (lanes > 0) {
    const int blocks = (lanes + pt::BLOCK - 1) / pt::BLOCK;
    pt::k_running_inverse<<<blocks, pt::BLOCK, 0, (cudaStream_t)stream>>>(
        z, prefix, tinv, n_steps, zinv, lanes);
  }
  return (int)cudaGetLastError();
}
