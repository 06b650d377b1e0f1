// Kernel E: slot-wise Fq12 maps on KF12 tensors [12, 21, lanes]: the
// conjugate and the Frobenius maps p^k.
//
// Replaces pairing_tpu/ops/klayout.py:_slotwise (pallas_call at :200, body
// _slot_kernel), reached through klayout.kconj and klayout.kfrob. As there,
// one program drives every map: per slot i, prog[i] says whether to negate
// c0 (bit 0) and c1 (bit 1), and whether to multiply the slot by the Fq2
// constant g = consts[i] (bit 2; consts is [6, 2, 21], Montgomery digits of
// values below p). The conjugate negates both components of the odd slots;
// frobenius_map(pw) conjugates every slot for odd pw, then multiplies slot
// i by frob_coeffs(pw)^i.
//
// Bound on the H100: memory, or by a little the integer multiply-adds.
// 1,008 bytes read and 1,008 written a lane against at most five Fq2
// products by a constant (at least 2,247 32-bit IMADs each, 1,806 for p^2's
// real constants; chip_smoke.py gives each program its own bound). The
// first port ran one thread per lane (128 blocks at 16384 lanes: four warps
// an SM, too few loads in flight to keep HBM busy), field.cuh's out-of-line
// fp2_mul on 64-bit columns (192 registers, 336 B of stack).
//
// Design: one thread per (output component k = 2i + c, lane), computing
// what the TPU kernel computes for it: with x the slot's input after its
// negations, c0 = x0 g0 + x1 (-g1) and c1 = x0 g1 + x1 g0 (E_TERMS), two
// products by a constant summed in 32-bit columns (field32.cuh) and one
// Montgomery reduction. The host folds each negation into the constant, so
// output k is a[2i] K[k][0] + a[2i + 1] K[k][1] with every K below p, and a
// term whose constant is zero is skipped (p^2's constants are real: one
// product a component). A slot without a constant is a copy or a negation
// of its row (fp_neg, as before). The folded table (ETable, 2,064 B, and
// fold_program in slot_table.cuh, shared with K15) is a
// kernel parameter, in the constant bank: one code path for the conjugate
// and every power. A block is E_LANES lanes of one component; block b
// serves component b % 12 of lanes E_LANES (b / 12) onwards, so the
// component, its mode and its constants are the same in the whole block,
// and the blocks of a slot's two components, neighbours in launch order,
// read the slot's two rows while they are in L2.
//
// Columns: every input digit is below 2^13 (load_fp carries on load) and
// every constant digit too, so a component's two products (42 limb
// products below 2^26 a column), the reduction's terms and one carry stay
// below 2^32 as in any Fq2 product component of field32.cuh; the sum is
// below 4p^2 < R p, so the output is below 2p with digits below 2^13 (the
// numpy model in tests/test_torch_slot_kernels.py checks the columns at
// all-maximal digits). The sums differ from the first port's by multiples
// of p (a negation now sits in the constant), so its digits may differ by
// p; the values are the same.
#include <cuda_runtime.h>

#include "field32.cuh"
#include "slot_table.cuh"

namespace pt {

constexpr int E_LANES = 128;  // lanes per block, all of one output component

// Output component k of this lane (``a`` and ``out`` at this lane's column
// of component 0).
static __device__ __forceinline__ void slot_component(const int32_t* __restrict__ a,
                                                      const ETable& tab, int k, size_t n,
                                                      int32_t* __restrict__ out) {
  const uint32_t mode = tab.mode[k];
  Fp x;
  if (!(mode & E_MUL)) {
    load_fp(x, a + k * NL * n, n);
    store_fp((mode & E_NEG) ? fp_neg(x) : x, out + k * NL * n, n);
    return;
  }
  const int32_t* src = a + (k & ~1) * NL * n;  // row 2i
  Wide32 w;
  w32_zero(w);
#pragma unroll 1
  for (int j = 0; j < 2; ++j) {
    if (!(mode & (E_T0 << j))) continue;
    load_fp(x, src + j * NL * n, n);
    Fp g;
#pragma unroll
    for (int l = 0; l < NL; ++l) g.v[l] = tab.k[k][j][l];
    w32_mac(w, x, g);
  }
  Fp r;
  w32_reduce_imm(w, r);
  store_fp(r, out + k * NL * n, n);
}

__global__ void __launch_bounds__(E_LANES, 4)
k_fq12_slotwise(const int32_t* __restrict__ a, const __grid_constant__ ETable tab,
                int32_t* __restrict__ out, int lanes) {
  const int k = blockIdx.x % 12;
  const int lane = (blockIdx.x / 12) * E_LANES + threadIdx.x;
  if (lane >= lanes) return;
  slot_component(a + lane, tab, k, (size_t)lanes, out + lane);
}

}  // namespace pt

extern "C" int pt_fq12_slotwise(const int32_t* a, const int32_t* prog, const int32_t* consts,
                                int32_t* out, int lanes, void* stream) {
  pt::ETable tab;
  if (!pt::fold_program(prog, consts, tab)) return (int)cudaErrorInvalidValue;
  if (lanes > 0) {
    const int blocks = 12 * ((lanes + pt::E_LANES - 1) / pt::E_LANES);
    pt::k_fq12_slotwise<<<blocks, pt::E_LANES, 0, (cudaStream_t)stream>>>(a, tab, out, lanes);
  }
  return (int)cudaGetLastError();
}
