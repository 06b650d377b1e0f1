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
// scratch; here a loop over the bits runs inside one launch.
//
// Bound on the H100: integer multiply-adds. 64 cyclotomic squares and one
// dense product per set bit need at least about 1.7 M 32-bit IMADs per lane
// for BN_X (the least count in chip_smoke.py), against 1008 bytes read and
// 64 x 1008 bytes written per lane. Design: kernel D's (csrc/pow_ladder.cu)
// on the six-thread group core (field_group.cuh): six threads per lane,
// five lanes per warp, the lane's f, a scratch and x in shared memory, so
// that each thread holds one Fq product's operands and accumulator in
// registers and the SM keeps 8 warps in flight. x is loaded once and stays
// resident: reloading it on each set bit, as D stages its stream row, ran
// 7% slower on the H100. Each step is D's step with x as its row, then each
// rank writes its own slot of the row. The bit is the same for every lane,
// so the multiply branch is uniform.
#include <cuda_runtime.h>

#include "field_group.cuh"

namespace pt {

// Four warps a block, two blocks (8 warps) per SM, as kernel D. A lane's
// shared region is f, the square's scratch and x (three Fq12 and one word
// of padding, 3,028 B): 60,560 B a block, dynamic (over 48 KB).
constexpr int K12_WARPS = 4;
constexpr int K12_MIN_BLOCKS = 2;
constexpr int K12_THREADS = K12_WARPS * 32;
constexpr int K12_LANES = K12_WARPS * GROUP_LANES;  // lanes per block
constexpr int K12_STRIDE = 3 * F12_WORDS + 1;
constexpr size_t K12_SMEM = (size_t)K12_LANES * K12_STRIDE * sizeof(uint32_t);

// The row store needs no barrier of its own: group_cyc_sq and
// group_fq12_mul both end with rank s writing slot s of f and then a
// __syncwarp, so the slot a rank stores is one it wrote itself, and the
// next step's square only reads f until its own first barrier, which every
// rank reaches after its store. x is written once, before the first
// barrier, and only read after it.
__global__ void __launch_bounds__(K12_THREADS, K12_MIN_BLOCKS)
k_exp_bits(const int32_t* __restrict__ x_src, const int32_t* __restrict__ bits, int n_bits,
           int32_t* __restrict__ rows, int lanes) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, t32 = threadIdx.x & 31;
  // Threads 30 and 31 of each warp belong to no lane and to no barrier's mask.
  if (t32 >= GROUP * GROUP_LANES) return;
  const int g = t32 / GROUP, s = t32 % GROUP;
  const int lane = (blockIdx.x * K12_WARPS + warp) * GROUP_LANES + g;
  // A lane past the batch edge works on the last lane's data, reaches every
  // barrier with its group and stores nothing.
  const bool live = lane < lanes;
  const size_t n = (size_t)lanes;
  const size_t col = live ? (size_t)lane : n - 1;
  uint32_t* f = smem + (warp * GROUP_LANES + g) * K12_STRIDE;
  uint32_t* scr = f + F12_WORDS;
  uint32_t* x = scr + F12_WORDS;
  const size_t row_words = 12 * NL * n;
  group_set_one(f, s);
  group_load_slot(x, x_src + col, n, s);
  __syncwarp(GROUP_MASK);
#pragma unroll 1
  for (int t = 0; t < n_bits; ++t) {
    group_cyc_sq(f, scr, s);
    if (__ldg(bits + t) != 0) group_fq12_mul(f, x, s);
    if (live) group_store_slot(f, rows + t * row_words + lane, n, s);
  }
}

}  // namespace pt

extern "C" int pt_exp_bits(const int32_t* x, const int32_t* bits, int n_bits, int32_t* rows,
                           int lanes, void* stream) {
  if (lanes > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        pt::k_exp_bits, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pt::K12_SMEM);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (lanes + pt::K12_LANES - 1) / pt::K12_LANES;
    pt::k_exp_bits<<<blocks, pt::K12_THREADS, pt::K12_SMEM, (cudaStream_t)stream>>>(
        x, bits, n_bits, rows, lanes);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory a block of k_exp_bits asks for at launch
// (ptxas reports static shared memory only).
extern "C" int pt_exp_bits_shared_bytes() { return (int)pt::K12_SMEM; }
