// The checks of a pairing's inputs (k_validate): the G1 and G2 curve
// equations and the compare that ends the G2 subgroup check.
//
// Replaces no TPU kernel: the JAX package computes all three as fused XLA
// inside its jitted graphs (pairing_tpu/curves/g1.py:56 g1_on_curve,
// g2.py:89 g2_on_curve, :211 g2_in_subgroup), and the port ran them as
// eager field arithmetic on CUDA tensors: about 2,300 small launches and
// 167 blocking copies of host constants a Groth16 verify call.
//
// Three modes, one launch each, one verdict byte a lane:
//   G1:      P = (x, y) over Fq:   y^2 == x^3 + 3
//   G2:      Q = (x, y) over Fq2:  y^2 == x^3 + b', b' = 3 / xi (TWIST_B)
//   compare: Q and the Jacobian end state (X, Y, Z) of the [6x^2] Q ladder
//            (kernel H's end-only mode):  X == psi(Q).x Z^2,
//            Y == psi(Q).y Z^3 and Z != 0, with psi(Q) = (c2 conj(Q.x),
//            c3 conj(Q.y)) (TWIST_C2, TWIST_C3).
// All values are in the Montgomery domain, as the plain versions'.
//
// Every operand enters through canon.cuh: the exact carry and the long
// division by p 2^j that its static bound asks for, so the arithmetic starts
// from the canonical representative (below p, 13-bit digits) whatever the
// operand's limbs or bound (up to p 2^20). The products are field32.cuh's
// 32-bit columns: an Fq2 product component is two Fq products into one
// accumulator and one reduction, an Fq2 square component one product
// (trajectory.cuh's sq_of), every result below 2p with 13-bit digits. Each
// side of a comparison is then packed into canon.cuh's words and reduced
// below p with one step of its long division, and the words compared: the
// verdicts are exact mod p, so they equal the plain versions' lane for lane
// (P = (0, 0) fails the G1 equation since b != 0; a ladder whose Z
// collapsed to 0 fails the compare).
//
// Operands are read in place: a base pointer, a row stride and a limb
// stride each (public rows [*batch, 21], row slices and expanded constants
// alike; the end state in the batch-last kernel layout [6, 21, lanes]). The
// table of operands is the kernel's parameter, by value (__grid_constant__),
// and the constants (3, b', c2, c3 in Montgomery form) live in constant
// memory, so a launch copies nothing from the host.
//
// Bound on the H100: operations, barely. The compare reads 840 B a lane
// and takes 18 Fq products (Z^2 2, Z^3 4, psi 4, the two right sides 8);
// at 16384 lanes that is about 4 us of bytes and 15 us of IMADs at the
// peak rate. One thread per lane, blocks of 128 lanes.
#include <cuda_runtime.h>

#include "canon.cuh"
#include "trajectory.cuh"

namespace pt {

enum { VAL_G1 = 0, VAL_G2 = 1, VAL_COMPARE = 2 };
// Operands a mode reads: G1 x, y; G2 x.c0, x.c1, y.c0, y.c1; compare Q's
// four, then X.c0, X.c1, Y.c0, Y.c1, Z.c0, Z.c1.
constexpr int VAL_OPERANDS[3] = {2, 4, 10};
constexpr int VAL_MAX_OPERANDS = 10;
constexpr int VAL_THREADS = 128;

// Rows: 3, TWIST_B.c0, TWIST_B.c1, TWIST_C2.c0, TWIST_C2.c1, p - TWIST_C2.c0,
// TWIST_C3.c0, TWIST_C3.c1, p - TWIST_C3.c0 (utils/bn254.py), each c in the
// Montgomery domain (c R mod p), 13-bit digits, least significant first.
enum { VC_THREE = 0, VC_B0, VC_B1, VC_C2_0, VC_C2_1, VC_C2_0N, VC_C3_0, VC_C3_1, VC_C3_0N };
static __constant__ uint32_t VAL_CONST[9][NL] = {
    {1683, 3939, 4508, 687, 7553, 4905, 2404, 8054, 1232, 2762, 509,
     6671, 3348, 2049, 6327, 7338, 2957, 8188, 2784, 62, 0},
    {3252, 961, 7270, 3064, 3593, 7876, 3310, 6212, 2252, 4773, 3416,
     3583, 2977, 1310, 4571, 7088, 3921, 1051, 5816, 38, 0},
    {4403, 2713, 654, 1760, 6479, 5936, 1907, 5783, 1932, 909, 2545,
     7654, 1223, 5578, 6714, 5247, 7151, 7628, 3952, 92, 0},
    {2719, 4087, 1474, 6164, 8136, 3749, 6545, 7592, 134, 6235, 8062,
     4098, 5680, 3706, 5416, 7273, 6839, 6031, 820, 61, 0},
    {7791, 5547, 4942, 4433, 1775, 4205, 5625, 6516, 1687, 3606, 5650,
     3724, 7941, 59, 5827, 6742, 2189, 7492, 3126, 37, 0},
    {4776, 5104, 8179, 2307, 5113, 5792, 2101, 5252, 227, 5217, 5784,
     4863, 1335, 6568, 4536, 6043, 1657, 7175, 5598, 35, 0},
    {6846, 5214, 921, 5137, 3662, 1557, 309, 1913, 5658, 6625, 3659,
     119, 7889, 3249, 5255, 3936, 4895, 445, 6247, 1, 0},
    {4270, 5973, 102, 5274, 195, 5825, 2782, 833, 1772, 2287, 170,
     1075, 5465, 4673, 6338, 2661, 3099, 4010, 7071, 15, 0},
    {649, 3977, 540, 3335, 1395, 7985, 145, 2740, 2896, 4826, 1995,
     651, 7319, 7024, 4697, 1188, 3602, 4569, 172, 95, 0},
};

struct ValTable {
  CanonOperand op[VAL_MAX_OPERANDS];
};

static __device__ __forceinline__ Fp val_const(int row) {
  Fp c;
#pragma unroll
  for (int l = 0; l < NL; ++l) c.v[l] = VAL_CONST[row][l];
  return c;
}

// Operand o at `lane`, reduced below p, as 13-bit digits.
static __device__ __forceinline__ Fp load_canon(const CanonOperand& o, long long lane) {
  uint64_t w[CANON_WORDS];
  canon_load(o, lane, w);
  canon_reduce(w, o.steps);
  Fp x;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const int bit = RB * l, k = bit / 64, s = bit % 64;
    uint64_t v = w[k] >> s;
    if (s + RB > 64) v |= w[k + 1] << (64 - s);
    x.v[l] = (uint32_t)(v & MASK);
  }
  return x;
}

static __device__ __forceinline__ Fp2 load_canon2(const CanonOperand* o, long long lane) {
  return Fp2{load_canon(o[0], lane), load_canon(o[1], lane)};
}

// The words of x (13-bit digits, value below 2p) reduced below p: canon.cuh's
// packing and one step of its long division.
static __device__ __forceinline__ void canon_words(const Fp& x, uint64_t w[CANON_WORDS]) {
#pragma unroll
  for (int k = 0; k < CANON_WORDS; ++k) w[k] = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const uint64_t d = x.v[l];
    const int bit = RB * l, k = bit / 64, s = bit % 64;
    w[k] |= d << s;
    if (s + RB > 64) w[k + 1] |= d >> (64 - s);
  }
  canon_reduce(w, 1);
}

// a == b mod p, both with 13-bit digits and below 2p.
static __device__ __noinline__ bool fp_same(const Fp& a, const Fp& b) {
  uint64_t x[CANON_WORDS], y[CANON_WORDS];
  canon_words(a, x);
  canon_words(b, y);
  uint64_t d = 0;
#pragma unroll
  for (int k = 0; k < CANON_WORDS; ++k) d |= x[k] ^ y[k];
  return d == 0;
}

static __device__ __forceinline__ bool fp2_same(const Fp2& a, const Fp2& b) {
  return fp_same(a.c0, b.c0) & fp_same(a.c1, b.c1);
}

// fp2_mul on 32-bit columns: (a0 b0 + a1 (2p - b1)) + (a0 b1 + a1 b0) u.
static __device__ __noinline__ Fp2 fp2_mul32(const Fp2& a, const Fp2& b) {
  const Fp nb1 = fp_neg(b.c1);
  Fp2 r;
  Wide32 w;
  w32_zero(w);
  w32_mac(w, a.c0, b.c0);
  w32_mac(w, a.c1, nb1);
  w32_reduce_imm(w, r.c0);
  w32_zero(w);
  w32_mac(w, a.c0, b.c1);
  w32_mac(w, a.c1, b.c0);
  w32_reduce_imm(w, r.c1);
  return r;
}

static __device__ __noinline__ Fp2 fp2_sq32(const Fp2& a) {
  return Fp2{sq_of(a.c0, a.c1, 0), sq_of(a.c0, a.c1, 1)};
}

// c conj(v) for the twist constant c whose rows are (C0, C1, C0N): component
// 0 is v0 c0 + v1 c1, component 1 v0 c1 + v1 (p - c0); one accumulator and
// one reduction each, no negation at run time.
template <int C0, int C1, int C0N>
static __device__ __noinline__ Fp2 twist_conj(const Fp2& v) {
  const Fp c0 = val_const(C0), c1 = val_const(C1), c0n = val_const(C0N);
  Fp2 r;
  Wide32 w;
  w32_zero(w);
  w32_mac(w, v.c0, c0);
  w32_mac(w, v.c1, c1);
  w32_reduce_imm(w, r.c0);
  w32_zero(w);
  w32_mac(w, v.c0, c1);
  w32_mac(w, v.c1, c0n);
  w32_reduce_imm(w, r.c1);
  return r;
}

__global__ void __launch_bounds__(VAL_THREADS)
k_validate(const __grid_constant__ ValTable t, int mode, uint8_t* __restrict__ ok, int lanes) {
  const long long lane = (long long)blockIdx.x * VAL_THREADS + threadIdx.x;
  if (lane >= lanes) return;
  bool good;
  if (mode == VAL_G1) {
    const Fp x = load_canon(t.op[0], lane), y = load_canon(t.op[1], lane);
    const Fp x3 = fp32_mul(fp32_sq(x), x);
    good = fp_same(fp32_sq(y), fp_add(x3, val_const(VC_THREE)));
  } else if (mode == VAL_G2) {
    const Fp2 x = load_canon2(t.op, lane), y = load_canon2(t.op + 2, lane);
    const Fp2 x3 = fp2_mul32(fp2_sq32(x), x);
    const Fp2 rhs{fp_add(x3.c0, val_const(VC_B0)), fp_add(x3.c1, val_const(VC_B1))};
    good = fp2_same(fp2_sq32(y), rhs);
  } else {
    Fp2 zz, zzz;
    {
      const Fp2 z = load_canon2(t.op + 8, lane);
      uint32_t any = 0;
#pragma unroll
      for (int l = 0; l < NL; ++l) any |= z.c0.v[l] | z.c1.v[l];
      good = any != 0;  // canonical digits: zero iff every digit is
      zz = fp2_sq32(z);
      zzz = fp2_mul32(zz, z);
    }
    const Fp2 px = twist_conj<VC_C2_0, VC_C2_1, VC_C2_0N>(load_canon2(t.op, lane));
    good &= fp2_same(load_canon2(t.op + 4, lane), fp2_mul32(px, zz));
    const Fp2 py = twist_conj<VC_C3_0, VC_C3_1, VC_C3_0N>(load_canon2(t.op + 2, lane));
    good &= fp2_same(load_canon2(t.op + 6, lane), fp2_mul32(py, zzz));
  }
  ok[lane] = good ? 1 : 0;
}

}  // namespace pt

// table: host int64 [n, 4], each operand (pointer, row stride, limb stride,
// steps), n the mode's count (VAL_OPERANDS); mode 0 G1, 1 G2, 2 compare.
extern "C" int pt_validate(const long long* table, int mode, uint8_t* ok, int lanes,
                           void* stream) {
  if (mode < pt::VAL_G1 || mode > pt::VAL_COMPARE || ok == nullptr)
    return (int)cudaErrorInvalidValue;
  pt::ValTable t = {};
  for (int i = 0; i < pt::VAL_OPERANDS[mode]; ++i) {
    const long long* e = table + 4 * i;
    if (e[0] == 0 || e[3] < 1 || e[3] > pt::CANON_MAX_STEPS) return (int)cudaErrorInvalidValue;
    t.op[i] = {reinterpret_cast<const int32_t*>(e[0]), e[1], e[2], (int)e[3]};
  }
  if (lanes > 0) {
    const int blocks = (lanes + pt::VAL_THREADS - 1) / pt::VAL_THREADS;
    pt::k_validate<<<blocks, pt::VAL_THREADS, 0, (cudaStream_t)stream>>>(t, mode, ok, lanes);
  }
  return (int)cudaGetLastError();
}
