// Kernel E's slot programs, folded on the host into one table a launch:
// the table (ETable) and its folding (fold_program), shared by kernel E
// (slotwise.cu) and kernel K15 (hard_chain.cu, whose conjugates and
// Frobenius maps are E's components).
#pragma once

#include "field.cuh"

namespace pt {

// Component modes: E_NEG alone (or 0) copies row k, negated; E_MUL sums the
// terms flagged E_T0 (input row 2i) and E_T1 (input row 2i + 1).
enum : uint32_t { E_NEG = 1, E_MUL = 2, E_T0 = 4, E_T1 = 8 };

// Output component c of a slot times g: the term of input component j has
// the constant g[E_TERMS[c][j].g], negated when .neg (c0 = x0 g0 + x1 (-g1),
// c1 = x0 g1 + x1 g0, as in pairing_tpu/ops/klayout.py:_slot_kernel).
struct ETerm { uint8_t g, neg; };
constexpr ETerm E_TERMS[2][2] = {{{0, 0}, {1, 1}}, {{1, 0}, {0, 0}}};

// One program, folded: per output component its mode and its two term
// constants, digits of values below p.
struct ETable {
  uint32_t mode[12];
  uint32_t k[12][2][NL];
};

// p's digits, for the host's negation of a constant.
constexpr uint32_t P_HOST[NL] = {7495, 999, 1462, 280, 5058, 1350, 455, 4653, 362, 3260, 5655,
                                 770, 7016, 2082, 1761, 5125, 305, 5015, 6419, 96, 0};

// The table of one program: prog [6] and consts [6, 2, NL] as the wrapper
// gives them (host memory, 13-bit digits). Returns false for a constant
// above p.
static bool fold_program(const int32_t* prog, const int32_t* consts, ETable& tab) {
  for (int k = 0; k < 12; ++k) {
    const int i = k >> 1, c = k & 1, op = prog[i];
    for (int j = 0; j < 2; ++j)
      for (int l = 0; l < NL; ++l) tab.k[k][j][l] = 0;
    if (!(op & 4)) {
      tab.mode[k] = ((op >> c) & 1) ? E_NEG : 0;
      continue;
    }
    tab.mode[k] = E_MUL;
    for (int j = 0; j < 2; ++j) {
      const ETerm t = E_TERMS[c][j];
      const int32_t* g = consts + (2 * i + t.g) * NL;
      bool zero = true;
      for (int l = 0; l < NL; ++l) zero = zero && g[l] == 0;
      if (zero) continue;
      tab.mode[k] |= E_T0 << j;
      const bool neg = t.neg != ((op >> j) & 1);  // -(-x) g = x g
      int32_t borrow = 0;
      for (int l = 0; l < NL; ++l) {  // p - g
        const int32_t d = (int32_t)P_HOST[l] - g[l] + borrow;
        tab.k[k][j][l] = neg ? (uint32_t)d & MASK : (uint32_t)g[l];
        borrow = d >> RB;
      }
      if (borrow != 0) return false;
    }
  }
  return true;
}

}  // namespace pt
