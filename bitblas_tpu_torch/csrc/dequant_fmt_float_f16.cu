// Kernels 1 and 2 for nf4, fp4_e2m1, e4m3_float8, e5m2_float8 weights with
// float16 activations (design, operands and bound: dequant_formats.cuh).
// Modes: none, (w - z) s.
#include "dequant_formats.cuh"

#define BBT_CASES(X) \
  X(2, 4, bbt::fmt::Nf4, 0, bbt::fmt::F16) \
  X(2, 4, bbt::fmt::Nf4, 1, bbt::fmt::F16) \
  X(3, 4, bbt::fmt::Fp4, 0, bbt::fmt::F16) \
  X(3, 4, bbt::fmt::Fp4, 1, bbt::fmt::F16) \
  X(4, 8, bbt::fmt::E4m3, 0, bbt::fmt::F16) \
  X(4, 8, bbt::fmt::E4m3, 1, bbt::fmt::F16) \
  X(5, 8, bbt::fmt::E5m2, 0, bbt::fmt::F16) \
  X(5, 8, bbt::fmt::E5m2, 1, bbt::fmt::F16)

BBT_FMT_ENTRIES(float_f16, BBT_CASES)
