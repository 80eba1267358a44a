// Kernels 1 and 2 for int1, int2, int4, int8 weights with bfloat16
// activations (design, operands and bound: dequant_formats.cuh).
// Modes: none, (w - z) s.
#include "dequant_formats.cuh"

#define BBT_CASES(X) \
  X(1, 1, bbt::fmt::Int<1>, 0, bbt::fmt::BF16) \
  X(1, 1, bbt::fmt::Int<1>, 1, bbt::fmt::BF16) \
  X(1, 2, bbt::fmt::Int<2>, 0, bbt::fmt::BF16) \
  X(1, 2, bbt::fmt::Int<2>, 1, bbt::fmt::BF16) \
  X(1, 4, bbt::fmt::Int<4>, 0, bbt::fmt::BF16) \
  X(1, 4, bbt::fmt::Int<4>, 1, bbt::fmt::BF16) \
  X(1, 8, bbt::fmt::Int<8>, 0, bbt::fmt::BF16) \
  X(1, 8, bbt::fmt::Int<8>, 1, bbt::fmt::BF16)

BBT_FMT_ENTRIES(int_bf16, BBT_CASES)
