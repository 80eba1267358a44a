// Kernels 1 and 2 for uint1, uint2 weights with float16 activations, and
// uint4's options beyond GPTQ's (unscaled, scales without zeros, float32
// out; GPTQ's own configuration runs dequant_matmul.cu) (design, operands
// and bound: dequant_formats.cuh).
// Modes: none, (w - z) s, w s - z.
#include "dequant_formats.cuh"

#define BBT_CASES(X) \
  X(0, 1, bbt::fmt::UInt<1>, 0, bbt::fmt::F16) \
  X(0, 1, bbt::fmt::UInt<1>, 1, bbt::fmt::F16) \
  X(0, 1, bbt::fmt::UInt<1>, 2, bbt::fmt::F16) \
  X(0, 2, bbt::fmt::UInt<2>, 0, bbt::fmt::F16) \
  X(0, 2, bbt::fmt::UInt<2>, 1, bbt::fmt::F16) \
  X(0, 2, bbt::fmt::UInt<2>, 2, bbt::fmt::F16) \
  X(0, 4, bbt::fmt::UInt<4>, 0, bbt::fmt::F16) \
  X(0, 4, bbt::fmt::UInt<4>, 1, bbt::fmt::F16) \
  X(0, 4, bbt::fmt::UInt<4>, 2, bbt::fmt::F16)

BBT_FMT_ENTRIES(uint_f16, BBT_CASES)
