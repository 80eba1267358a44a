// Kernel 1 for int8 activations with uint4 weights (design, operands and
// bound: dequant_int.cuh).
#include "dequant_int.cuh"

BBT_INT_ENTRIES(u4, 0, 4)
