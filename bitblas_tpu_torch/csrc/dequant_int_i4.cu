// Kernel 1 for int8 activations with int4 weights (design, operands and
// bound: dequant_int.cuh).
#include "dequant_int.cuh"

BBT_INT_ENTRIES(i4, 1, 4)
