// flash_attention_fwd_d64: kernel 4 (csrc/flash_attention.cuh, which holds
// the kernel, its design and the TPU kernel it replaces) at head dim 64,
// for float16 and bfloat16 operands, the causal (with or without a window)
// and the dense walk, K or K^T: one 64-column box a row, 4 k16 steps.

#include "flash_attention.cuh"

BBT_FLASH_ENTRY(64)
