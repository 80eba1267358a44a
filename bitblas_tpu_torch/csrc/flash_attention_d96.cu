// flash_attention_fwd_d96: kernel 4 (csrc/flash_attention.cuh, which holds
// the kernel, its design and the TPU kernel it replaces) at head dim 96,
// for float16 and bfloat16 operands, the causal (with or without a window)
// and the dense walk, K or K^T: two boxes, the second half used: 6 k16
// steps; O's columns 96-127 (the next head's) are computed and not stored.

#include "flash_attention.cuh"

BBT_FLASH_ENTRY(96)
