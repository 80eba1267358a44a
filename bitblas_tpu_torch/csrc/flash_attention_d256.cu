// flash_attention_fwd_d256: kernel 4 (csrc/flash_attention.cuh, which holds
// the kernel, its design and the TPU kernel it replaces) at head dim 256,
// for float16 and bfloat16 operands, the causal (with or without a window)
// and the dense walk, K or K^T: four boxes, a 64 x 256 f32 O (128 registers
// a consumer thread), 64-key tiles only (160 KB of shared memory, one block
// an SM).

#include "flash_attention.cuh"

BBT_FLASH_ENTRY(256)
