// flash_attention_fwd_d80: kernel 4 (csrc/flash_attention.cuh, which holds
// the kernel, its design and the TPU kernel it replaces) at head dim 80,
// for float16 and bfloat16 operands, the causal (with or without a window)
// and the dense walk, K or K^T: H2O-Danube-1.8B's head dim (2560 / 32).
// 80 % 8 == 0, so a head's row starts 160 * head bytes in, on a 16-byte
// multiple for every head count, and its boxes start on the head's first
// column. Two boxes, 5 k16 steps over columns 0-79 of Q and K: the K box's
// columns 80-127 (the next head's, or TMA's zeros past the last head) are
// never multiplied, and Q's are zeroed anyway. O's columns 80-127 are
// computed from the next head's V and not stored. 83 KB of shared memory:
// two blocks an SM.

#include "flash_attention.cuh"

BBT_FLASH_ENTRY(80)
