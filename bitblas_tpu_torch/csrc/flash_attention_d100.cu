// flash_attention_fwd_d100: kernel 4 (csrc/flash_attention.cuh, which holds
// the kernel, its design and the TPU kernel it replaces) at head dim 100,
// for float16 and bfloat16 operands, the causal (with or without a window)
// and the dense walk, K or K^T: BitNet b1.58-3B's head dim. A head's row
// starts 200 * head bytes in, 8 bytes off a 16-byte multiple for odd heads,
// where TMA cannot start a box: the boxes start 4 columns early, two of 64
// columns, 7 k16 steps over 112 columns, and the consumers move Q's rows to
// K's start column as they scale them, zeroing the other columns (the
// neighbour heads'). H and Hkv must be even: a row of 200 * heads bytes is
// a multiple of 16 only then.

#include "flash_attention.cuh"

BBT_FLASH_ENTRY(100)
