// flash_attention_fwd_d128: kernel 4 (csrc/flash_attention.cuh, which
// holds the kernel, its design and the TPU kernel it replaces) at head
// dim 128 -- Llama-2-7B's and Mistral-7B-v0.1's prefill -- for float16 and
// bfloat16 operands, 64-key tiles, the causal (with or without a
// window) and the dense walk, K or K^T. The other head dims build from
// flash_attention_d<D>.cu beside this file, in parallel.

#include "flash_attention.cuh"

BBT_FLASH_ENTRY(128)
