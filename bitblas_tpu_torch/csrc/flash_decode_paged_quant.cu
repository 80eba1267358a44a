// flash_decode_paged_quant: one query token per sequence against the
// int8 block pool.
//   q        [B, H, D]                 float16 or bfloat16 (q_bf16; D %
//                                      128 == 0, up to 1024)
//   k, v     [num_blocks, bs, Hkv, D]  int8 codes
//   k_scale, v_scale [num_blocks, bs, Hkv] float32
//   tables   [B, max_blocks] int32, lengths [B] int32
//   out      [B, H, D]                 q's type (no window: see
//                                      flash_decode_paged.cu)
//
// Replaces bitblas_tpu/kernels/flash.py:make_flash_decode_paged_quant
// (pallas_call at :1132): the paged walk of flash_decode_paged.cu with the
// scale handling of flash_decode_quant.cu. The TPU kernel needs 128-row
// pages because its scale rows ride the DMA lane axis; here each key reads
// its two scales as stored, so any block size works (the engine's default
// is 16).
//
// What bounds it on the H100: the live bytes of this step,
// sum_b lengths[b] * Hkv * (2 * D + 2 * 4) bytes, over 3.35 TB/s.
// Design: flash_decode.cuh.

#include "flash_decode.cuh"

extern "C" int flash_decode_paged_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, void* out, void* part, void* count, int B, int H,
    int Hkv, int block_size, int max_blocks, int chunk, int splits,
    int head_dim, int q_bf16, float scale, void* stream) {
  return bbt::decode::launch<int8_t, true>(
      q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, nullptr,
      part, count, B, H, Hkv, block_size, max_blocks, chunk, splits,
      head_dim, q_bf16, 0, scale, stream);
}
