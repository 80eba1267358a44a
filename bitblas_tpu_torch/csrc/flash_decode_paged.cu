// flash_decode_paged: one query token per sequence against the bf16 or
// f16 block pool.
//   q       [B, H, D]                  float16 or bfloat16 (q_bf16; D %
//                                      128 == 0, up to 1024)
//   k, v    [num_blocks, bs, Hkv, D]   bfloat16 or float16 (kv_f16)
//   tables  [B, max_blocks] int32: page j of sequence b (keys
//           [j * bs, (j + 1) * bs)) lives in block tables[b, j]
//   lengths [B] int32
//   out     [B, H, D]                  q's type
//
// Replaces bitblas_tpu/kernels/flash.py:make_flash_decode_paged
// (pallas_call at :965). The TPU kernel walks a sequence's live pages with
// double-buffered page DMAs; here each split of the decode kernel walks
// its chunk in 64-key tiles, and each 16-byte copy resolves its own page
// through the table, so a tile may span several pages (four at bs = 16)
// and any block size works. No window, as the TPU kernel has none: a
// windowed paged decode takes the table gather (serving/kv_cache.py).
// Only pages j < ceil(len / bs) are ever read: table entries past them
// (0, the engine's reserved block) are never touched.
//
// What bounds it on the H100: the live KV bytes of this step,
// sum_b lengths[b] * Hkv * D * 2 (bytes) * 2 (K and V), over 3.35 TB/s.
// Design: flash_decode.cuh.

#include "flash_decode.cuh"

extern "C" int flash_decode_paged(const void* q, const void* k_pool,
                                  const void* v_pool, const void* tables,
                                  const void* lengths, void* out,
                                  void* part, void* count, int B, int H,
                                  int Hkv, int block_size, int max_blocks,
                                  int chunk, int splits, int head_dim,
                                  int kv_f16, int q_bf16, float scale,
                                  void* stream) {
  if (kv_f16)
    return bbt::decode::launch<half, true>(
        q, k_pool, v_pool, nullptr, nullptr, tables, lengths, out, nullptr,
        part, count, B, H, Hkv, block_size, max_blocks, chunk, splits,
        head_dim, q_bf16, 0, scale, stream);
  return bbt::decode::launch<__nv_bfloat16, true>(
      q, k_pool, v_pool, nullptr, nullptr, tables, lengths, out, nullptr,
      part, count, B, H, Hkv, block_size, max_blocks, chunk, splits,
      head_dim, q_bf16, 0, scale, stream);
}
