// flash_decode_quant: one query token per sequence against the int8 slot
// cache.
//   q        [B, H, D]             float16 or bfloat16 (q_bf16; D %
//                                  128 == 0, up to 1024)
//   k, v     [rows, Smax, Hkv, D]  int8 codes
//   k_scale, v_scale [rows, Smax, Hkv] float32 (x ~= code * scale, one
//            symmetric scale per token and KV head)
//   slots    [B] int32, lengths [B] int32
//   out      [B, H, D]             q's type
//   window   0, or the sliding window: keys [max(len - window, 0), len)
//
// Replaces bitblas_tpu/kernels/flash.py:make_flash_decode_quant
// (pallas_call at :813), with or without a window (flash.py:652,
// :695-752), and with partial_stats=True (flash_decode_quant_partial
// below). Scales
// apply to the dot results as there: the K scale multiplies each logit
// before the running max, the V scale folds into the softmax weight
// before the PV product. The scales are read as stored; the TPU wrapper's
// per-step transpose and 8-row q padding are Mosaic layout needs and have
// no counterpart here.
//
// What bounds it on the H100: the live int8 bytes of this step,
// sum_b lengths[b] * Hkv * (2 * D + 2 * 4) bytes, over 3.35 TB/s -- about
// half of the bf16 kernel's. Design: flash_decode.cuh; K/V rows arrive in
// 16-byte copies of 16 codes each and are converted in registers.

#include "flash_decode.cuh"

extern "C" int flash_decode_quant(const void* q, const void* k_cache,
                                  const void* v_cache, const void* k_scale,
                                  const void* v_scale, const void* slots,
                                  const void* lengths, void* out,
                                  void* part, void* count, int B, int H,
                                  int Hkv, int Smax, int chunk, int splits,
                                  int head_dim, int q_bf16, int window,
                                  float scale, void* stream) {
  return bbt::decode::launch<int8_t, false>(
      q, k_cache, v_cache, k_scale, v_scale, slots, lengths, out, nullptr,
      part, count, B, H, Hkv, Smax, 1, chunk, splits, head_dim, q_bf16,
      window, scale, stream);
}

// flash_decode_quant_partial: partial_stats mode (JAX
// make_flash_decode_quant(partial_stats=True), flash.py:651, :667, :774):
// no window, shard-local `lengths`, acc [B, H, D] f32 and ml [2, B, H]
// as flash_decode_partial's. The V scales are folded into the weights of
// acc and not into l, as in JAX's kernel.
extern "C" int flash_decode_quant_partial(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* slots,
    const void* lengths, void* acc, void* ml, void* part, void* count, int B,
    int H, int Hkv, int Smax, int chunk, int splits, int head_dim,
    int q_bf16, float scale, void* stream) {
  return bbt::decode::launch<int8_t, false>(
      q, k_cache, v_cache, k_scale, v_scale, slots, lengths, acc, ml, part,
      count, B, H, Hkv, Smax, 1, chunk, splits, head_dim, q_bf16, 0, scale,
      stream);
}
