// flash_decode: one query token per sequence against the bf16 or f16 slot
// cache.
//   q      [B, H, D]             float16 or bfloat16 (q_bf16; D %
//                                128 == 0, up to 1024)
//   k, v   [rows, Smax, Hkv, D]  bfloat16 (the engines' cache dtype) or
//                                float16 (QuantLlamaLM.generate keeps the
//                                hidden dtype); kv_f16 says which
//   slots  [B] int32 (cache row of each sequence), lengths [B] int32
//          (valid tokens, counting the one just appended)
//   out    [B, H, D]             q's type
//   window 0, or the sliding window: keys [max(len - window, 0), len)
//   part, count  the split-KV scratch and counters (flash_decode.cuh);
//          chunk, splits from kernels/flash.plan_splits
//
// Replaces bitblas_tpu/kernels/flash.py:make_flash_decode (pallas_call at
// :590) with ring=False, with or without a window (JAX `window=`,
// flash.py:459, :511-536), and with partial_stats=True
// (flash_decode_partial below).
//
// What bounds it on the H100: the KV bytes of this step,
// sum_b min(lengths[b], window) * Hkv * D * 2 (bytes) * 2 (K and V), over
// 3.35 TB/s.
// The kernel and its design (split-KV over a cp.async ring) are in
// flash_decode.cuh, shared with the int8 and paged variants; any GQA
// group (above 8 in chunks of 8 query heads).

#include "flash_decode.cuh"

extern "C" int flash_decode(const void* q, const void* k_cache,
                            const void* v_cache, const void* slots,
                            const void* lengths, void* out, void* part,
                            void* count, int B, int H, int Hkv, int Smax,
                            int chunk, int splits, int head_dim, int kv_f16,
                            int q_bf16, int window, float scale,
                            void* stream) {
  if (kv_f16)
    return bbt::decode::launch<half, false>(
        q, k_cache, v_cache, nullptr, nullptr, slots, lengths, out, nullptr,
        part, count, B, H, Hkv, Smax, 1, chunk, splits, head_dim, q_bf16,
        window, scale, stream);
  return bbt::decode::launch<__nv_bfloat16, false>(
      q, k_cache, v_cache, nullptr, nullptr, slots, lengths, out, nullptr,
      part, count, B, H, Hkv, Smax, 1, chunk, splits, head_dim, q_bf16,
      window, scale, stream);
}

// flash_decode_partial: the same walk in partial_stats mode (JAX
// make_flash_decode(partial_stats=True), flash.py:456, :476-483, :552,
// :634-640), for context parallelism's cross-shard merge: no window,
// `lengths` the valid keys of this sequence shard (0: none), and instead
// of `out` the f32 accumulator acc [B, H, D] (unnormalised) and ml
// [2, B, H] (m in the natural-log domain, then l).
extern "C" int flash_decode_partial(
    const void* q, const void* k_cache, const void* v_cache,
    const void* slots, const void* lengths, void* acc, void* ml, void* part,
    void* count, int B, int H, int Hkv, int Smax, int chunk, int splits,
    int head_dim, int kv_f16, int q_bf16, float scale, void* stream) {
  if (kv_f16)
    return bbt::decode::launch<half, false>(
        q, k_cache, v_cache, nullptr, nullptr, slots, lengths, acc, ml,
        part, count, B, H, Hkv, Smax, 1, chunk, splits, head_dim, q_bf16, 0,
        scale, stream);
  return bbt::decode::launch<__nv_bfloat16, false>(
      q, k_cache, v_cache, nullptr, nullptr, slots, lengths, acc, ml, part,
      count, B, H, Hkv, Smax, 1, chunk, splits, head_dim, q_bf16, 0, scale,
      stream);
}
