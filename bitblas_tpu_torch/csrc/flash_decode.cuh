// The decode-attention kernel shared by flash_decode{,_quant,_paged,
// _paged_quant}.cu: one query token per sequence against a KV cache.
//
//   q      [B, H, D]  float16 (D = 128)
//   K, V   bfloat16 or int8 codes, rows of [Hkv, D], held either as
//          the slot cache [rows, Smax, Hkv, D] (row of key t of sequence b:
//          slots[b] * Smax + t) or as the block pool [blocks, bs, Hkv, D]
//          (row: tables[b, t / bs] * bs + t % bs)
//   scales (int8 only) f32, one per row and KV head: [rows, Smax, Hkv] or
//          [blocks, bs, Hkv], read as stored
//   lengths [B] int32, valid keys (counting the token just appended)
//   out    [B, H, D]  float16
//
// What bounds it on the H100: the live KV bytes of the step,
// sum_b lengths[b] * Hkv * (2 * D * sizeof(elem) + scales), over 3.35 TB/s.
//
// Design: one block per (KV head, sequence), so the whole GQA group of
// H / Hkv query rows shares every K/V row it reads. The block walks keys in
// tiles of 64 and stops at lengths[b]: rows at or past the length are never
// read -- they hold stale data (released slots, the tail of the last page,
// block 0 behind unused table entries), NaN included. Per tile:
//   (1) two threads per key read its K row with 16-byte loads (8 bf16 or
//       16 int8 codes each), convert in registers and dot it with the
//       group's query rows, pre-scaled into the base-2 domain by
//       log2(e)/sqrt(D); int8 scores are then multiplied by the key's K
//       scale, before the running max. The tile's V rows are already in
//       flight (issued first), so a tile costs one DRAM round trip.
//   (2) one warp per query row updates the online-softmax max and sum (f32)
//       and turns scores into weights; int8 weights are multiplied by the
//       key's V scale after the sum (the V scale of a key past the length
//       is 0 and never read, so a NaN scale cannot reach p * vsc).
//   (3) each thread accumulates p * V over one 16-byte chunk of the head
//       dim for every KL-th key; the key lanes are summed once at the end,
//       first across the lanes of a warp, then across warps.
// Keys past the length get score -inf and their V is never loaded nor
// accumulated, so it counts as zero. Tile 0 always holds key 0, so the
// running max is finite from the first tile on; a length of 0 yields 0.
// The GQA group is a template parameter (1, 2, 4 or 8 rows, the group
// rounded up), so the accumulators of a small group take few registers.
// Each entry point launches on the caller's stream and returns the
// launch's cudaError_t.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace bbt {
namespace decode {

constexpr int D = 128;
constexpr int TK = 64;          // keys per tile
constexpr int kThreads = 128;   // == D
constexpr int kWarps = kThreads / 32;
constexpr float LOG2E = 1.4426950408889634f;

// 16 bytes of stored K/V -> floats.
template <typename T>
struct Codes;

template <>
struct Codes<__nv_bfloat16> {
  static constexpr int N = 8;   // values per 16-byte load
  static constexpr bool kScaled = false;
  __device__ __forceinline__ static void to_float(const uint4& raw,
                                                  float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(h[e]);
      f[2 * e] = x.x;
      f[2 * e + 1] = x.y;
    }
  }
};

template <>
struct Codes<int8_t> {
  static constexpr int N = 16;
  static constexpr bool kScaled = true;
  __device__ __forceinline__ static void to_float(const uint4& raw,
                                                  float* f) {
    const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[4 * e] = static_cast<float>(c[e].x);
      f[4 * e + 1] = static_cast<float>(c[e].y);
      f[4 * e + 2] = static_cast<float>(c[e].z);
      f[4 * e + 3] = static_cast<float>(c[e].w);
    }
  }
};

// index: slots [B] (slot cache) or tables [B, max_blocks] (block pool);
// span: Smax (slot cache) or the block size (block pool).
template <typename T, bool kPaged, int G>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const half* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const float* __restrict__ ksc,
                  const float* __restrict__ vsc,
                  const int* __restrict__ index,
                  const int* __restrict__ lengths, half* __restrict__ out,
                  int H, int Hkv, int span, int max_blocks, float scale) {
  using C = Codes<T>;
  constexpr int VEC = C::N;                  // head-dim values per load
  constexpr int NCH = D / VEC;               // 16-byte chunks per row
  constexpr int KL = kThreads / NCH;         // key lanes of phase (3)
  constexpr int HALF = D / 2 / VEC;          // loads per half row, (1)

  __shared__ float qs[G][D];
  __shared__ float ps[G][TK];
  __shared__ float vs_s[TK];    // V scales of the tile (int8 only)
  __shared__ float alpha_s[G];
  __shared__ float m_s[G];      // running max per query row (base 2)
  __shared__ float l_s[G];      // running sum per query row
  __shared__ float red[kWarps][G][D];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int hk = blockIdx.x, b = blockIdx.y;
  const int group = H / Hkv;
  const int len = lengths[b];
  const size_t key_stride = (size_t)Hkv * D;
  const int* table = index + (size_t)b * max_blocks;
  const size_t slot_base = kPaged ? 0 : (size_t)index[b] * span;
  // Cache row of key t; only called for t < len.
  auto row_of = [&](int t) -> size_t {
    if constexpr (kPaged)
      return (size_t)__ldg(table + t / span) * span + t % span;
    else
      return slot_base + t;
  };

  for (int i = tid; i < group * D; i += kThreads)
    qs[i / D][i % D] =
        __half2float(q[((size_t)b * H + hk * group) * D + i]) *
        (scale * LOG2E);
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  // Phase (3) layout: NCH chunks of VEC head-dim values x KL key lanes.
  const int dc = tid % NCH, kl = tid / NCH;
  float acc[G][VEC];
#pragma unroll
  for (int gq = 0; gq < G; ++gq)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[gq][j] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += TK) {
    const int nvalid = min(TK, len - t0);
    // V rows of this tile go in flight first, so their latency overlaps
    // the K reads and dots of phase (1) (layout of phase (3)).
    uint4 vraw[TK / KL];
#pragma unroll
    for (int i = 0; i < TK / KL; ++i) {
      const int key = kl + KL * i;
      vraw[i] = key < nvalid
                    ? *reinterpret_cast<const uint4*>(
                          vc + row_of(t0 + key) * key_stride + hk * D +
                          dc * VEC)
                    : make_uint4(0, 0, 0, 0);
    }
    // (1) scores: key = tid / 2, half the head dim each.
    {
      const int key = tid >> 1, part = tid & 1;
      float dot[G];
#pragma unroll
      for (int gq = 0; gq < G; ++gq) dot[gq] = 0.f;
      float kscale = 1.f;
      if (key < nvalid) {
        const size_t r = row_of(t0 + key);
        if constexpr (C::kScaled) {
          kscale = ksc[r * Hkv + hk];
          if (part == 0) vs_s[key] = vsc[r * Hkv + hk];
        }
        const uint4* kp = reinterpret_cast<const uint4*>(
            kc + r * key_stride + hk * D + part * (D / 2));
#pragma unroll
        for (int c = 0; c < HALF; ++c) {
          float kf[VEC];
          C::to_float(kp[c], kf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int d = part * (D / 2) + c * VEC + e;
#pragma unroll
            for (int gq = 0; gq < G; ++gq)
              if (gq < group) dot[gq] += kf[e] * qs[gq][d];
          }
        }
      } else if (C::kScaled && part == 0) {
        vs_s[key] = 0.f;
      }
#pragma unroll
      for (int gq = 0; gq < G; ++gq) {
        if (gq >= group) break;
        const float s =
            (dot[gq] + __shfl_xor_sync(0xffffffffu, dot[gq], 1)) * kscale;
        if (part == 0) ps[gq][key] = key < nvalid ? s : -INFINITY;
      }
    }
    __syncthreads();
    // (2) online softmax, one warp per query row.
    for (int gq = warp; gq < group; gq += kWarps) {
      const float s0 = ps[gq][lane], s1 = ps[gq][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = m_s[gq], l_old = l_s[gq];
      const float m_new = fmaxf(m_old, mx);   // finite: nvalid >= 1
      float p0 = exp2f(s0 - m_new), p1 = exp2f(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float alpha = exp2f(m_old - m_new);
      if constexpr (C::kScaled) {   // fold the V scales into the weights
        p0 *= vs_s[lane];
        p1 *= vs_s[lane + 32];
      }
      ps[gq][lane] = p0;
      ps[gq][lane + 32] = p1;
      __syncwarp();   // every lane has read m_s / l_s
      if (lane == 0) {
        alpha_s[gq] = alpha;
        m_s[gq] = m_new;
        l_s[gq] = l_old * alpha + sum;
      }
    }
    __syncthreads();
    // (3) acc[gq][j] (d = VEC dc + j) = alpha * acc + sum over this lane's
    // keys (kl, kl + KL, ...) of p * V[key, d], from the V loads issued at
    // the top of the tile.
#pragma unroll
    for (int gq = 0; gq < G; ++gq)
      if (gq < group) {
        const float a = alpha_s[gq];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[gq][j] *= a;
      }
#pragma unroll
    for (int i = 0; i < TK / KL; ++i) {
      const int key = kl + KL * i;
      if (key < nvalid) {
        float vf[VEC];
        C::to_float(vraw[i], vf);
#pragma unroll
        for (int gq = 0; gq < G; ++gq)
          if (gq < group) {
            const float p = ps[gq][key];
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[gq][j] += p * vf[j];
          }
      }
    }
    __syncthreads();   // ps / vs_s / alpha_s are rewritten by the next tile
  }

  // Sum the key lanes: the lanes of a warp that hold the same chunk
  // (lane, lane + NCH, ...), then the warps through shared memory.
#pragma unroll
  for (int gq = 0; gq < G; ++gq)
    if (gq < group)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float a = acc[gq][j];
#pragma unroll
        for (int off = NCH; off < 32; off <<= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        if (lane < NCH) red[warp][gq][dc * VEC + j] = a;
      }
  __syncthreads();
  for (int gq = 0; gq < group; ++gq) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += red[w][gq][tid];
    out[((size_t)b * H + hk * group + gq) * D + tid] =
        __float2half_rn(o / fmaxf(l_s[gq], 1e-30f));
  }
}

// Checks the shapes the kernel takes and launches it with the GQA group
// rounded up to 1, 2, 4 or 8.
template <typename T, bool kPaged>
inline int launch(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* index, const void* lengths, void* out, int B,
                  int H, int Hkv, int span, int max_blocks, int head_dim,
                  float scale, void* stream) {
  if (head_dim != D || B < 1 || B > 65535 || Hkv < 1 || H % Hkv != 0 ||
      H / Hkv > 8 || span < 1 || (kPaged && max_blocks < 1))
    return (int)cudaErrorInvalidValue;
  const int group = H / Hkv;
  const dim3 grid(Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BBT_DECODE_LAUNCH(G)                                                \
  decode_kernel<T, kPaged, G><<<grid, kThreads, 0, st>>>(                   \
      static_cast<const half*>(q), static_cast<const T*>(k),                \
      static_cast<const T*>(v), static_cast<const float*>(k_scale),         \
      static_cast<const float*>(v_scale), static_cast<const int*>(index),   \
      static_cast<const int*>(lengths), static_cast<half*>(out), H, Hkv,    \
      span, max_blocks, scale)
  if (group == 1)
    BBT_DECODE_LAUNCH(1);
  else if (group == 2)
    BBT_DECODE_LAUNCH(2);
  else if (group <= 4)
    BBT_DECODE_LAUNCH(4);
  else
    BBT_DECODE_LAUNCH(8);
#undef BBT_DECODE_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace decode
}  // namespace bbt
