// The decode-attention kernel shared by flash_decode{,_quant,_paged,
// _paged_quant}.cu: one query token per sequence against a KV cache.
//
//   q      [B, H, D]  float16 or bfloat16 (D % 128 == 0, up to
//          kMaxHeadDim = 1024)
//   K, V   bfloat16, float16 or int8 codes, rows of [Hkv, D], held either as
//          the slot cache [rows, Smax, Hkv, D] (row of key t of sequence b:
//          slots[b] * Smax + t) or as the block pool [blocks, bs, Hkv, D]
//          (row: tables[b, t / bs] * bs + t % bs)
//   scales (int8 only) f32, one per row and KV head: [rows, Smax, Hkv] or
//          [blocks, bs, Hkv], read as stored
//   lengths [B] int32, valid keys (counting the token just appended)
//   out    [B, H, D]  q's type
//   window  0, or the sliding window W >= 1 of the slot cache kernels:
//          the query at position len - 1 attends keys [max(len - W, 0),
//          len) (the JAX package's convention, kv_cache.py:805-808)
//   ml     nullptr, or the partial_stats outputs [2, B, H] f32: then out
//          is f32 [B, H, D] and holds the unnormalised accumulator, ml[0]
//          the max logit in the natural-log domain and ml[1] the sum of
//          the exponentials (the JAX kernels' partial_stats triple,
//          flash.py:476-483); a sequence of length 0 writes acc 0, m
//          -1e30 ln 2 and l 0, so a cross-shard merge weighs it 0
//   part   f32 scratch [B, Hkv, splits, group, D + 2] (unnormalised
//          accumulator, then m and l), allocated by the wrapper; unused
//          when splits == 1
//   count  int32 [B * Hkv * ceil(group / 8)], zero before the launch and
//          zero after it
//
// What bounds it on the H100: the live KV bytes of the step,
// sum_b lengths[b] * Hkv * (2 * D * sizeof(elem) + scales), over 3.35 TB/s.
//
// Design (split-KV, flash-decoding). The grid is (splits, Hkv, B): the
// keys of one (sequence, KV head) are cut into chunks of `chunk` keys (a
// multiple of the 64-key tile), one block per chunk, and each block keeps
// the whole GQA group of H / Hkv query rows together so that they share
// every K/V row it reads. The host chooses `chunk` from static sizes only
// (the span Smax or max_blocks * bs, B, Hkv and the SM count:
// kernels/flash.plan_splits), so that B * Hkv * splits is at least about
// twice the SM count; it never reads `lengths`, which would synchronise
// the stream. A block whose chunk starts at or past lengths[b] exits at
// once and reads nothing.
//
// Sliding window (slot cache kernels only, as in the JAX package; a
// windowed paged decode takes the table gather there and here). The live
// keys are [lo, len), lo = max(len - W, 0). The splits cut the live band,
// not [0, Smax): the host plans them for a static span of min(Smax, W +
// 64) keys, and each sequence's splits start on the device at base = 64
// floor(lo / 64), so a windowed decode reads at most W + 64 keys a
// sequence whatever its length. Keys of the first tile below lo are
// zero-filled, never read, and score -inf. A warp, a block or a split
// whose keys are all masked keeps m = -inf and l = 0; every merge takes a
// max of -inf as 0 in its exponents, so such a part weighs 0 and no
// exp2(-inf - (-inf)) NaN appears. Without a window (W = 0) base = lo =
// 0 and the walk and its arithmetic are the windowless kernel's.
//
// Bytes in flight: K/V tiles of 64 keys stream through a ring of kStages
// (3 for bf16: 98 KB, two blocks an SM; 4 for int8) in shared memory, fed
// by 16-byte cp.async with commit / wait_group. cp.async and not TMA bulk
// copies: every 16 bytes resolve their own row (a page of 16 rows puts
// four pages in a tile) and rows at or past the length are zero-filled
// without being read, with no producer warp to balance. One
// __syncthreads a tile: it publishes the tile's copies and frees the
// stage the next prefetch overwrites. Rows are stored with an XOR
// swizzle of their 16-byte chunks so that the score phase reads without
// bank conflicts.
//
// Per tile, each of the 8 warps owns 8 of the 64 keys and keeps its own
// online softmax (base 2, f32), so no block barrier sits inside the tile:
//   (1) four lanes per key dot its K row (every fourth 16-byte chunk) with
//       the group's query rows, pre-scaled by log2(e)/sqrt(D); int8
//       scores are multiplied by the key's K scale before the max.
//   (2) the warp's max and sum over its 8 keys update its m and l; int8
//       weights are then multiplied by the key's V scale (a V scale past
//       the length is zero-filled, never read, so a NaN scale cannot
//       reach p * vsc). Keys past the length score -inf and weigh 0.
//   (3) lane l accumulates p * V over dims 4l .. 4l+3 of the warp's keys.
// The warps merge by log-sum-exp at the end of the block. A sequence
// held by one chunk writes its output there. Otherwise each live block
// writes its partial (accumulator, m, l) to `part`, and the last block of
// the (sequence, KV head) to finish -- found by an atomic on `count`,
// which it resets to 0 -- merges the partials in split order 0, 1, ...:
// the same bits whichever block finishes last, and one launch a call. A
// sequence of length 0 has no live split: block 0 writes 0.
// The query type (float16 or bfloat16) is a template parameter: q is
// read into f32 and out written from f32, in q's type.
// The GQA group is a template parameter (1, 2, 4 or 8 rows, the group
// rounded up), so the accumulators of a small group take few registers.
// A group above 8 is cut into chunks of 8 query heads on a grid axis
// folded into blockIdx.y = hk * hchunks + chunk: each chunk re-reads the
// KV head's tiles, which L2 serves, and merges its own rows through its
// own counter. The head dim D (128 or 256) is a template parameter: at
// D = 256 a lane accumulates 8 dims, and the 3-stage bf16/f16 ring takes
// 193 KB (one block an SM).
// Head dims above 256 (D % 128 == 0 up to kMaxHeadDim, the wide
// instances, kWide): a 64-key tile of K at D = 512 is 64 KB in bf16, so
// neither the ring nor a lane's accumulators (G x D / 32 floats) could
// hold a whole head. The head is cut into slices of 128 columns, one block
// a slice, and the D / 128 slices of one (sequence, KV head, group chunk,
// split) run as one thread-block cluster of (1, D / 128, 1) blocks (the
// slice is the fastest axis of blockIdx.y = (hk * hchunks + chunk) *
// slices + slice, so the cluster's rank is the slice; D = 1024 makes 8,
// the portable cluster size). Each block is the D = 128 kernel for its
// slice: its ring streams its own 128 columns of K and V (and the
// scales), swizzle and all, so K and V are read once. The scores need all
// of D: each block dots its columns, writes the partial scores of the
// tile ([64 keys][8 rows] f32, double-buffered) to its own shared memory,
// and after one cluster barrier a tile (arrive.release / wait.acquire)
// every block sums all slices' partials through distributed shared
// memory in slice order 0 .. n-1. The blocks of a cluster then hold the
// same scores, m and l bit for bit, and the score work is done once. The
// second buffer lets a block write tile i + 1's partials while a slower
// one still reads tile i's: no block passes barrier i + 1 before every
// block has read tile i. int8's K scale multiplies the summed score. The
// blocks of a cluster walk the same keys (start, length and tiles are
// the cluster's), so they take the same path, early exit included; a
// cluster barrier after the walk keeps a block from exiting while another
// may still read its partials. Each slice keeps its own partials and
// counter, so the split merge runs per slice as before. One instance (8
// query rows a block) serves every group, which keeps the build short.
// Each entry point launches on the caller's stream and returns the
// launch's cudaError_t.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace bbt {
namespace decode {

constexpr int TK = 64;          // keys per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KW = TK / kWarps; // keys of a warp in a tile (8)
constexpr int LPK = 32 / KW;    // lanes of a key in the score phase (4)
constexpr int kMaxSplits = 1024; // the merge's weights fit the ring
constexpr int kMaxG = 8;         // query rows a block: larger groups chunk
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float kEmptyM = -1e30f;   // base-2 m of a shard with no live key

// Stored K/V -> floats: a 16-byte chunk (score phase) and the 4 values of
// one lane (PV phase).
template <typename T>
struct Codes;

template <>
struct Codes<__nv_bfloat16> {
  static constexpr int N = 8;          // values per 16-byte chunk
  static constexpr bool kScaled = false;
  static constexpr int kStages = 3;
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
  // values 4l .. 4l+3 of a row (8 bytes) at `p`
  __device__ __forceinline__ static void four(const unsigned char* p,
                                              float* f) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
};

template <>
struct Codes<half> {
  static constexpr int N = 8;
  static constexpr bool kScaled = false;
  static constexpr int kStages = 3;
  __device__ __forceinline__ static void to_float(const uint4& raw,
                                                  float* f) {
    const half2* h = reinterpret_cast<const half2*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __half22float2(h[e]);
      f[2 * e] = x.x;
      f[2 * e + 1] = x.y;
    }
  }
  __device__ __forceinline__ static void four(const unsigned char* p,
                                              float* f) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const half2* h = reinterpret_cast<const half2*>(&raw);
    const float2 a = __half22float2(h[0]), b = __half22float2(h[1]);
    f[0] = a.x;
    f[1] = a.y;
    f[2] = b.x;
    f[3] = b.y;
  }
};

template <>
struct Codes<int8_t> {
  static constexpr int N = 16;
  static constexpr bool kScaled = true;
  static constexpr int kStages = 4;
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
  __device__ __forceinline__ static void four(const unsigned char* p,
                                              float* f) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    f[0] = static_cast<float>(c.x);
    f[1] = static_cast<float>(c.y);
    f[2] = static_cast<float>(c.z);
    f[3] = static_cast<float>(c.w);
  }
};

constexpr int kMaxHeadDim = 1024;   // kernels/flash.py DECODE_MAX_HEAD_DIM
constexpr int kSlice = 128;          // a wide instance's output columns
constexpr int kMaxSlices = kMaxHeadDim / kSlice;   // a cluster's blocks

// D: the columns a block's K and V tiles and accumulators hold (the head
// dim, or kSlice in a wide instance).
template <typename T, int D>
struct Layout {
  static constexpr int kRowBytes = D * (int)sizeof(T);   // 128 ... 512
  static constexpr int kChunks = kRowBytes / 16;         // 8 ... 32
  static constexpr int kTileBytes = TK * kRowBytes;
  static constexpr int kStages = Codes<T>::kStages;
  // the ring: per stage the K tile, the V tile, K scales, V scales
  static constexpr int kStageBytes = 2 * kTileBytes + 2 * TK * 4;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // Physical 16-byte chunk of logical chunk c of row r: c ^ (LPK r mod
  // chunks). The LPK lanes of a key read chunks LPK j + part, and the two
  // keys of an 8-lane phase then land on eight distinct 16-byte bank
  // groups.
  __device__ __forceinline__ static int swz(int r, int c) {
    return c ^ ((r * LPK) & (kChunks - 1));
  }
};

// Dynamic shared memory: the ring, the block's query columns [G][D] f32,
// the weights of each warp [warps][G][KW], and in a wide instance the
// tile's partial scores [2][TK][G] f32 that the cluster reads. After the
// walk the ring holds the warps' partials, then the split weights of the
// merge.
template <int G, int D, bool kWide>
constexpr int smem_bytes(int ring) {
  return ring + G * D * 4 + kWarps * G * KW * 4 + (kWide ? 2 * TK * G * 4 : 0);
}

// Distributed shared memory of a cluster (sm_90): the address of the same
// shared variable in block `rank`, an 8-byte read there, and the cluster
// barrier (release of this block's writes, acquire of the others').
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(s), "r"(rank));
  return r;
}
__device__ __forceinline__ float2 ld_cluster2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// index: slots [B] (slot cache) or tables [B, max_blocks] (block pool);
// span: Smax (slot cache) or the block size (block pool).
// The query and output type: float16 or bfloat16.
__device__ __forceinline__ float q_float(half x) { return __half2float(x); }
__device__ __forceinline__ float q_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename Q>
__device__ __forceinline__ Q q_from(float x);
template <>
__device__ __forceinline__ half q_from<half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 q_from<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, typename Q, bool kPaged, int G, int D, bool kWide>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const Q* __restrict__ q, const T* __restrict__ kc,
                  const T* __restrict__ vc, const float* __restrict__ ksc,
                  const float* __restrict__ vsc,
                  const int* __restrict__ index,
                  const int* __restrict__ lengths, Q* __restrict__ out,
                  float* __restrict__ ml, float* __restrict__ part,
                  int* __restrict__ count, int H,
                  int Hkv, int span, int max_blocks, int chunk, int window,
                  int head_dim, float scale) {
  using C = Codes<T>;
  using L = Layout<T, D>;
  constexpr int VEC = C::N;
  constexpr int DPL = D / 32;             // dims a lane accumulates
  constexpr int S = L::kStages;
  constexpr int CPL = L::kChunks / LPK;   // K chunks a lane dots
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                 // [S][stage]
  // the head dim (a wide instance's is a runtime multiple of its slice)
  // and the block's slice of it, which is its rank in the cluster
  const int DK = kWide ? head_dim : D;
  const int nsl = kWide ? head_dim / D : 1;
  const int sl = kWide ? (int)blockIdx.y % nsl : 0;
  float* qs = reinterpret_cast<float*>(smem + L::kRingBytes);  // [G][D]
  float* ps = qs + G * D;                                // [warps][G][KW]
  float* xs = ps + kWarps * G * KW;           // wide: [2][TK][G] partials

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, b = blockIdx.z;
  const int hchunks = gridDim.y / (Hkv * nsl);
  const int hy = (int)blockIdx.y / nsl;
  const int hk = hy / hchunks, hc = hy % hchunks;
  const int splits = gridDim.x;
  const int group = H / Hkv;
  const int rows = min(G, group - hc * G);   // query rows of this block
  const int h0 = hk * group + hc * G;        // their first head
  // The slot loads beside the length, not after it.
  const size_t slot_base = kPaged ? 0 : (size_t)index[b] * span;
  const int* table = index + (size_t)b * max_blocks;
  const int len = lengths[b];
  // live keys [lo, len); the splits start at the tile holding lo. Key t
  // is live iff (unsigned)(t - lo) < band: one compare, as the windowless
  // kernel's t < len (lo = 0 there).
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const unsigned band = (unsigned)(len - lo);
  const int base = lo / TK * TK;
  const int start = base + split * chunk;
  // Row gq's output at dim d from its merged state: the normalised
  // output in q's type, or (partial_stats, ml != nullptr) the f32
  // accumulator and, once a row, m in the natural-log domain and l.
  auto emit = [&](int gq, int d, float o, float M, float lsum) {
    const size_t row = (size_t)b * H + h0 + gq;
    const size_t at = row * DK + sl * D + d;
    if (ml == nullptr) {
      out[at] = q_from<Q>(o / fmaxf(lsum, 1e-30f));
      return;
    }
    reinterpret_cast<float*>(out)[at] = o;
    if (d == 0 && sl == 0) {
      ml[row] = (M == -INFINITY ? kEmptyM : M) * LN2;
      ml[(size_t)gridDim.z * H + row] = lsum;
    }
  };
  if (start >= len) {
    if (len <= 0 && split == 0)   // no live key: the output is 0
      for (int i = tid; i < rows * D; i += kThreads)
        emit(i / D, i % D, 0.f, -INFINITY, 0.f);
    return;
  }
  const int end = min(start + chunk, len);
  const int ntiles = (end - start + TK - 1) / TK;
  const size_t key_stride = (size_t)Hkv * DK;
  // Cache row of key t; only called for t < len.
  auto row_of = [&](int t) -> size_t {
    if constexpr (kPaged)
      return (size_t)__ldg(table + t / span) * span + t % span;
    else
      return slot_base + t;
  };
  // Copies of tile i (keys start + 64 i ...) into stage st; rows outside
  // [lo, len) are zero-filled and not read.
  auto load_tile = [&](int i, int st) {
    unsigned char* kt = ring + st * L::kStageBytes;
    unsigned char* vt = kt + L::kTileBytes;
    float* kst = reinterpret_cast<float*>(vt + L::kTileBytes);
    float* vst = kst + TK;
    const int t0 = start + i * TK;
#pragma unroll
    for (int j = 0; j < TK * L::kChunks / kThreads; ++j) {
      const int idx = tid + j * kThreads;
      const int r = idx / L::kChunks, c = idx % L::kChunks;
      const bool live = (unsigned)(t0 + r - lo) < band;
      // the block's columns of the key's row (its slice in a wide instance)
      const size_t off =
          live ? row_of(t0 + r) * key_stride + hk * DK + sl * D : 0;
      const int dst = r * L::kRowBytes + L::swz(r, c) * 16;
      cp_async16(kt + dst,
                 reinterpret_cast<const unsigned char*>(kc + off) + c * 16,
                 live);
      cp_async16(vt + dst,
                 reinterpret_cast<const unsigned char*>(vc + off) + c * 16,
                 live);
    }
    if constexpr (C::kScaled) {
      if (tid < 2 * TK) {
        const int r = tid % TK;
        const bool live = (unsigned)(t0 + r - lo) < band;
        const size_t at = live ? row_of(t0 + r) * Hkv + hk : 0;
        cp_async4((tid < TK ? kst : vst) + r, (tid < TK ? ksc : vsc) + at,
                  live);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < ntiles) load_tile(i, i);
    cp_async_commit();
  }
  for (int i = tid; i < rows * D; i += kThreads)
    qs[i] = q_float(q[((size_t)b * H + h0 + i / D) * DK + sl * D + i % D]) *
            (scale * LOG2E);

  // Per warp: running max m (base 2) and sum l of each query row
  // (replicated in every lane), the lane's accumulator over dims
  // DPL lane .. DPL lane + DPL - 1.
  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int gq = 0; gq < G; ++gq) {
    m[gq] = -INFINITY;
    l[gq] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[gq][e] = 0.f;
  }
  const int kloc = lane / LPK, pl = lane % LPK;   // phase (1): key, part
  const int key = warp * KW + kloc;               // key within the tile
  float* pw = ps + warp * G * KW;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();   // tile i visible; stage (i - 1) % S is free
    if (i + S - 1 < ntiles) load_tile(i + S - 1, (i + S - 1) % S);
    cp_async_commit();
    const unsigned char* kt = ring + (i % S) * L::kStageBytes;
    const unsigned char* vt = kt + L::kTileBytes;
    const float* kst = reinterpret_cast<const float*>(vt + L::kTileBytes);
    const float* vst = kst + TK;
    const int kabs = start + i * TK + key;
    const bool live = (unsigned)(kabs - lo) < band;

    // (1) scores: this lane's CPL chunks, two sums per row for ILP
    float s0[G], s1[G];
#pragma unroll
    for (int gq = 0; gq < G; ++gq) s0[gq] = s1[gq] = 0.f;
    // the dot of the lane's 16-byte chunk c of the key's K row with the
    // query rows' values c * VEC ...
    auto dot = [&](const uint4& raw, int c) {
      float kf[VEC];
      C::to_float(raw, kf);
#pragma unroll
      for (int gq = 0; gq < G; ++gq) {
        if (gq >= rows) break;
        const float4* qv = reinterpret_cast<const float4*>(qs + gq * D +
                                                           c * VEC);
#pragma unroll
        for (int e4 = 0; e4 < VEC / 4; ++e4) {
          const float4 qq = qv[e4];
          float& acc_s = (e4 & 1) ? s1[gq] : s0[gq];
          acc_s += kf[4 * e4] * qq.x + kf[4 * e4 + 1] * qq.y +
                   kf[4 * e4 + 2] * qq.z + kf[4 * e4 + 3] * qq.w;
        }
      }
    };
    const unsigned char* krow = kt + key * L::kRowBytes;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = LPK * j + pl;
      dot(*reinterpret_cast<const uint4*>(krow + L::swz(key, c) * 16), c);
    }
    // the key's dot over the block's columns, in every lane of the key
    auto key_dot = [&](int gq) {
      float sc = s0[gq] + s1[gq];
#pragma unroll
      for (int w = 1; w < LPK; w <<= 1)
        sc += __shfl_xor_sync(0xffffffffu, sc, w);
      return sc;
    };
    float sum[G];   // wide: the cluster's sum of the slices' dots
    if constexpr (kWide) {
      static_assert(G == 2 * LPK, "a lane of a key sums two rows");
      float* mine = xs + ((i & 1) * TK + key) * G;
#pragma unroll
      for (int gq = 0; gq < G; ++gq) sum[gq] = gq < rows ? key_dot(gq) : 0.f;
      if (pl == 0)
#pragma unroll
        for (int g4 = 0; g4 < G; g4 += 4)
          *reinterpret_cast<float4*>(mine + g4) =
              make_float4(sum[g4], sum[g4 + 1], sum[g4 + 2], sum[g4 + 3]);
      cluster_sync();
      // lane pl of the key sums rows 2 pl, 2 pl + 1 over the slices in
      // slice order (every read in flight at once), then the key's lanes
      // swap their sums
      float2 x[kMaxSlices];
#pragma unroll
      for (int r = 0; r < kMaxSlices; ++r)
        if (r < nsl) x[r] = ld_cluster2(cluster_addr(mine + 2 * pl, r));
      float2 mine2 = make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kMaxSlices; ++r)
        if (r < nsl) {
          mine2.x += x[r].x;
          mine2.y += x[r].y;
        }
#pragma unroll
      for (int gq = 0; gq < G; ++gq) {
        const float v = (gq & 1) ? mine2.y : mine2.x;
        sum[gq] = __shfl_sync(0xffffffffu, v, (lane & ~(LPK - 1)) + gq / 2);
      }
    }
    float ksc_k = 1.f, vsc_k = 1.f;
    if constexpr (C::kScaled) {
      ksc_k = kst[key];
      vsc_k = vst[key];
    }
    // (2) the warp's online softmax over its KW keys
#pragma unroll
    for (int gq = 0; gq < G; ++gq) {
      if (gq >= rows) break;
      float sc;
      if constexpr (kWide)
        sc = sum[gq];
      else
        sc = key_dot(gq);
      sc = live ? sc * ksc_k : -INFINITY;
      float mx = sc;
#pragma unroll
      for (int w = LPK; w < 32; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[gq], mx);
      // a warp with no live key so far keeps m = -inf and weighs 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p = exp2f(sc - m_use);
      float sum = p;   // each key once among the lanes of one part
#pragma unroll
      for (int w = LPK; w < 32; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float alpha = exp2f(m[gq] - m_use);
      l[gq] = l[gq] * alpha + sum;
      m[gq] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[gq][e] *= alpha;
      if (pl == 0) pw[gq * KW + kloc] = p * vsc_k;
    }
    __syncwarp();
    // (3) acc += p * V over the warp's keys, dims DPL lane .. + DPL - 1
#pragma unroll
    for (int k4 = 0; k4 < KW; k4 += 4) {
      float4 pv[G];
#pragma unroll
      for (int gq = 0; gq < G; ++gq)
        if (gq < rows)
          pv[gq] = *reinterpret_cast<const float4*>(pw + gq * KW + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int r = warp * KW + k4 + kk;
        float vf[DPL];
#pragma unroll
        for (int h = 0; h < DPL / 4; ++h) {
          const int byte = (lane * DPL + 4 * h) * (int)sizeof(T);
          C::four(vt + r * L::kRowBytes + L::swz(r, byte / 16) * 16 +
                      byte % 16,
                  vf + 4 * h);
        }
#pragma unroll
        for (int gq = 0; gq < G; ++gq)
          if (gq < rows) {
            const float p = kk == 0   ? pv[gq].x
                            : kk == 1 ? pv[gq].y
                            : kk == 2 ? pv[gq].z
                                      : pv[gq].w;
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[gq][e] += p * vf[e];
          }
      }
    }
    __syncwarp();   // pw is rewritten by the next tile
  }

  // no block of the cluster exits while another may read its partials
  if constexpr (kWide) cluster_sync();
  // Merge the warps (log-sum-exp) through the freed ring.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);   // [warps][G][D]
  float* mw = red + kWarps * G * D;              // [warps][G]
  float* lw = mw + kWarps * G;
#pragma unroll
  for (int gq = 0; gq < G; ++gq)
    if (gq < rows) {
#pragma unroll
      for (int h = 0; h < DPL / 4; ++h)
        *reinterpret_cast<float4*>(red + (warp * G + gq) * D + DPL * lane +
                                   4 * h) =
            make_float4(acc[gq][4 * h], acc[gq][4 * h + 1],
                        acc[gq][4 * h + 2], acc[gq][4 * h + 3]);
      if (lane == 0) {
        mw[warp * G + gq] = m[gq];
        lw[warp * G + gq] = l[gq];
      }
    }
  __syncthreads();
  // kThreads / D rows at once (2 at D = 128, 1 at D = 256)
  const int d = tid % D, g0 = tid / D;
  const int nlive = min((len - base + chunk - 1) / chunk, splits);
  // partial of (b, hk, split): [group][D + 2]; this block's rows start at
  // hc * G
  // (KV head, slice) pairs: a wide instance's slices merge apart
  const size_t hv = (size_t)b * Hkv * nsl + (size_t)hk * nsl + sl;
  const size_t part_stride = (size_t)group * (D + 2);
  float* mine = part + (hv * splits + split) * part_stride +
                (size_t)hc * G * (D + 2);
  for (int gq = g0; gq < rows; gq += kThreads / D) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mw[w * G + gq]);
    // a window can mask every key of a warp: it weighs 0 (and M = -inf
    // only where the whole chunk is masked, which then writes m = -inf,
    // l = 0)
    const float Mu = M == -INFINITY ? 0.f : M;
    float o = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(mw[w * G + gq] - Mu);
      o += wt * red[(w * G + gq) * D + d];
      lsum += wt * lw[w * G + gq];
    }
    if (nlive == 1) {
      emit(gq, d, o, M, lsum);
    } else {
      mine[gq * (D + 2) + d] = o;
      if (d == 0) {
        mine[gq * (D + 2) + D] = M;
        mine[gq * (D + 2) + D + 1] = lsum;
      }
    }
  }
  if (nlive == 1) return;

  // The last live block of (b, hk, hc) merges the partials in split
  // order.
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = count + (((size_t)b * Hkv + hk) * hchunks + hc) * nsl + sl;
    last = atomicAdd(cnt, 1) == nlive - 1;
    if (last) *cnt = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* p0 = part + hv * splits * part_stride +
                    (size_t)hc * G * (D + 2);
  // Warp gq: the row's max M over the splits and the weights
  // exp2(m_s - M) into shared memory ([G][nlive], over the ring), then
  // sum_s w_s l_s. A split whose keys are all masked has m = -inf and
  // weighs 0.
  float* wts = red;
  float* lsm = wts + G * nlive;
  float* msm = lsm + G;
  if (warp < rows) {
    const int gq = warp;
    float M = -INFINITY;
    for (int sp = lane; sp < nlive; sp += 32) {
      const float ms = __ldcg(p0 + sp * part_stride + gq * (D + 2) + D);
      wts[gq * nlive + sp] = ms;
      M = fmaxf(M, ms);
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, w));
    if (M == -INFINITY) M = 0.f;
    float lsum = 0.f;
    for (int sp = lane; sp < nlive; sp += 32) {
      const float wt = exp2f(wts[gq * nlive + sp] - M);
      wts[gq * nlive + sp] = wt;
      lsum += wt * __ldcg(p0 + sp * part_stride + gq * (D + 2) + D + 1);
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, w);
    if (lane == 0) {
      lsm[gq] = lsum;
      msm[gq] = M;
    }
  }
  __syncthreads();
  for (int gq = g0; gq < rows; gq += kThreads / D) {
    const float* pd = p0 + gq * (D + 2) + d;
    float o = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < nlive; ++sp)
      o += wts[gq * nlive + sp] * __ldcg(pd + sp * part_stride);
    emit(gq, d, o, msm[gq], lsm[gq]);
  }
}

// The launch's arguments past the grid, passed down unchanged.
struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *index, *lengths;
  void *out, *ml, *part, *count;
  int H, Hkv, span, max_blocks, chunk, window, head_dim;
  float scale;
};

template <typename T, typename Q, bool kPaged, int G, int D, bool kWide>
inline cudaError_t launch_g(dim3 grid, cudaStream_t st, const Args& a) {
  using L = Layout<T, D>;
  // after the walk the ring holds the warps' partials, then the merge's
  // split weights
  static_assert(L::kRingBytes >= kWarps * G * D * 4 + 2 * kWarps * G * 4 &&
                    L::kRingBytes >= G * kMaxSplits * 4 + 2 * G * 4,
                "the merges fit the ring");
  constexpr int bytes = smem_bytes<G, D, kWide>(L::kRingBytes);
  static bool smem_set[kMaxDevices];
  auto* kernel = decode_kernel<T, Q, kPaged, G, D, kWide>;
  cudaError_t e = set_max_smem_once(kernel, bytes, smem_set);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  // a wide instance's slices of one (sequence, KV head, chunk, split) are
  // one cluster
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = a.head_dim / D;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = kWide ? 1 : 0;
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const Q*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const int*>(a.index),
      static_cast<const int*>(a.lengths), static_cast<Q*>(a.out),
      static_cast<float*>(a.ml), static_cast<float*>(a.part),
      static_cast<int*>(a.count), a.H, a.Hkv, a.span, a.max_blocks, a.chunk,
      a.window, a.head_dim, a.scale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, typename Q, bool kPaged, int D>
inline cudaError_t launch_d(int group, dim3 grid, cudaStream_t st,
                            const Args& a) {
  if (group == 1) return launch_g<T, Q, kPaged, 1, D, false>(grid, st, a);
  if (group == 2) return launch_g<T, Q, kPaged, 2, D, false>(grid, st, a);
  if (group <= 4) return launch_g<T, Q, kPaged, 4, D, false>(grid, st, a);
  return launch_g<T, Q, kPaged, kMaxG, D, false>(grid, st, a);
}

// Checks the shapes the kernel takes and launches it over (splits,
// Hkv * hchunks * slices, B) blocks, hchunks = ceil(group / 8), slices =
// D / 128 above D = 256 (else 1), with the rows of a block rounded up to
// 1, 2, 4 or 8, the head dim D % 128 == 0 up to kMaxHeadDim and q and out
// bfloat16 (q_bf16) or float16. `part` holds B * H * splits * (D + 2 *
// slices) floats and `count` B * Hkv * hchunks * slices ints when splits >
// 1. `window` is
// 0 or >= 1, and 0 for the block pool. `ml` non-null asks for the
// partial_stats outputs (out f32 [B, H, D], ml f32 [2, B, H]; slot cache,
// no window).
template <typename T, bool kPaged>
inline int launch(const void* q, const void* k, const void* v,
                  const void* k_scale, const void* v_scale,
                  const void* index, const void* lengths, void* out,
                  void* ml, void* part, void* count, int B, int H, int Hkv, int span,
                  int max_blocks, int chunk, int splits, int head_dim,
                  int q_bf16, int window, float scale, void* stream) {
  if (Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int group = H / Hkv;
  const int hchunks = (group + kMaxG - 1) / kMaxG;
  const bool wide = head_dim > 256;
  const int slices = wide ? head_dim / kSlice : 1;
  if (head_dim < 128 || head_dim % 128 != 0 || head_dim > kMaxHeadDim ||
      B < 1 || B > 65535 || (long long)Hkv * hchunks * slices > 65535 ||
      span < 1 ||
      (kPaged && max_blocks < 1) || chunk < TK || chunk % TK != 0 ||
      splits < 1 || splits > kMaxSplits || window < 0 ||
      (kPaged && window != 0) || (ml != nullptr && (kPaged || window)) ||
      (splits > 1 && (part == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(splits, Hkv * hchunks * slices, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = group < kMaxG ? group : kMaxG;
  const Args a{q,     k,     v,      k_scale, v_scale,    index,
               lengths, out, ml,     part,    count,      H,
               Hkv,   span,  max_blocks, chunk, window,  head_dim, scale};
  // the wide instances hold 8 query rows a block whatever the group (a
  // lane's accumulators are 4 dims a row): one instance a query type
  if (wide)
    return (int)(q_bf16 ? launch_g<T, __nv_bfloat16, kPaged, kMaxG, kSlice,
                                   true>(grid, st, a)
                        : launch_g<T, half, kPaged, kMaxG, kSlice, true>(
                              grid, st, a));
  if (head_dim == 128)
    return (int)(q_bf16 ? launch_d<T, __nv_bfloat16, kPaged, 128>(rows, grid,
                                                                  st, a)
                        : launch_d<T, half, kPaged, 128>(rows, grid, st, a));
  return (int)(q_bf16
                   ? launch_d<T, __nv_bfloat16, kPaged, 256>(rows, grid, st, a)
                   : launch_d<T, half, kPaged, 256>(rows, grid, st, a));
}

}  // namespace decode
}  // namespace bbt
