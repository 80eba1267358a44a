// flash_attention_fwd: causal prefill attention, Q [B, S, H, D] x
// K/V [B, S, Hkv, D] -> O [B, S, H, D], all float16 or all bfloat16 (a
// template parameter: wgmma's .f16 or .bf16 form), D = 128, GQA with
// group = H / Hkv, and an optional sliding window: row i attends keys
// (i - window, i].
//
// Replaces bitblas_tpu/kernels/flash.py:make_flash_attention (pallas_call
// at :393 for the causal walk and :415), for causal prefill, with or
// without a window, without trans_k.
//
// What bounds it on the H100: at the slice's prompts (S = 256, 512,
// D = 128) the bytes, Q, K and V read once and O written once
// (8*B*S*H*D over 3.35 TB/s); the causal half of the 4*B*H*S^2*D product
// FLOPs over the tensor-core rate takes less until S reaches ~1,200. With
// a window the product shrinks to 4*B*H*D*sum_i min(i + 1, window).
//
// Design (FlashAttention-3 form on wgmma and TMA). One block per (64-row q
// tile, batch * head): a consumer warpgroup (warps 0-3) owns the 64 q rows
// and a producer warp (warp 4) issues the copies. 64 rows a block at every
// S, so the main path's B = 1, H = 32 prompts give 32 * S / 64 blocks
// (128 at S = 256, 256 at S = 512; 80 KB of shared memory, two blocks an
// SM); 128 rows would leave half the card idle at S = 256.
//   - TMA: one thread loads Q once and K/V tiles of 64 keys into a
//     two-stage ring, each on an mbarrier with its byte count; consumers
//     release a stage through an "empty" mbarrier (128 arrivals). A
//     128-byte swizzle limits a box to 64 2-byte columns, so every 64 x 128
//     tile is two 64 x 64 boxes, and the wgmma descriptors step across the
//     two halves. The tensor maps depend on the pointers: the host encodes
//     them per call (cuTensorMapEncodeTiled through
//     cudaGetDriverEntryPoint, no -lcuda) and passes them as
//     __grid_constant__ parameters. The mbarrier, TMA, tensor-map and
//     wgmma descriptor helpers are hopper.cuh's, shared with
//     dense_matmul.cu.
//   - Q is scaled in shared memory by log2(e)/sqrt(D) in f32 and rounded
//     to Q's type (the fold of flash.py:437-441), so scores are base 2.
//   - S = Q K^T: wgmma.mma_async m64n64k16, Q and K both from shared
//     memory, K-major, f32 accumulators in registers.
//   - f32 online softmax in registers; only the diagonal tile and, with a
//     window, the band-edge tiles are masked.
//   - O += P V: P is the score accumulator rounded to pairs of V's type,
//     which is wgmma's A-register layout; V comes from shared memory as a
//     transposed (MN-major) B, one m64n64k16 per 64-dim half of D.
//   - Each tile runs S, softmax, PV in turn; two blocks an SM overlap
//     one block's softmax with the other's products (issuing S_j ahead
//     of the softmax of S_{j-1}, FlashAttention-3's overlap within the
//     warpgroup, measured slower at S = 512 and 1024).
// The causal walk runs KV tiles lo .. qt: the skip is a loop bound, so
// masked tiles are never loaded. Without a window lo = 0; with one, lo =
// max(0, (64 qt - window + 1) / 64), the first tile that holds a key of
// the band of the tile's first row (flash.py:183-208), and the per-row
// lower mask (key <= row - window) runs only on band-edge tiles, those
// below 64 qt + 64 - window (flash.py:333-357). A row's first visited tile
// can then be all masked (S = 8192, window 4096: rows 4096-4159 start at
// tile 0, and row 4159's band begins at key 64), so the online softmax
// takes a max of -inf as 0 for its exponents: the tile adds nothing and
// no exp2(-inf - (-inf)) NaN (the trap of flash.py:186-192) appears. The
// JAX kernel walks diagonal-first instead; here the order is ascending in
// both cases, so a window >= S gives the windowless walk, bit for bit.
// Longest walks first: blockIdx.y = 0 takes the last q tile of every
// head. Pad rows of a prompt bucket sit after the real rows, so causality
// keeps them out of every real row.

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int kStages = 2;
constexpr int kConsumers = 128;              // one warpgroup
constexpr int kThreads = kConsumers + 32;    // + the producer warp
constexpr int kBox = 64 * 64 * 2;            // a 64 x 64 box, 8 KB
constexpr int kTile = 2 * kBox;              // 64 rows x 128 dims
constexpr int kSmemBytes = 1024 /* alignment */ + kTile * (1 + 2 * kStages)
                           + 128 /* barriers */;

struct Bars {
  uint64_t q;
  uint64_t full[kStages], empty[kStages];
};

using bbt::desc_sw128;
using bbt::fence_regs;
using bbt::keep_regs;
using bbt::mbar_arrive;
using bbt::mbar_expect_tx;
using bbt::mbar_init;
using bbt::mbar_wait;
using bbt::smem_u32;
using bbt::wgmma_commit;
using bbt::wgmma_fence;
using bbt::wgmma_wait;

// The element type: float16 or bfloat16 pairs to and from float2.
template <typename T>
struct Elem;

template <>
struct Elem<half> {
  __device__ __forceinline__ static float2 to2(uint32_t x) {
    return __half22float2(*reinterpret_cast<const half2*>(&x));
  }
  __device__ __forceinline__ static uint32_t from2(float lo, float hi) {
    const half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float2 to2(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  }
  __device__ __forceinline__ static uint32_t from2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static constexpr CUtensorMapDataType kMap =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

#define BBT_WGMMA_D                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define BBT_WGMMA_REGS                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
  "%28, %29, %30, %31}, "

// d (64 x 64, f32) = A (64 x 16, shared, K-major) B (16 x 64, shared,
// K-major) + (scale_d ? d : 0).
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " BBT_WGMMA_REGS
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : BBT_WGMMA_D
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BBT_WGMMA_REGS
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : BBT_WGMMA_D
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d += A (64 x 16, registers) B (16 x 64, shared, MN-major: N contiguous,
// so transposed).
template <typename T>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (std::is_same<T, half>::value) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " BBT_WGMMA_REGS
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : BBT_WGMMA_D
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " BBT_WGMMA_REGS
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : BBT_WGMMA_D
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// Online softmax over one tile's scores s (rows g and g + 8 of the warp,
// base 2, masked entries -inf): updates the running max m and sum l,
// returns the factors alpha that rescale O, and packs the weights rounded
// to T into wgmma's A fragments: p[4 ks + i] for keys 16 ks .. 16 ks + 15
// (the accumulators of key columns 16 ks .. are the A layout of k16). A
// row whose max is still -inf (all of its keys so far masked, which a
// window allows) takes 0 in the exponents: its weights and alpha are 0,
// and a finite max is used as it is.
template <typename T>
__device__ __forceinline__ void softmax_tile(float (&s)[32],
                                             uint32_t (&p)[16],
                                             float& m_lo, float& m_hi,
                                             float& l_lo, float& l_hi,
                                             float& alpha_lo,
                                             float& alpha_hi) {
  float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
  for (int n = 0; n < BKV / 8; ++n) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[4 * n], s[4 * n + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, w));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, w));
  }
  const float mu_lo = mx_lo == -INFINITY ? 0.f : mx_lo;
  const float mu_hi = mx_hi == -INFINITY ? 0.f : mx_hi;
  alpha_lo = exp2f(m_lo - mu_lo);
  alpha_hi = exp2f(m_hi - mu_hi);
  m_lo = mx_lo;
  m_hi = mx_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int n = 0; n < BKV / 8; ++n) {
    s[4 * n] = exp2f(s[4 * n] - mu_lo);
    s[4 * n + 1] = exp2f(s[4 * n + 1] - mu_lo);
    s[4 * n + 2] = exp2f(s[4 * n + 2] - mu_hi);
    s[4 * n + 3] = exp2f(s[4 * n + 3] - mu_hi);
    sum_lo += s[4 * n] + s[4 * n + 1];
    sum_hi += s[4 * n + 2] + s[4 * n + 3];
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, w);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, w);
  }
  l_lo = l_lo * alpha_lo + sum_lo;
  l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = Elem<T>::from2(s[2 * i], s[2 * i + 1]);
}

// S = Q K^T over D in 8 steps of 16: steps 0-3 in the first 64-dim box
// (32 bytes a step within the 128-byte swizzled row), 4-7 in the second.
template <typename T>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss<T>(s, desc_sw128(q_addr + off), desc_sw128(k_addr + off),
                kk > 0);
  }
  wgmma_commit();
}

// O += P V in 4 steps of 16 keys, one m64n64k16 per 64-dim half of V (16
// rows of 128 bytes = 2048 bytes a step).
template <typename T>
__device__ __forceinline__ void issue_pv(float (&o0)[32], float (&o1)[32],
                                         const uint32_t (&p)[16],
                                         uint32_t v_addr) {
#pragma unroll
  for (int ks = 0; ks < BKV / 16; ++ks) {
    const uint32_t a[4] = {p[4 * ks], p[4 * ks + 1], p[4 * ks + 2],
                           p[4 * ks + 3]};
    wgmma_rs_t<T>(o0, a, desc_sw128(v_addr + ks * 2048));
    wgmma_rs_t<T>(o1, a, desc_sw128(v_addr + kBox + ks * 2048));
  }
  wgmma_commit();
}

// window: 0 for none, else >= 1 (row i attends keys (i - window, i]).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               T* __restrict__ O, int S, int H, int Hkv,
                               int window, float qscale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;                        // 2 boxes: 64 x 128
  unsigned char* ks = smem + kTile;                // [stage] K tile
  unsigned char* vs = ks + kStages * kTile;        // [stage] V tile
  Bars* bars = reinterpret_cast<Bars*>(smem + kTile * (1 + 2 * kStages));

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int qt = S / BQ - 1 - blockIdx.y;   // longest walks first
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  // BQ == BKV: tiles lo..qt, the last diagonal; below lo no key of the
  // tile's band (q0 - window + 1 is the lowest key of row q0)
  const int lo = window > 0 ? max(0, (q0 - window + 1) / BKV) : 0;
  const int nkv = qt + 1 - lo;
  const int row0 = b * S;   // first token row of sequence b

  if (tid == 0) {
    mbar_init(&bars->q, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&bars->full[i], 1);
      mbar_init(&bars->empty[i], kConsumers);
    }
    bbt::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {   // the producer warp: one thread issues
    if (tid == kConsumers) {
      mbar_expect_tx(&bars->q, kTile);
      bbt::tma_load_3d(qs, &tq, &bars->q, 0, h, row0 + q0);
      bbt::tma_load_3d(qs + kBox, &tq, &bars->q, 64, h, row0 + q0);
      for (int j = 0; j < nkv; ++j) {
        const int st = j % kStages;
        // use u = j / kStages of a stage waits for the consumers' release
        // of use u - 1
        if (j >= kStages) mbar_wait(&bars->empty[st], (j / kStages - 1) & 1);
        uint64_t* full = &bars->full[st];
        const int row = row0 + (lo + j) * BKV;
        mbar_expect_tx(full, 2 * kTile);
        bbt::tma_load_3d(ks + st * kTile, &tk, full, 0, hk, row);
        bbt::tma_load_3d(ks + st * kTile + kBox, &tk, full, 64, hk, row);
        bbt::tma_load_3d(vs + st * kTile, &tv, full, 0, hk, row);
        bbt::tma_load_3d(vs + st * kTile + kBox, &tv, full, 64, hk, row);
      }
    }
    return;
  }

  // The consumer warpgroup: warp w owns q rows 16 w .. 16 w + 15; a
  // thread holds rows g and g + 8 of them (wgmma's accumulator layout:
  // d[4 j + e] is row g + 8 (e / 2), column 8 j + 2 t + e % 2).
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;

  mbar_wait(&bars->q, 0);
  {   // Q -> Q * log2(e)/sqrt(D), rounded to T, in place
    uint4* q4 = reinterpret_cast<uint4*>(qs);
    for (int i = tid; i < kTile / 16; i += kConsumers) {
      uint4 x = q4[i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = Elem<T>::to2(w[e]);
        w[e] = Elem<T>::from2(f.x * qscale, f.y * qscale);
      }
      q4[i] = x;
    }
    // generic-proxy writes, then read by wgmma (the async proxy)
    bbt::fence_proxy_async();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  }
  const uint32_t q_addr = smem_u32(qs);
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);

  // Diagonal tile: key > row is masked; band-edge tiles (window set and
  // the tile's first key at or below the last row's lowest band key less
  // one): key <= row - window is masked.
  auto mask = [&](float (&s)[32], int kt) {
    const bool diag = kt == qt;
    const bool edge = window > 0 && kt * BKV < q0 + BQ - window;
    if (!diag && !edge) return;
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
      const int key = kt * BKV + n * 8 + 2 * t;
      if (diag) {
        if (key > r_lo) s[4 * n] = -INFINITY;
        if (key + 1 > r_lo) s[4 * n + 1] = -INFINITY;
        if (key > r_hi) s[4 * n + 2] = -INFINITY;
        if (key + 1 > r_hi) s[4 * n + 3] = -INFINITY;
      }
      if (edge) {
        if (key <= r_lo - window) s[4 * n] = -INFINITY;
        if (key + 1 <= r_lo - window) s[4 * n + 1] = -INFINITY;
        if (key <= r_hi - window) s[4 * n + 2] = -INFINITY;
        if (key + 1 <= r_hi - window) s[4 * n + 3] = -INFINITY;
      }
    }
  };

  float o0[32], o1[32];   // O, dims 0..63 and 64..127
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o0[i] = o1[i] = s[i] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  uint32_t p[16];

  for (int j = 0; j < nkv; ++j) {
    const int st = j % kStages;
    mbar_wait(&bars->full[st], (j / kStages) & 1);
    wgmma_fence();
    issue_qk<T>(s, q_addr, k_addr + st * kTile);
    wgmma_wait<0>();
    fence_regs(s);
    mask(s, lo + j);
    float alpha_lo, alpha_hi;
    softmax_tile<T>(s, p, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      o0[4 * n] *= alpha_lo;
      o0[4 * n + 1] *= alpha_lo;
      o0[4 * n + 2] *= alpha_hi;
      o0[4 * n + 3] *= alpha_hi;
      o1[4 * n] *= alpha_lo;
      o1[4 * n + 1] *= alpha_lo;
      o1[4 * n + 2] *= alpha_hi;
      o1[4 * n + 3] *= alpha_hi;
    }
    wgmma_fence();
    issue_pv<T>(o0, o1, p, v_addr + st * kTile);
    wgmma_wait<0>();
    fence_regs(o0);
    fence_regs(o1);
    keep_regs(p);
    mbar_arrive(&bars->empty[st]);   // this stage may be refilled
  }

  // every row's diagonal tile holds its own key: l > 0
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  const size_t q_row_stride = (size_t)H * D;
  T* o_lo = O + ((size_t)row0 + r_lo) * q_row_stride + h * D;
  T* o_hi = o_lo + 8 * q_row_stride;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int d = n * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(o_lo + d) =
        Elem<T>::from2(o0[4 * n] * inv_lo, o0[4 * n + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(o_hi + d) =
        Elem<T>::from2(o0[4 * n + 2] * inv_hi, o0[4 * n + 3] * inv_hi);
    *reinterpret_cast<uint32_t*>(o_lo + 64 + d) =
        Elem<T>::from2(o1[4 * n] * inv_lo, o1[4 * n + 1] * inv_lo);
    *reinterpret_cast<uint32_t*>(o_hi + 64 + d) =
        Elem<T>::from2(o1[4 * n + 2] * inv_hi, o1[4 * n + 3] * inv_hi);
  }
}

// [rows, heads, D] of T (rows = B * S) in boxes of 64 rows x 1 head x 64
// dims, 128-byte swizzle.
template <typename T>
bool make_map(bbt::EncodeTiled encode, CUtensorMap* map, const void* ptr,
              int heads, long long rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2};
  const cuuint32_t box[3] = {64, 1, 64};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, Elem<T>::kMap, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* Q, const void* K, const void* V, void* O, int B,
           int S, int H, int Hkv, int window, float qscale,
           cudaStream_t stream) {
  const bbt::EncodeTiled encode = bbt::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  const long long rows = (long long)B * S;
  if (!make_map<T>(encode, &tq, Q, H, rows) ||
      !make_map<T>(encode, &tk, K, Hkv, rows) ||
      !make_map<T>(encode, &tv, V, Hkv, rows))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[bbt::kMaxDevices];
  cudaError_t err = bbt::set_max_smem_once(flash_attention_fwd_kernel<T>,
                                           kSmemBytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, S / BQ);
  flash_attention_fwd_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<T*>(O), S, H, Hkv, window, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16: Q, K, V and O are bfloat16 (else float16). window: 0 for none, a
// window >= S is none.
extern "C" int flash_attention_fwd(const void* Q, const void* K,
                                   const void* V, void* O, int B, int S,
                                   int H, int Hkv, int head_dim, int bf16,
                                   int window, float qscale, void* stream) {
  if (head_dim != D || S % BQ != 0 || S < BQ || B < 1 || Hkv < 1 ||
      H % Hkv != 0 || S / BQ > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  if (window >= S) window = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(Q, K, V, O, B, S, H, Hkv, window, qscale,
                                 st);
  return launch<half>(Q, K, V, O, B, S, H, Hkv, window, qscale, st);
}
