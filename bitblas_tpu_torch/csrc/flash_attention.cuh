// Kernel 4, flash prefill attention: Q [B, S, H, D] x K [B, S, Hkv, D]
// (or K^T [B, D, Hkv, S], "ntn") x V [B, S, Hkv, D] -> O [B, S, H, D],
// Q, K and V all float16 or all bfloat16 (a template parameter: wgmma's
// .f16 or .bf16 form), O float16, bfloat16 or float32 (stored in its type
// directly), GQA with group = H / Hkv, causal or not, any S >= 1, and with
// causal an optional sliding window: row i attends keys (i - window, i].
// One template instance a (type, head dim, KV tile, walk, K layout); the
// .cu files instantiate one head dim each (flash_attention.cu: D = 128),
// so they build side by side. float32 operands run flash_attention_f32.cu.
//
// Replaces bitblas_tpu/kernels/flash.py:make_flash_attention (pallas_call
// at :393 for the causal walk and :415 for the dense one): every head dim
// it takes here (64, 80, 96, 100, 128, 256; it zero-pads D % 128 != 0 on
// the host, :122-148, which this kernel does not), causal and not,
// trans_k, a ragged seq_len (its kv_len mask, :44-47) and an out_dtype.
// The configurations TMA cannot address run here behind kernels/flash.py's
// layout pass (rows padded to 16 bytes); the other head dims run
// flash_attention_general.cu.
//
// What bounds it on the H100: at the main path's prompts (B = 1, H = 32,
// S = 256 ... 2048, D = 100 or 128) the causal half of the 4*B*H*S^2*D
// product FLOPs over the tensor-core rate past S ~ 1,200, the bytes (Q,
// K, V read once, O written once: 2*B*S*(H + Hkv)*D elements) below it.
// With a window the product shrinks to 4*B*H*D*sum_i min(i + 1, window).
//
// Design (FlashAttention-3 form on wgmma and TMA). One block per (64-row q
// tile, batch * head): a consumer warpgroup (warps 0-3) owns the 64 q rows
// and a producer warp (warp 4) issues the copies. 64 rows a block at every
// S, so the main path's B = 1, H = 32 prompts give 32 * S / 64 blocks.
//   - Tiles: a head's row is cut in boxes of 64 columns (128 bytes, the
//     128-byte swizzle's width). TMA reads each box from the [B, S, heads *
//     D] view (row stride heads * D * 2 bytes, legal wherever that is a
//     multiple of 16: D = 100 with an even head count). A box must start
//     on a 16-byte multiple, so the head's first box starts at column
//     head * D - s, s = (head * D) % 8: 0, or 4 when D % 8 == 4 (D = 100,
//     odd heads); kBoxes = ceil((D + 4) / 64) then. The tiles' columns
//     outside the head's are the neighbour heads' (past the last head TMA
//     fills zeros): Q is rewritten in shared memory anyway (scaled, below),
//     and there each row moves to K's start column and every other column
//     becomes 0, so K's extra columns add 0 to every score; O's extra
//     columns are never stored. Rows past S lie past the view's S rows, so
//     TMA zero-fills them: Q's pad rows are computed and not stored, and
//     K and V's rows past S arrive as zeros (the V rows JAX zeroes, :44-47).
//     With trans_k, K^T tiles come from the [B, D, Hkv, S] tensor (key
//     stride S * 2 bytes: S % 8 == 0) in boxes of 64 keys x ceil16(D)
//     rows of D, rows past D zero-filled.
//   - The ring: one thread loads Q once and K/V tiles of BKV (64 or 128)
//     keys into a two-stage ring, each on an mbarrier with its byte count;
//     consumers release a stage through an "empty" mbarrier (128
//     arrivals). The tensor maps depend on the pointers: the host encodes
//     them per call (cuTensorMapEncodeTiled through
//     cudaGetDriverEntryPoint, no -lcuda) and passes them as
//     __grid_constant__ parameters (hopper.cuh).
//   - Q is scaled in shared memory by log2(e)/sqrt(D) in f32 and rounded
//     to Q's type (the fold of flash.py:437-441), so scores are base 2
//     (when Q's and K's start columns differ, through registers: each
//     thread gathers its chunks, all wait, then write).
//   - S = Q K^T: wgmma.mma_async m64n64k16 per 64 keys, Q and K both from
//     shared memory, KS = ceil((D + s) / 16) steps of 16 (the last in a
//     box's first 32-byte steps when D % 64 != 0), K-major; K^T tiles are
//     MN-major (the descriptor's transpose bit), one 16-row step of D a
//     k16.
//   - f32 online softmax in registers; only the causal diagonal tiles,
//     the band-edge tiles of a window and, without causality, the last
//     tile of a ragged S (keys >= S) are masked.
//   - O += P V: P is the score accumulator rounded to pairs of V's type,
//     which is wgmma's A-register layout; V comes from shared memory as a
//     transposed (MN-major) B, one m64n64k16 per 64-column box of D.
//   - Each tile runs S, softmax, PV in turn; at D <= 128 and 64-key tiles
//     (80 KB of shared memory) two blocks an SM overlap one block's
//     softmax with the other's products. 128-key tiles halve the barrier
//     round trips; they are built at D = 64 alone (72 KB: still two blocks
//     an SM), where they win at short or dense walks. From D = 96 on they
//     leave one block an SM and lost 11-28% on the H100 (PERF.md), so
//     those head dims build 64-key tiles only; D = 256 (160 KB, a 64 x 256
//     f32 O: 128 registers a consumer thread) has no room for them.
// The causal walk runs KV tiles lo .. hi, hi the tile of the q tile's
// last row: the skip is a loop bound, so masked tiles are never loaded.
// Without a window lo = 0; with one, lo = max(0, (64 qt - window + 1) /
// BKV), the first tile that holds a key of the band of the tile's first
// row (flash.py:183-208), and the per-row lower mask (key <= row - window)
// runs only on band-edge tiles. A row's first visited tile can then be all
// masked (S = 8192, window 4096: rows 4096-4159 start at tile 0, and row
// 4159's band begins at key 64), so the online softmax takes a max of
// -inf as 0 for its exponents: the tile adds nothing and no exp2(-inf -
// (-inf)) NaN (the trap of flash.py:186-192) appears. The JAX kernel
// walks diagonal-first instead; here the order is ascending in both
// cases, so a window >= S gives the windowless walk, bit for bit. Longest
// walks first: blockIdx.y = 0 takes the last q tile of every head. Pad
// rows of a prompt bucket sit after the real rows, so causality keeps
// them out of every real row. The dense walk visits every tile.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace bbt {
namespace fa {

constexpr int BQ = 64;
constexpr int kStages = 2;
constexpr int kConsumers = 128;              // one warpgroup
constexpr int kThreads = kConsumers + 32;    // + the producer warp
constexpr int kRow = 128;                    // bytes of a box row
constexpr int kMaxSmem = 232448;             // an H100 block's opt-in limit

// Output types (the entry points' out_code).
constexpr int kOutF16 = 0, kOutBF16 = 1, kOutF32 = 2;

template <int D, int BKV>
struct Shape {
  // TMA reads a box from a 16-byte multiple: with D % 8 == 4 a head's
  // row (head * D columns in) may start 4 columns into its first box
  static constexpr int kShift = D % 8 == 0 ? 0 : 4;
  static_assert(D % 4 == 0, "head dims D % 4 == 0");
  static constexpr int kBoxes = (D + kShift + 63) / 64;  // 64-column boxes
  static constexpr int KS = (D + kShift + 15) / 16;      // k16 steps of QK^T
  static constexpr int NH = BKV / 64;            // 64-key halves of a tile
  static constexpr int kQBytes = kBoxes * BQ * kRow;
  static constexpr int kBox = BKV * kRow;        // a box of a K or V tile
  static constexpr int kKTBox = KS * 16 * kRow;  // ntn: 64 keys x 16 KS rows
  static constexpr int kTile = kBoxes * kBox;    // K or V tile (>= NH kKTBox)
  static constexpr int kSmem = 1024 /* alignment */ + kQBytes +
                               kStages * 2 * kTile + 128 /* barriers */;
  static_assert(BKV == 64 || BKV == 128, "64- or 128-key tiles");
  static_assert(NH * kKTBox <= kTile, "a K^T tile fits a K tile's room");
};

struct Bars {
  uint64_t q;
  uint64_t full[kStages], empty[kStages];
};

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

// Two adjacent outputs at p, in the output type.
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
template <typename OT>
__device__ __forceinline__ void store2(OT* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = Elem<OT>::from2(lo, hi);
}

#define BBT_FA_D                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define BBT_FA_REGS                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "      \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "       \
  "%28, %29, %30, %31}, "
#define BBT_FA_SS(TY, TB)                                                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               BBT_FA_REGS "%32, %33, p, 1, 1, 0, " TB ";\n}\n"             \
               : BBT_FA_D                                                   \
               : "l"(da), "l"(db), "r"(scale_d))
#define BBT_FA_RS_T(TY)                                                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                 \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "  \
               BBT_FA_REGS "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"    \
               : BBT_FA_D                                                   \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),      \
                 "r"(1))

// d (64 x 64, f32) = A (64 x 16, shared, K-major) B (16 x 64, shared;
// K-major, or MN-major when kTransB) + (scale_d ? d : 0).
template <typename T, bool kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, half>::value) {
    if constexpr (kTransB) BBT_FA_SS("f16", "1");
    else BBT_FA_SS("f16", "0");
  } else {
    if constexpr (kTransB) BBT_FA_SS("bf16", "1");
    else BBT_FA_SS("bf16", "0");
  }
}

// d += A (64 x 16, registers) B (16 x 64, shared, MN-major: N contiguous,
// so transposed).
template <typename T>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (std::is_same<T, half>::value) BBT_FA_RS_T("f16");
  else BBT_FA_RS_T("bf16");
}

#undef BBT_FA_SS
#undef BBT_FA_RS_T

// Online softmax over one tile's scores s (rows g and g + 8 of the warp,
// base 2, masked entries -inf): updates the running max m and sum l,
// returns the factors alpha that rescale O, and packs the weights rounded
// to T into wgmma's A fragments: p[h][4 ks + i] for keys 64 h + 16 ks ..
// 64 h + 16 ks + 15 (the accumulators of key columns 16 ks .. are the A
// layout of k16). A row whose max is still -inf (all of its keys so far
// masked, which a window allows) takes 0 in the exponents: its weights
// and alpha are 0, and a finite max is used as it is.
template <typename T, int NH>
__device__ __forceinline__ void softmax_tile(float (&s)[NH][32],
                                             uint32_t (&p)[NH][16],
                                             float& m_lo, float& m_hi,
                                             float& l_lo, float& l_hi,
                                             float& alpha_lo,
                                             float& alpha_hi) {
  float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[h][4 * n], s[h][4 * n + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[h][4 * n + 2], s[h][4 * n + 3]));
    }
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
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[h][4 * n] = exp2f(s[h][4 * n] - mu_lo);
      s[h][4 * n + 1] = exp2f(s[h][4 * n + 1] - mu_lo);
      s[h][4 * n + 2] = exp2f(s[h][4 * n + 2] - mu_hi);
      s[h][4 * n + 3] = exp2f(s[h][4 * n + 3] - mu_hi);
      sum_lo += s[h][4 * n] + s[h][4 * n + 1];
      sum_hi += s[h][4 * n + 2] + s[h][4 * n + 3];
    }
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, w);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, w);
  }
  l_lo = l_lo * alpha_lo + sum_lo;
  l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      p[h][i] = Elem<T>::from2(s[h][2 * i], s[h][2 * i + 1]);
  }
}

// S = Q K^T over D in KS steps of 16, step kk in box kk / 4 at 32 bytes a
// step within the 128-byte swizzled row; each 64-key half h of the tile
// its own accumulators. K^T (trans_k): half h is its own box of 16 KS
// rows of D, step kk 16 rows (2048 bytes) further.
template <typename T, int D, int BKV, bool kTransK>
__device__ __forceinline__ void issue_qk(float (&s)[BKV / 64][32],
                                         uint32_t q_addr, uint32_t k_addr) {
  using Sh = Shape<D, BKV>;
  if constexpr (kTransK) {
#pragma unroll
    for (int h = 0; h < Sh::NH; ++h) {
#pragma unroll
      for (int kk = 0; kk < Sh::KS; ++kk) {
        const uint32_t qo = (kk / 4) * (BQ * kRow) + (kk % 4) * 32;
        wgmma_ss<T, true>(s[h], desc_sw128(q_addr + qo),
                          desc_sw128(k_addr + h * Sh::kKTBox + kk * 2048),
                          kk > 0);
      }
    }
  } else {
#pragma unroll
    for (int h = 0; h < Sh::NH; ++h) {
#pragma unroll
      for (int kk = 0; kk < Sh::KS; ++kk) {
        const uint32_t qo = (kk / 4) * (BQ * kRow) + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * Sh::kBox + h * 64 * kRow +
                            (kk % 4) * 32;
        wgmma_ss<T, false>(s[h], desc_sw128(q_addr + qo),
                           desc_sw128(k_addr + ko), kk > 0);
      }
    }
  }
  wgmma_commit();
}

// O += P V in steps of 16 keys, one m64n64k16 per 64-column box of V (16
// rows of 128 bytes = 2048 bytes a step).
template <typename T, int D, int BKV>
__device__ __forceinline__ void issue_pv(
    float (&o)[Shape<D, BKV>::kBoxes][32],
    const uint32_t (&p)[BKV / 64][16], uint32_t v_addr) {
  using Sh = Shape<D, BKV>;
#pragma unroll
  for (int h = 0; h < Sh::NH; ++h) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t a[4] = {p[h][4 * ks], p[h][4 * ks + 1], p[h][4 * ks + 2],
                             p[h][4 * ks + 3]};
#pragma unroll
      for (int bx = 0; bx < Sh::kBoxes; ++bx)
        wgmma_rs_t<T>(o[bx], a,
                      desc_sw128(v_addr + bx * Sh::kBox + h * 64 * kRow +
                                 ks * 2048));
    }
  }
  wgmma_commit();
}

// window: 0 for none, else >= 1 (row i attends keys (i - window, i]);
// causal only. kTransK: K is K^T [B, D, Hkv, S].
template <typename T, int D, int BKV, bool kCausal, bool kTransK>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, void* __restrict__ O,
               int S, int H, int Hkv, int window, int out_code, int hs,
               float qscale) {
  using Sh = Shape<D, BKV>;
  constexpr int NH = Sh::NH, NB = Sh::kBoxes;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;                         // NB boxes: 64 x D
  unsigned char* ks = smem + Sh::kQBytes;           // [stage] K tile
  unsigned char* vs = ks + kStages * Sh::kTile;     // [stage] V tile
  Bars* bars = reinterpret_cast<Bars*>(vs + kStages * Sh::kTile);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int nq = (S + BQ - 1) / BQ;
  // longest walks first
  const int qt = kCausal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  // causal: tiles lo .. hi, hi the tile of the q tile's last row; below lo
  // no key of the tile's band (q0 - window + 1 is the lowest key of row
  // q0). Dense: every tile.
  const int hi = kCausal ? (q0 + BQ - 1) / BKV : (S + BKV - 1) / BKV - 1;
  const int lo = kCausal && window > 0 ? max(0, (q0 - window + 1) / BKV) : 0;
  const int nkv = hi + 1 - lo;
  // where each head's columns start in its tiles (Shape::kShift): Q's, V's
  // and K's (K^T's rows are D itself). Head h's columns start at h * hs of
  // a token row: hs = D, or more where the layout pass padded each head.
  const int sq = (h * hs) % 8, sv = (hk * hs) % 8, sk = kTransK ? 0 : sv;

  if (tid == 0) {
    mbar_init(&bars->q, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&bars->full[i], 1);
      mbar_init(&bars->empty[i], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {   // the producer warp: one thread issues
    if (tid == kConsumers) {
      mbar_expect_tx(&bars->q, Sh::kQBytes);
#pragma unroll
      for (int bx = 0; bx < NB; ++bx)
        tma_load_3d(qs + bx * BQ * kRow, &tq, &bars->q, h * hs - sq + 64 * bx,
                    q0, b);
      constexpr uint32_t k_bytes = kTransK ? NH * Sh::kKTBox : Sh::kTile;
      for (int j = 0; j < nkv; ++j) {
        const int st = j % kStages;
        // use u = j / kStages of a stage waits for the consumers' release
        // of use u - 1
        if (j >= kStages) mbar_wait(&bars->empty[st], (j / kStages - 1) & 1);
        uint64_t* full = &bars->full[st];
        const int row = (lo + j) * BKV;
        unsigned char* kst = ks + st * Sh::kTile;
        unsigned char* vst = vs + st * Sh::kTile;
        mbar_expect_tx(full, k_bytes + Sh::kTile);
        if constexpr (kTransK) {
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
            tma_load_4d(kst + hh * Sh::kKTBox, &tk, full, row + 64 * hh, hk,
                        0, b);
        } else {
#pragma unroll
          for (int bx = 0; bx < NB; ++bx)
            tma_load_3d(kst + bx * Sh::kBox, &tk, full,
                        hk * hs - sk + 64 * bx, row, b);
        }
#pragma unroll
        for (int bx = 0; bx < NB; ++bx)
          tma_load_3d(vst + bx * Sh::kBox, &tv, full, hk * hs - sv + 64 * bx,
                      row, b);
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
  // The 16-byte chunk i of a tile of 64-column boxes (BQ rows each): its
  // row and its first column; the 128-byte swizzle stores chunk c of row r
  // at chunk c ^ (r % 8).
  auto chunk_rc = [](int i, int& r, int& col0) {
    const int within = i % (BQ * 8);
    r = within / 8;
    col0 = (i / (BQ * 8)) * 64 + (((within % 8) ^ (r & 7)) * 8);
  };
  if constexpr (Sh::kShift == 0) {
    // Q -> Q * log2(e)/sqrt(D), rounded to T, in place; columns >= D (the
    // next head's, or zeros) -> 0
    uint4* q4 = reinterpret_cast<uint4*>(qs);
    for (int i = tid; i < Sh::kQBytes / 16; i += kConsumers) {
      uint4 x = q4[i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
      int r, col0;
      chunk_rc(i, r, col0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = Elem<T>::to2(w[e]);
        w[e] = (D % 64 == 0 || col0 + 2 * e < D)
                   ? Elem<T>::from2(f.x * qscale, f.y * qscale)
                   : 0u;
      }
      q4[i] = x;
    }
  } else {
    // The same, and each row moved from Q's start column sq to K's sk, so
    // that column j of Q and of K hold the same d = j - sk: every thread
    // gathers its chunks' pairs (d even, a pair never straddles a chunk),
    // all wait, then write; columns outside [sk, sk + D) -> 0
    constexpr int kPer = Sh::kQBytes / 16 / kConsumers;
    static_assert(Sh::kQBytes / 16 % kConsumers == 0, "whole chunks");
    uint32_t vals[kPer][4];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      int r, col0;
      chunk_rc(tid + c * kConsumers, r, col0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = col0 + 2 * e, src = j - sk + sq;
        uint32_t w = 0u;
        if (j >= sk && j < sk + D) {
          const uint32_t x = *reinterpret_cast<const uint32_t*>(
              qs + (src / 64) * (BQ * kRow) + r * kRow +
              ((((src % 64) / 8) ^ (r & 7)) * 16) + (src % 8) * 2);
          const float2 f = Elem<T>::to2(x);
          w = Elem<T>::from2(f.x * qscale, f.y * qscale);
        }
        vals[c][e] = w;
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    uint4* q4 = reinterpret_cast<uint4*>(qs);
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      q4[tid + c * kConsumers] =
          make_uint4(vals[c][0], vals[c][1], vals[c][2], vals[c][3]);
  }
  {
    // generic-proxy writes, then read by wgmma (the async proxy)
    fence_proxy_async();
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  }
  const uint32_t q_addr = smem_u32(qs);
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);

  // Causal diagonal tiles (a key past the q tile's first row): key > row
  // is masked; band-edge tiles (window set and the tile's first key at or
  // below the last row's lowest band key less one): key <= row - window
  // is masked; without causality the last tile of a ragged S: key >= S.
  auto mask = [&](float (&s)[NH][32], int kt) {
    const int kb = kt * BKV;
    const bool diag = kCausal && kb + BKV - 1 > q0;
    const bool edge = kCausal && window > 0 && kb < q0 + BQ - window;
    const bool tail = !kCausal && kb + BKV > S;
    if (!diag && !edge && !tail) return;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int key = kb + hh * 64 + n * 8 + 2 * t;
        float* e = &s[hh][4 * n];
        if (diag) {
          if (key > r_lo) e[0] = -INFINITY;
          if (key + 1 > r_lo) e[1] = -INFINITY;
          if (key > r_hi) e[2] = -INFINITY;
          if (key + 1 > r_hi) e[3] = -INFINITY;
        }
        if (edge) {
          if (key <= r_lo - window) e[0] = -INFINITY;
          if (key + 1 <= r_lo - window) e[1] = -INFINITY;
          if (key <= r_hi - window) e[2] = -INFINITY;
          if (key + 1 <= r_hi - window) e[3] = -INFINITY;
        }
        if (tail) {
          if (key >= S) e[0] = e[2] = -INFINITY;
          if (key + 1 >= S) e[1] = e[3] = -INFINITY;
        }
      }
    }
  };

  float o[NB][32];   // O, one box of 64 columns each
  float s[NH][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) o[bx][i] = 0.f;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) s[hh][i] = 0.f;
  }
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  uint32_t p[NH][16];

  for (int j = 0; j < nkv; ++j) {
    const int st = j % kStages;
    mbar_wait(&bars->full[st], (j / kStages) & 1);
    wgmma_fence();
    issue_qk<T, D, BKV, kTransK>(s, q_addr, k_addr + st * Sh::kTile);
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(s[hh]);
    mask(s, lo + j);
    float alpha_lo, alpha_hi;
    softmax_tile<T, NH>(s, p, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi);
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[bx][4 * n] *= alpha_lo;
        o[bx][4 * n + 1] *= alpha_lo;
        o[bx][4 * n + 2] *= alpha_hi;
        o[bx][4 * n + 3] *= alpha_hi;
      }
    }
    wgmma_fence();
    issue_pv<T, D, BKV>(o, p, v_addr + st * Sh::kTile);
    wgmma_wait<0>();
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) fence_regs(o[bx]);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) keep_regs(p[hh]);
    mbar_arrive(&bars->empty[st]);   // this stage may be refilled
  }

  // every row attends at least one key (its own, or key 0): l > 0
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  const size_t q_row = (size_t)H * D;   // elements of O a token row
  const size_t lo_idx = ((size_t)b * S + r_lo) * q_row + (size_t)h * D;
  const size_t hi_idx = lo_idx + 8 * q_row;
  auto store = [&](auto* out) {   // in the output type, chosen once
#pragma unroll
    for (int bx = 0; bx < NB; ++bx) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        // D is even, and so is V's start column sv: d, d + 1 < D
        const int d = bx * 64 + n * 8 + 2 * t - sv;
        if ((Sh::kShift != 0 && d < 0) || (D % 64 != 0 && d >= D)) continue;
        if (r_lo < S)
          store2(out + lo_idx + d, o[bx][4 * n] * inv_lo,
                 o[bx][4 * n + 1] * inv_lo);
        if (r_hi < S)
          store2(out + hi_idx + d, o[bx][4 * n + 2] * inv_hi,
                 o[bx][4 * n + 3] * inv_hi);
      }
    }
  };
  if (out_code == kOutF32)
    store(static_cast<float*>(O));
  else if (out_code == kOutBF16)
    store(static_cast<__nv_bfloat16*>(O));
  else
    store(static_cast<half*>(O));
}

// Q, K (nnn) and V as [B, S, heads * D] in boxes of 64 columns x `rows`
// rows, a token row `pitch` elements apart (heads * D, or more where the
// layout pass of kernels/flash.py padded the rows to 16 bytes); K^T (ntn)
// as [B, D, Hkv, S] in boxes of 64 keys x 16 KS rows of D, a key row
// `pitch` (S or more) elements apart.
template <typename T>
bool map_rows(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
              int S, int heads, int D, int rows, int pitch) {
  const cuuint64_t dims[3] = {(cuuint64_t)heads * D, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * 2,
                                 (cuuint64_t)S * pitch * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return make_map_nd_sw128(encode, map, ptr, Elem<T>::kMap, 3, dims,
                           strides, box);
}

template <typename T>
bool map_kt(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B,
            int S, int Hkv, int D, int d_rows, int pitch) {
  const cuuint64_t dims[4] = {(cuuint64_t)S, (cuuint64_t)Hkv, (cuuint64_t)D,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)pitch * 2,
                                 (cuuint64_t)Hkv * pitch * 2,
                                 (cuuint64_t)D * Hkv * pitch * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)d_rows, 1};
  return make_map_nd_sw128(encode, map, ptr, Elem<T>::kMap, 4, dims,
                           strides, box);
}

template <typename T, int D, int BKV, bool kCausal, bool kTransK>
int launch(const void* Q, const void* K, const void* V, void* O, int B,
           int S, int H, int Hkv, int window, int out_code, const int* pitch,
           int hs, float qscale, cudaStream_t stream) {
  using Sh = Shape<D, BKV>;
  static_assert(Sh::kSmem <= kMaxSmem, "the tile fits a block's smem");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  const bool kt_ok =
      kTransK ? map_kt<T>(encode, &tk, K, B, S, Hkv, D, Sh::KS * 16, pitch[1])
              : map_rows<T>(encode, &tk, K, B, S, Hkv, hs, BKV, pitch[1]);
  if (!map_rows<T>(encode, &tq, Q, B, S, H, hs, BQ, pitch[0]) || !kt_ok ||
      !map_rows<T>(encode, &tv, V, B, S, Hkv, hs, BKV, pitch[2]))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices];
  cudaError_t err = set_max_smem_once(fwd_kernel<T, D, BKV, kCausal, kTransK>,
                                      Sh::kSmem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  fwd_kernel<T, D, BKV, kCausal, kTransK>
      <<<grid, kThreads, Sh::kSmem, stream>>>(tq, tk, tv, O, S, H, Hkv,
                                              window, out_code, hs, qscale);
  return (int)cudaGetLastError();
}

// The walk (causal or dense) and the K layout, each an instance.
template <typename T, int D, int BKV>
int launch_walk(const void* Q, const void* K, const void* V, void* O, int B,
                int S, int H, int Hkv, int causal, int trans_k, int window,
                int out_code, const int* pitch, int hs, float qscale,
                cudaStream_t stream) {
  if (causal && trans_k)
    return launch<T, D, BKV, true, true>(Q, K, V, O, B, S, H, Hkv, window,
                                         out_code, pitch, hs, qscale, stream);
  if (causal)
    return launch<T, D, BKV, true, false>(Q, K, V, O, B, S, H, Hkv, window,
                                          out_code, pitch, hs, qscale, stream);
  if (trans_k)
    return launch<T, D, BKV, false, true>(Q, K, V, O, B, S, H, Hkv, 0,
                                          out_code, pitch, hs, qscale, stream);
  return launch<T, D, BKV, false, false>(Q, K, V, O, B, S, H, Hkv, 0,
                                         out_code, pitch, hs, qscale, stream);
}

// The head dims that build 128-key tiles (see Design).
template <int D>
constexpr bool kKv128 = D == 64;

template <typename T, int D>
int launch_tile(const void* Q, const void* K, const void* V, void* O, int B,
                int S, int H, int Hkv, int causal, int trans_k, int block_kv,
                int window, int out_code, const int* pitch, int hs,
                float qscale, cudaStream_t stream) {
  if (block_kv == 64)
    return launch_walk<T, D, 64>(Q, K, V, O, B, S, H, Hkv, causal, trans_k,
                                 window, out_code, pitch, hs, qscale, stream);
  // kernels/flash.py prefill_tiles names the same instances
  if constexpr (kKv128<D>) {
    if (block_kv == 128)
      return launch_walk<T, D, 128>(Q, K, V, O, B, S, H, Hkv, causal,
                                    trans_k, window, out_code, pitch, hs,
                                    qscale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The entry points' body: bf16 says Q, K and V are bfloat16 (else
// float16); out_code the output type; window 0 for none (causal only), a
// window >= S is none. q_pitch, k_pitch and v_pitch: the elements between
// two token rows of Q, K and V (heads * D as they come; K^T: between two
// key rows, S as it comes), each at least that; head_stride: the columns
// between two heads of a row (D, or a multiple of 8 past D where the
// layout pass zero-padded each head). What TMA cannot address is refused:
// a pitch of 2-byte elements that is not a multiple of 16 bytes.
template <int D>
int run(const void* Q, const void* K, const void* V, void* O, int B, int S,
        int H, int Hkv, int head_dim, int bf16, int out_code, int causal,
        int trans_k, int block_kv, int window, int q_pitch, int k_pitch,
        int v_pitch, int head_stride, float qscale, void* stream) {
  const int pitch[3] = {q_pitch, k_pitch, v_pitch};
  const int hs = head_stride;
  if (head_dim != D || S < 1 || B < 1 || Hkv < 1 || H % Hkv != 0 ||
      (S + BQ - 1) / BQ > 65535 || window < 0 || (window && !causal) ||
      out_code < kOutF16 || out_code > kOutF32 || q_pitch < H * hs ||
      k_pitch < (trans_k ? S : Hkv * hs) || v_pitch < Hkv * hs ||
      (q_pitch * 2) % 16 != 0 || (k_pitch * 2) % 16 != 0 ||
      (v_pitch * 2) % 16 != 0 || hs < D || (hs != D && hs % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (window >= S) window = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_tile<__nv_bfloat16, D>(Q, K, V, O, B, S, H, Hkv, causal,
                                         trans_k, block_kv, window, out_code,
                                         pitch, hs, qscale, st);
  return launch_tile<half, D>(Q, K, V, O, B, S, H, Hkv, causal, trans_k,
                              block_kv, window, out_code, pitch, hs, qscale,
                              st);
}

}  // namespace fa
}  // namespace bbt

// One C entry point a head dim: flash_attention_fwd_d<D>(Q, K, V, O, B, S,
// H, Hkv, head_dim, bf16, out_code, causal, trans_k, block_kv, window,
// q_pitch, k_pitch, v_pitch, head_stride, qscale, stream).
#define BBT_FLASH_ENTRY(D)                                                   \
  extern "C" int flash_attention_fwd_d##D(                                   \
      const void* Q, const void* K, const void* V, void* O, int B, int S,    \
      int H, int Hkv, int head_dim, int bf16, int out_code, int causal,      \
      int trans_k, int block_kv, int window, int q_pitch, int k_pitch,       \
      int v_pitch, int head_stride, float qscale, void* stream) {            \
    return bbt::fa::run<D>(Q, K, V, O, B, S, H, Hkv, head_dim, bf16,        \
                           out_code, causal, trans_k, block_kv, window,      \
                           q_pitch, k_pitch, v_pitch, head_stride, qscale,   \
                           stream);                                          \
  }
