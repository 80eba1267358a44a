// flash_attention_general: kernel 4's general instance, for every
// configuration that no specialized instance takes: Q [B, S, H, D] x K
// [B, S, Hkv, D] (or K^T [B, D, Hkv, S]) x V [B, S, Hkv, D] -> O [B, S, H,
// D] in float16, bfloat16 or float32, for float16 / bfloat16 operands at
// any head dim up to kMaxHeadDim: head dims outside flash_attention.cuh's
// instances (16, 32, 48, 112, 160, 384, 512, ...), D % 8 == 4 with an odd
// H or Hkv, whose rows TMA cannot address, and trans_k with S % 8 != 0,
// whose key stride TMA cannot address; causal (with an optional sliding
// window) or dense, GQA, any S >= 1. float32 operands run
// flash_attention_f32.cu at every head dim.
//
// Replaces bitblas_tpu/kernels/flash.py:make_flash_attention (pallas_call
// at :393 and :415) for those configurations: JAX takes any D (its
// zero-pad shim rounds D up to a multiple of 128 when H or Hkv > 1 and
// keeps 1/sqrt of the true D, :122-150), and its FlashAtten serves a K^T
// layout its kernel cannot tile through its oracle (ops/flashatten.py:
// 138-147). The arithmetic is kernel 4's: Q is scaled by log2(e)/sqrt(D)
// in float32 and rounded to Q's type (the fold of flash.py:437-441), the
// scores and the online softmax are float32, 16-bit P is rounded to Q's
// type before P V as in the wgmma instances, and keys >= S are masked
// and their V rows zeroed (flash.py:44-47).
//
// What bounds it on the H100: the products, 4*B*H*S^2*D FLOPs (half with
// causality; 4 H D sum_i min(i + 1, window) with a window) over the
// tensor cores' 989 TFLOP/s, or below S ~ 1,000 the bytes (Q, K, V read
// once, O written once). This instance
// is the simple one that any stride and any D take; the main path's
// shapes run the wgmma + TMA instances, and its time is written down.
//
// Design (gen16_kernel). One block of 4 warps per (64 q rows,
// batch * head, 128 output columns): warp w owns rows 16 w .. 16 w + 15.
//   - Plain loads into shared memory, so any stride, any head offset and
//     any D work: 16-byte chunks at D % 8 == 0 (rows start on 16-byte
//     multiples there), else one element at a time. Q once (scaled and
//     rounded, columns past D and rows past S zero), then per tile of 64
//     keys K (from K or K^T) and the block's 128 columns of V, transposed
//     so that P V reads its B fragments as pairs of keys; keys past S
//     zero. Rows are padded to 16 columns plus 8 elements (16 bytes),
//     which keeps the mma.sync fragment reads free of bank conflicts.
//   - S = Q K^T by mma.sync m16n8k16 over D in steps of 16 (f32 sums); the
//     causal, window and key >= S masks on every visited tile; the online
//     softmax in registers, a max of -inf taken as 0 in the exponents (a
//     window can mask a row's whole first tile: no exp2(-inf + inf) NaN,
//     the trap of flash.py:186-192); P rounded to Q's type is the A
//     fragment of the next mma as it stands (the FlashAttention-2 layout).
//   - O (64 x 128 f32: 64 registers a thread) += P V, 16 keys a step.
//   - D is walked in chunks of 128 output columns, one chunk a block
//     (grid z): a wide head's accumulator never has to sit in registers
//     whole; each chunk computes the same scores again (so a head dim of
//     512 takes 4x the QK^T products of one pass).
//   - The walk is the wgmma instances': causal tiles lo .. hi (hi the tile
//     of the q tile's last row, lo the first tile of the band with a
//     window), dense every tile, longest walks first.
// Shared memory sets the cap: Q and one K tile hold the whole head dim
// (at D = 768, 2 x 64 x 776 x 2 bytes + V's 18 KB, 217 KB of 227). Above
// it the entry point refuses and kernels/flash.py raises
// NotImplementedError naming the cap.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kMaxHeadDim = 768;   // kernels/flash.py GENERAL_MAX_HEAD_DIM
constexpr int kThreads = 128;
constexpr int kOutF16 = 0, kOutBF16 = 1, kOutF32 = 2;

// q rows a block, keys a tile, output columns a block
constexpr int BQ = 64, BK = 64, DC = 128;

__host__ __device__ constexpr int round16(int d) { return (d + 15) / 16 * 16; }
// the 16-bit tiles' row pitch (elements): 16-column steps plus 16 bytes
__host__ __device__ constexpr int pitch16(int d) { return round16(d) + 8; }
constexpr int kVPitch = BK + 8;   // V^T rows: 64 keys plus 16 bytes

int smem16(int D) {
  return (BQ + BK) * pitch16(D) * 2 + DC * kVPitch * 2;
}

template <typename T>
struct Cvt;
template <>
struct Cvt<half> {
  __device__ __forceinline__ static float to(half x) { return __half2float(x); }
  __device__ __forceinline__ static half from(float x) {
    return __float2half_rn(x);
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             const uint32_t* b) {
    bbt::mma_16816(d, a, b);
  }
};
template <>
struct Cvt<__nv_bfloat16> {
  __device__ __forceinline__ static float to(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 from(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             const uint32_t* b) {
    bbt::mma_16816_bf16(d, a, b);
  }
};

__device__ __forceinline__ void store1(void* O, size_t idx, float x,
                                       int out_code) {
  if (out_code == kOutF32)
    static_cast<float*>(O)[idx] = x;
  else if (out_code == kOutBF16)
    static_cast<__nv_bfloat16*>(O)[idx] = __float2bfloat16_rn(x);
  else
    static_cast<half*>(O)[idx] = __float2half_rn(x);
}

// The causal walk's tiles lo .. hi of q tile qt (tiles of `bk` keys, q
// tiles of `bq` rows); dense: every tile.
__device__ __forceinline__ void walk(int qt, int bq, int bk, int S,
                                     int causal, int window, int& lo,
                                     int& hi) {
  const int q0 = qt * bq;
  hi = causal ? min((q0 + bq - 1) / bk, (S - 1) / bk) : (S - 1) / bk;
  lo = causal && window > 0 ? max(0, (q0 - window + 1) / bk) : 0;
}

__device__ __forceinline__ bool masked(int key, int row, int S, int causal,
                                       int window) {
  return key >= S || (causal && key > row) ||
         (window > 0 && key <= row - window);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gen16_kernel(const T* __restrict__ Q, const T* __restrict__ K,
                 const T* __restrict__ V, void* __restrict__ O, int S, int H,
                 int Hkv, int D, int causal, int trans_k, int window,
                 int out_code, float qscale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = pitch16(D), D16 = round16(D);
  T* qs = reinterpret_cast<T*>(smem);   // [BQ][P]
  T* ks = qs + BQ * P;                  // [BK][P]
  T* vt = ks + BK * P;                  // [DC][kVPitch]: V^T of the chunk

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (S + BQ - 1) / BQ;
  const int qt = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int dc0 = blockIdx.z * DC;           // the block's first column
  const int ncol = min(DC, D - dc0);         // its columns
  int lo, hi;
  walk(qt, BQ, BK, S, causal, window, lo, hi);

  // At D % 8 == 0 every head's row starts on a 16-byte multiple (the
  // row stride heads * D * 2 bytes and the head's offset are multiples of
  // 16), and Q, K and V move in 16-byte chunks of 8 elements; else one
  // element at a time.
  const bool vec = D % 8 == 0;
  const int C8 = D16 / 8;   // 16-byte chunks of a tile row
  // Q -> Q * log2(e)/sqrt(D) rounded to T; rows >= S and columns >= D 0
  if (vec) {
    for (int i = tid; i < BQ * C8; i += kThreads) {
      const int r = i / C8, c = i % C8, row = q0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (row < S && c * 8 < D) {
        x = *reinterpret_cast<const uint4*>(
            Q + (((size_t)b * S + row) * H + h) * D + c * 8);
        T* e = reinterpret_cast<T*>(&x);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          e[k] = Cvt<T>::from(Cvt<T>::to(e[k]) * qscale);
      }
      *reinterpret_cast<uint4*>(qs + r * P + c * 8) = x;
    }
  } else {
    for (int i = tid; i < BQ * D16; i += kThreads) {
      const int r = i / D16, d = i % D16;
      const int row = q0 + r;
      float x = 0.f;
      if (row < S && d < D)
        x = Cvt<T>::to(Q[(((size_t)b * S + row) * H + h) * D + d]) * qscale;
      qs[r * P + d] = Cvt<T>::from(x);
    }
  }

  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  const T* qw = qs + warp * 16 * P;
  float o[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const T zero = Cvt<T>::from(0.f);

  for (int kt = lo; kt <= hi; ++kt) {
    const int kb = kt * BK;
    __syncthreads();   // the previous tile's K and V are read (Q written)
    if (trans_k) {     // K^T [B, D, Hkv, S]: keys contiguous
      for (int i = tid; i < BK * D16; i += kThreads) {
        const int d = i / BK, j = i % BK, key = kb + j;
        ks[j * P + d] = key < S && d < D
                            ? K[(((size_t)b * D + d) * Hkv + hk) * S + key]
                            : zero;
      }
    } else if (vec) {
      for (int i = tid; i < BK * C8; i += kThreads) {
        const int j = i / C8, c = i % C8, key = kb + j;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (key < S && c * 8 < D)
          x = *reinterpret_cast<const uint4*>(
              K + (((size_t)b * S + key) * Hkv + hk) * D + c * 8);
        *reinterpret_cast<uint4*>(ks + j * P + c * 8) = x;
      }
    } else {
      for (int i = tid; i < BK * D16; i += kThreads) {
        const int j = i / D16, d = i % D16, key = kb + j;
        ks[j * P + d] = key < S && d < D
                            ? K[(((size_t)b * S + key) * Hkv + hk) * D + d]
                            : zero;
      }
    }
    if (vec) {         // 8 columns of one key a chunk, stored transposed
      for (int i = tid; i < BK * (DC / 8); i += kThreads) {
        const int j = i / (DC / 8), c = (i % (DC / 8)) * 8, key = kb + j;
        uint4 x = make_uint4(0u, 0u, 0u, 0u);
        if (key < S && c < ncol)
          x = *reinterpret_cast<const uint4*>(
              V + (((size_t)b * S + key) * Hkv + hk) * D + dc0 + c);
        const T* e = reinterpret_cast<const T*>(&x);
#pragma unroll
        for (int k = 0; k < 8; ++k) vt[(c + k) * kVPitch + j] = e[k];
      }
    } else {
      for (int i = tid; i < BK * DC; i += kThreads) {
        const int j = i / DC, c = i % DC, key = kb + j;
        vt[c * kVPitch + j] =
            key < S && c < ncol
                ? V[(((size_t)b * S + key) * Hkv + hk) * D + dc0 + c]
                : zero;
      }
    }
    __syncthreads();

    // S (16 rows x 64 keys a warp) = Q K^T, 8 key groups of 8
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int k0 = 0; k0 < D16; k0 += 16) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(qw + g * P + k0 + 2 * t);
      a[1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * P + k0 + 2 * t);
      a[2] = *reinterpret_cast<const uint32_t*>(qw + g * P + k0 + 8 + 2 * t);
      a[3] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * P + k0 + 8 +
                                                2 * t);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const T* kr = ks + (n * 8 + g) * P + k0 + 2 * t;
        const uint32_t bb[2] = {*reinterpret_cast<const uint32_t*>(kr),
                                *reinterpret_cast<const uint32_t*>(kr + 8)};
        Cvt<T>::mma(s[n], a, bb);
      }
    }

    // masks, then the online softmax of rows r_lo (s[n][0..1]) and r_hi
    // (s[n][2..3])
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const int key = kb + n * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (masked(key + e, r_lo, S, causal, window)) s[n][e] = -INFINITY;
        if (masked(key + e, r_hi, S, causal, window)) s[n][2 + e] = -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, w));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, w));
    }
    const float mu_lo = mx_lo == -INFINITY ? 0.f : mx_lo;
    const float mu_hi = mx_hi == -INFINITY ? 0.f : mx_hi;
    const float alpha_lo = exp2f(m_lo - mu_lo), alpha_hi = exp2f(m_hi - mu_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mu_lo);
      s[n][1] = exp2f(s[n][1] - mu_lo);
      s[n][2] = exp2f(s[n][2] - mu_hi);
      s[n][3] = exp2f(s[n][3] - mu_hi);
      sum_lo += s[n][0] + s[n][1];
      sum_hi += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, w);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, w);
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      o[n][0] *= alpha_lo;
      o[n][1] *= alpha_lo;
      o[n][2] *= alpha_hi;
      o[n][3] *= alpha_hi;
    }

    // O += P V, 16 keys a step: P's A fragment is the scores' layout
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          Cvt<T>::pack(s[2 * kk][0], s[2 * kk][1]),
          Cvt<T>::pack(s[2 * kk][2], s[2 * kk][3]),
          Cvt<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          Cvt<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < DC / 8; ++n) {
        if (n * 8 >= ncol) break;   // the chunk's last columns (uniform)
        const T* vr = vt + (n * 8 + g) * kVPitch + kk * 16 + 2 * t;
        const uint32_t bb[2] = {*reinterpret_cast<const uint32_t*>(vr),
                                *reinterpret_cast<const uint32_t*>(vr + 8)};
        Cvt<T>::mma(o[n], a, bb);
      }
    }
  }

  // every row attends at least one key (its own, or key 0): l > 0
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n * 8 + 2 * t + e;
      if (c >= ncol) continue;
      const size_t col = (size_t)h * D + dc0 + c;
      if (r_lo < S)
        store1(O, ((size_t)b * S + r_lo) * H * D + col, o[n][e] * inv_lo,
               out_code);
      if (r_hi < S)
        store1(O, ((size_t)b * S + r_hi) * H * D + col, o[n][2 + e] * inv_hi,
               out_code);
    }
  }
}

template <typename T>
int launch16(const void* Q, const void* K, const void* V, void* O, int B,
             int S, int H, int Hkv, int D, int causal, int trans_k,
             int window, int out_code, float qscale, cudaStream_t stream) {
  static bool smem_set[bbt::kMaxDevices];
  cudaError_t err = bbt::set_max_smem_once(gen16_kernel<T>,
                                           smem16(kMaxHeadDim), smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ, (D + DC - 1) / DC);
  gen16_kernel<T><<<grid, kThreads, smem16(D), stream>>>(
      static_cast<const T*>(Q), static_cast<const T*>(K),
      static_cast<const T*>(V), O, S, H, Hkv, D, causal, trans_k, window,
      out_code, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype_code: Q, K and V float16 (0) or bfloat16 (1); out_code 0 float16,
// 1 bfloat16, 2 float32; window 0 for none (causal only), a window >= S is
// none. Head dims 1 .. kMaxHeadDim.
extern "C" int flash_attention_general(const void* Q, const void* K,
                                       const void* V, void* O, int B, int S,
                                       int H, int Hkv, int head_dim,
                                       int dtype_code, int out_code,
                                       int causal, int trans_k, int window,
                                       float qscale, void* stream) {
  const int D = head_dim;
  if (D < 1 || D > kMaxHeadDim || S < 1 || B < 1 || Hkv < 1 ||
      H % Hkv != 0 || (S + BQ - 1) / BQ > 65535 || window < 0 ||
      (window && !causal) || out_code < kOutF16 || out_code > kOutF32 ||
      dtype_code < 0 || dtype_code > 1)
    return (int)cudaErrorInvalidValue;
  if (window >= S) window = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 1)
    return launch16<__nv_bfloat16>(Q, K, V, O, B, S, H, Hkv, D, causal,
                                   trans_k, window, out_code, qscale, st);
  return launch16<half>(Q, K, V, O, B, S, H, Hkv, D, causal, trans_k, window,
                        out_code, qscale, st);
}
