// flash_attention_f32: kernel 4 for float32 operands, Q [B, S, H, D] x K
// [B, S, Hkv, D] (or K^T [B, D, Hkv, S]) x V [B, S, Hkv, D] -> O [B, S, H,
// D] in float16, bfloat16 or float32; any D up to kMaxHeadDim (768), any S
// >= 1, GQA, causal (with an optional window) or dense.
//
// Replaces bitblas_tpu/kernels/flash.py:make_flash_attention (pallas_call
// at :393 and :415) for its float32 configurations ("explicit-f32 configs
// stay f32", :433-441): q * log2(e)/sqrt(D) stays float32, scores, the
// online softmax, P and the P V sums are float32.
//
// What bounds it on the H100: the float32 products, 4*B*H*S^2*D FLOPs
// (half with causality) over the 67 TFLOP/s FFMA rate. tf32 wgmma would
// miss JAX's float32 results by about 1e-3 relative, so this is a plain
// FFMA kernel, as kernel 9's float32 path is; its time is written down,
// not judged (no model serves float32 attention).
//
// Design: one block of 128 threads per (32 q rows, batch * head, chunk of
// 4 DC output columns), 4 threads a row (adjacent lanes: the row's max and
// sum take two shuffles). K tiles of 32 keys (the whole head dim) and the
// chunk's columns of V are read into shared memory by all threads
// (coalesced along D, or along the keys for K^T), keys past S as zeros;
// each thread scores 8 keys of its row against the scaled Q row in shared
// memory (each Q element read once for the 8), writes its weights to a
// [32 x 32] P tile, and accumulates the row's output columns c = quarter
// + 4 i (DC of them) over the tile's keys (each weight read once for
// them). Up to D = 256 one chunk holds every column; past it the chunks
// are 128 columns (grid z), each computing the same scores again, so that
// a thread holds 32 sums at any D and Q and a K tile of the whole head
// dim fit shared memory (212 KB at D = 768). The walk and the masks are
// kernel 4's: causal tiles 0 .. the q tile's last row (from the band's
// first tile with a window, a max of -inf taken as 0 in the exponents),
// dense every tile, keys >= S masked.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int BQ = 32, BK = 32, kThreads = 128;
constexpr int kOutF16 = 0, kOutBF16 = 1, kOutF32 = 2;
constexpr int kMaxHeadDim = 768;   // kernels/flash.py GENERAL_MAX_HEAD_DIM

// DC: output columns a thread holds (a chunk of 4 DC columns a block).
int smem_bytes(int D, int DC) {
  // Q and K rows padded by one float (no bank conflicts across rows), the
  // chunk's V columns, and the P tile (33 floats a row)
  return (2 * BQ * (D + 1) + BK * 4 * DC + BQ * (BK + 1)) * 4;
}

__device__ __forceinline__ void store1(void* O, size_t idx, float x,
                                       int out_code) {
  if (out_code == kOutF32)
    static_cast<float*>(O)[idx] = x;
  else if (out_code == kOutBF16)
    static_cast<__nv_bfloat16*>(O)[idx] = __float2bfloat16_rn(x);
  else
    static_cast<half*>(O)[idx] = __float2half_rn(x);
}

template <int DC>
__global__ void __launch_bounds__(kThreads)
    f32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
               const float* __restrict__ V, void* __restrict__ O, int S,
               int H, int Hkv, int D, int causal, int trans_k, int window,
               int out_code, float qscale) {
  constexpr int NC = 4 * DC;        // the block's output columns
  extern __shared__ float smem[];
  const int DQ = D + 1;
  float* qs = smem;                 // [BQ][D + 1]
  float* ks = qs + BQ * DQ;         // [BK][D + 1]
  float* vs = ks + BK * DQ;         // [BK][NC]: the chunk's columns
  float* ps = vs + BK * NC;         // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int r = tid / 4, quarter = tid % 4;
  const int nq = (S + BQ - 1) / BQ;
  const int qt = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int row = q0 + r;
  const int dc0 = blockIdx.z * NC;            // the chunk's first column
  const int ncol = min(NC, D - dc0);
  const int hi = causal ? (q0 + BQ - 1) / BK : (S + BK - 1) / BK - 1;
  const int lo = causal && window > 0 ? max(0, (q0 - window + 1) / BK) : 0;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int qr = q0 + rr;
    qs[rr * DQ + d] =
        qr < S ? Q[(((size_t)b * S + qr) * H + h) * D + d] * qscale : 0.f;
  }

  float o[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) o[c] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int kt = lo; kt <= hi; ++kt) {
    const int kb = kt * BK;
    __syncthreads();   // the previous tile's K, V and P are read
    for (int i = tid; i < BK * D; i += kThreads) {
      int j, d;
      if (trans_k) {   // K^T [B, D, Hkv, S]: keys contiguous
        d = i / BK;
        j = i % BK;
      } else {
        j = i / D;
        d = i % D;
      }
      const int key = kb + j;
      float x = 0.f;
      if (key < S)
        x = trans_k ? K[(((size_t)b * D + d) * Hkv + hk) * S + key]
                    : K[(((size_t)b * S + key) * Hkv + hk) * D + d];
      ks[j * DQ + d] = x;
    }
    for (int i = tid; i < BK * NC; i += kThreads) {
      const int j = i / NC, c = i % NC;
      const int key = kb + j;
      vs[i] = key < S && c < ncol
                  ? V[(((size_t)b * S + key) * Hkv + hk) * D + dc0 + c]
                  : 0.f;
    }
    __syncthreads();

    // each Q element read once for the thread's 8 keys
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float* qr = qs + r * DQ;
    const float* kr = ks + quarter * 8 * DQ;
    for (int d = 0; d < D; ++d) {
      const float q = qr[d];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = fmaf(q, kr[i * DQ + d], s[i]);
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = kb + quarter * 8 + i;
      const bool masked = key >= S || (causal && key > row) ||
                          (window > 0 && key <= row - window);
      s[i] = masked ? -INFINITY : s[i];
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mu = mx == -INFINITY ? 0.f : mx;
    const float alpha = exp2f(m - mu);
    m = mx;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p = exp2f(s[i] - mu);
      sum += p;
      ps[r * (BK + 1) + quarter * 8 + i] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    __syncwarp();   // the row's four threads wrote its P row
#pragma unroll
    for (int c = 0; c < DC; ++c) o[c] *= alpha;
    // each weight read once for the thread's DC columns
    for (int j = 0; j < BK; ++j) {
      const float p = ps[r * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c)
        o[c] = fmaf(p, vs[j * NC + quarter + 4 * c], o[c]);
    }
  }

  if (row < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const size_t base = (((size_t)b * S + row) * H + h) * D + dc0;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = quarter + 4 * c;
      if (col < ncol) store1(O, base + col, o[c] * inv, out_code);
    }
  }
}

// `most`: the instance's largest head dim.
template <int DC>
int launch(const void* Q, const void* K, const void* V, void* O, int B,
           int S, int H, int Hkv, int D, int causal, int trans_k, int window,
           int out_code, float qscale, int most, cudaStream_t stream) {
  static bool smem_set[bbt::kMaxDevices];
  cudaError_t err = bbt::set_max_smem_once(
      f32_kernel<DC>, smem_bytes(most, DC), smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ, (D + 4 * DC - 1) / (4 * DC));
  f32_kernel<DC><<<grid, kThreads, smem_bytes(D, DC), stream>>>(
      static_cast<const float*>(Q), static_cast<const float*>(K),
      static_cast<const float*>(V), O, S, H, Hkv, D, causal, trans_k, window,
      out_code, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// Q, K, V float32; out_code 0 float16, 1 bfloat16, 2 float32; window 0 for
// none (causal only), a window >= S is none.
extern "C" int flash_attention_f32(const void* Q, const void* K,
                                   const void* V, void* O, int B, int S,
                                   int H, int Hkv, int head_dim, int out_code,
                                   int causal, int trans_k, int window,
                                   float qscale, void* stream) {
  const int D = head_dim;
  if (D < 1 || D > kMaxHeadDim || S < 1 || B < 1 || Hkv < 1 ||
      H % Hkv != 0 || (S + BQ - 1) / BQ > 65535 || window < 0 ||
      (window && !causal) || out_code < kOutF16 || out_code > kOutF32)
    return (int)cudaErrorInvalidValue;
  if (window >= S) window = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one chunk up to D = 256; past it chunks of 128 columns (DC = 32)
  if (D <= 64)
    return launch<16>(Q, K, V, O, B, S, H, Hkv, D, causal, trans_k, window,
                      out_code, qscale, 64, st);
  if (D <= 128 || D > 256)
    return launch<32>(Q, K, V, O, B, S, H, Hkv, D, causal, trans_k, window,
                      out_code, qscale, kMaxHeadDim, st);
  return launch<64>(Q, K, V, O, B, S, H, Hkv, D, causal, trans_k, window,
                    out_code, qscale, 256, st);
}
