// flash_attention_general: kernel 4's general instance, for the 16-bit
// head dims that no instance of flash_attention.cuh takes: Q [B, S, H, D]
// x K [B, S, Hkv, D] x V [B, S, Hkv, D] -> O [B, S, H, d_out] in float16,
// bfloat16 or float32, for float16 / bfloat16 operands at any head dim D
// up to kMaxHeadDim with D % 16 == 0; causal (with an optional sliding
// window) or dense, GQA, any S >= 1. kernels/flash.py's layout pass
// hands it that form: a head dim off 16 zero-padded to the next multiple
// of 16 (d_out keeps the true D, and qscale 1/sqrt of it) and K^T
// transposed into K's layout. float32 operands run flash_attention_f32.cu.
//
// Replaces bitblas_tpu/kernels/flash.py:make_flash_attention (pallas_call
// at :393 and :415) for those head dims: JAX takes any D (its zero-pad
// shim rounds D up to a multiple of 128 when H or Hkv > 1 and keeps
// 1/sqrt of the true D, :122-150). The arithmetic is the wgmma instances':
// Q is scaled by log2(e)/sqrt(D) in float32 and rounded to Q's type (the
// fold of flash.py:437-441), the scores and the online softmax are
// float32, P is rounded to Q's type before P V, and keys >= S are masked
// and their V rows read as zeros (flash.py:44-47).
//
// What bounds it on the H100: the products, 4*B*H*S^2*D FLOPs (half with
// causality; 4 H D sum_i min(i + 1, window) with a window) over the
// tensor cores' 989 TFLOP/s, or at short S the bytes (Q, K, V read once,
// O written once).
//
// Design (gen_kernel: the FlashAttention-3 form of flash_attention.cuh
// with the head dim split over warpgroups). One block per (64 q rows,
// batch * head): NW consumer warpgroups (NW = ceil(D / 256): 1, 2 or 3)
// and a producer warp. The head dim is cut into 64-column boxes (128
// bytes, the 128-byte swizzle's width); warpgroup w owns boxes w, w + NW,
// w + 2 NW, ... (at most 4: an O slab of up to 256 columns, 128 f32
// registers a thread).
//   - Q: TMA loads its boxes once; the consumers scale them in place
//     (columns >= D, the next head's, become 0).
//   - The ring: the producer keeps TMA loads of K and V boxes in flight,
//     kStages stages on mbarriers; a stage holds one 64-key box of each
//     warpgroup (K boxes of a key tile first, then its V boxes). Every
//     warpgroup walks every stage in order and releases it (128 arrivals
//     each), so no barrier phase is ever waited two ahead.
//   - Scores once: each warpgroup sums its boxes' share of S = Q K^T
//     (wgmma m64n64k16, both operands from shared memory, only the k16
//     steps inside D); with NW > 1 the partial scores meet in shared
//     memory and every warpgroup adds them in the same order, so all hold
//     the same S. Then the masks and the online softmax in registers (a
//     max of -inf taken as 0 in the exponents: a window can mask a row's
//     whole first tile, the trap of flash.py:186-192).
//   - O += P V: P (the scores rounded to pairs of Q's type) is wgmma's A
//     fragment in registers; each of the warpgroup's V boxes is a
//     transposed (MN-major) B through the descriptor's transpose bit: no
//     transposing store anywhere.
//   - The walk is the wgmma instances': causal tiles lo .. hi, dense every
//     tile, longest walks first (the walk a run-time argument here: one
//     instance a type and width, six in all).
// Shared memory sets the cap: at D = 768 Q (96 KB), three stages of three
// 8 KB boxes (72 KB) and the partial scores (48 KB) fill 217 KB of 227.
// Above it kernels/flash.py raises NotImplementedError naming the cap.

#include "flash_attention.cuh"

namespace bbt {
namespace fag {

using fa::BQ;
using fa::Elem;
using fa::kRow;
using fa::store2;

constexpr int kMaxHeadDim = 768;   // kernels/flash.py GENERAL_MAX_HEAD_DIM
constexpr int BKV = 64;            // keys a tile
constexpr int kBox = BKV * kRow;   // one 64-key x 64-column box: 8 KB

template <int NW>
struct GShape {
  static constexpr int kConsumers = NW * 128;
  static constexpr int kThreads = kConsumers + 32;   // + the producer warp
  static constexpr int kStages = NW == 1 ? 6 : NW == 2 ? 4 : 3;
  static constexpr int kStageBytes = NW * kBox;
  static constexpr int kXBytes = NW > 1 ? NW * BQ * BKV * 4 : 0;
  static constexpr int kBarBytes = 256;
  // dynamic shared memory at `boxes` 64-column boxes of D
  static constexpr int smem(int boxes) {
    return 1024 + boxes * BQ * kRow + kStages * kStageBytes + kXBytes +
           kBarBytes;
  }
};

template <int NW>
struct GBars {
  uint64_t q;
  uint64_t full[GShape<NW>::kStages], empty[GShape<NW>::kStages];
};

// Two adjacent outputs (d, d + 1 < d_out) at p; scalar stores when the row
// of d_out elements may start off a pair.
template <typename OT>
__device__ __forceinline__ void store_pair(OT* p, float lo, float hi,
                                           bool pairs, bool second) {
  if (pairs) {
    store2(p, lo, hi);
  } else {
    if constexpr (std::is_same<OT, float>::value) {
      p[0] = lo;
      if (second) p[1] = hi;
    } else {
      const uint32_t x = Elem<OT>::from2(lo, hi);
      const OT* e = reinterpret_cast<const OT*>(&x);
      p[0] = e[0];
      if (second) p[1] = e[1];
    }
  }
}

// D: the kernel's head dim (a multiple of 16, the tensors' own); d_out the
// columns of O a head (<= D). window: 0 for none, else >= 1 (causal only).
template <typename T, int NW>
__global__ void __launch_bounds__(GShape<NW>::kThreads, 1)
    gen_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, void* __restrict__ O,
               int S, int H, int Hkv, int D, int d_out, int causal,
               int window, int out_code, float qscale) {
  using G = GShape<NW>;
  constexpr int kStages = G::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int KB = (D + 63) / 64;            // boxes of the head dim
  const int SPT = (KB + NW - 1) / NW;      // stages of a tile's K (or V)
  unsigned char* qs = smem;                            // KB boxes of Q
  unsigned char* ring = qs + KB * BQ * kRow;           // kStages stages
  float* xs = reinterpret_cast<float*>(ring + kStages * G::kStageBytes);
  GBars<NW>* bars = reinterpret_cast<GBars<NW>*>(
      reinterpret_cast<unsigned char*>(xs) + G::kXBytes);

  const int tid = threadIdx.x;
  const int nq = (S + BQ - 1) / BQ;
  const int qt = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int hi = causal ? (q0 + BQ - 1) / BKV : (S + BKV - 1) / BKV - 1;
  const int lo = causal && window > 0 ? max(0, (q0 - window + 1) / BKV) : 0;
  const int nkv = hi + 1 - lo;

  if (tid == 0) {
    mbar_init(&bars->q, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&bars->full[i], 1);
      mbar_init(&bars->empty[i], G::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= G::kConsumers) {   // the producer warp: one thread issues
    if (tid == G::kConsumers) {
      mbar_expect_tx(&bars->q, KB * BQ * kRow);
      for (int bx = 0; bx < KB; ++bx)
        tma_load_3d(qs + bx * BQ * kRow, &tq, &bars->q, h * D + 64 * bx, q0,
                    b);
      int seq = 0;
      for (int j = 0; j < nkv; ++j) {
        const int row = (lo + j) * BKV;
        for (int half = 0; half < 2; ++half) {
          const CUtensorMap* map = half ? &tv : &tk;
          for (int k = 0; k < SPT; ++k, ++seq) {
            const int st = seq % kStages;
            if (seq >= kStages)
              mbar_wait(&bars->empty[st], (seq / kStages - 1) & 1);
            const int nbox = min(NW, KB - k * NW);
            mbar_expect_tx(&bars->full[st], nbox * kBox);
            for (int w = 0; w < nbox; ++w)
              tma_load_3d(ring + st * G::kStageBytes + w * kBox, map,
                          &bars->full[st], hk * D + 64 * (k * NW + w), row,
                          b);
          }
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg, its warp w4 owns q rows 16 w4 ..; a
  // thread holds rows g and g + 8 of them (wgmma's accumulator layout).
  const int wg = tid / 128, tw = tid % 128;
  const int lane = tw % 32, g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + (tw / 32) * 16 + g, r_hi = r_lo + 8;
  const int nb = (KB - wg + NW - 1) / NW;   // the warpgroup's boxes

  mbar_wait(&bars->q, 0);
  {
    // Q -> Q * log2(e)/sqrt(D), rounded to T, in place; columns >= D (the
    // next head's, or zeros) -> 0. Chunk c of row r of a box sits at
    // chunk c ^ (r % 8) (the 128-byte swizzle).
    uint4* q4 = reinterpret_cast<uint4*>(qs);
    for (int i = tid; i < KB * BQ * 8; i += G::kConsumers) {
      uint4 x = q4[i];
      uint32_t* w = reinterpret_cast<uint32_t*>(&x);
      const int within = i % (BQ * 8), r = within / 8;
      const int col0 = (i / (BQ * 8)) * 64 + (((within % 8) ^ (r & 7)) * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = Elem<T>::to2(w[e]);
        w[e] = col0 + 2 * e < D ? Elem<T>::from2(f.x * qscale, f.y * qscale)
                                : 0u;
      }
      q4[i] = x;
    }
    fence_proxy_async();
    asm volatile("bar.sync 1, %0;\n" ::"n"(G::kConsumers) : "memory");
  }
  const uint32_t q_addr = smem_u32(qs);
  const uint32_t ring_addr = smem_u32(ring) + wg * kBox;

  auto mask = [&](float (&s)[1][32], int kt) {
    const int kb = kt * BKV;
    const bool diag = causal && kb + BKV - 1 > q0;
    const bool edge = causal && window > 0 && kb < q0 + BQ - window;
    const bool tail = !causal && kb + BKV > S;
    if (!diag && !edge && !tail) return;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int key = kb + n * 8 + 2 * t;
      float* e = &s[0][4 * n];
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
  };

  float o[4][32];   // the warpgroup's O slab, one box of 64 columns each
  float s[1][32];
  uint32_t p[1][16];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[0][i] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k][i] = 0.f;
  }
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  int seq = 0;

  // A stage is released once the products reading it are done: the
  // products of box k are issued before those of box k - 1 are waited for
  // (wgmma_wait<1>), so two boxes' products are in flight at a time; a
  // stage with no box of this warpgroup waits for all (its own boxes come
  // first).
  auto release = [&](int k, int st_prev) {
    if (k < nb) wgmma_wait<1>();
    else wgmma_wait<0>();
    mbar_arrive(&bars->empty[st_prev]);
  };

  for (int j = 0; j < nkv; ++j) {
    // this warpgroup's share of S = Q K^T: its K boxes, k16 steps in D
    int st_prev = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= SPT) break;
      const int st = seq % kStages;
      mbar_wait(&bars->full[st], (seq / kStages) & 1);
      if (k < nb) {
        const int bx = k * NW + wg;
        const int steps = min(4, (D - 64 * bx) / 16);
        wgmma_fence();
        for (int kk = 0; kk < steps; ++kk)
          fa::wgmma_ss<T, false>(
              s[0], desc_sw128(q_addr + bx * BQ * kRow + kk * 32),
              desc_sw128(ring_addr + st * G::kStageBytes + kk * 32),
              k > 0 || kk > 0);
        wgmma_commit();
      }
      if (k > 0) release(k, st_prev);
      st_prev = st;
      ++seq;
    }
    wgmma_wait<0>();
    fence_regs(s[0]);
    mbar_arrive(&bars->empty[st_prev]);
    if constexpr (NW > 1) {
      // the partial scores meet in shared memory, [wg][chunk][thread]
      float4* x4 = reinterpret_cast<float4*>(xs);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        x4[(wg * 8 + c) * 128 + tw] = make_float4(
            s[0][4 * c], s[0][4 * c + 1], s[0][4 * c + 2], s[0][4 * c + 3]);
      asm volatile("bar.sync 2, %0;\n" ::"n"(G::kConsumers) : "memory");
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float4 acc = x4[c * 128 + tw];
#pragma unroll
        for (int w = 1; w < NW; ++w) {
          const float4 y = x4[(w * 8 + c) * 128 + tw];
          acc.x += y.x;
          acc.y += y.y;
          acc.z += y.z;
          acc.w += y.w;
        }
        s[0][4 * c] = acc.x;
        s[0][4 * c + 1] = acc.y;
        s[0][4 * c + 2] = acc.z;
        s[0][4 * c + 3] = acc.w;
      }
      // every warpgroup has read them before any writes the next tile's
      asm volatile("bar.sync 2, %0;\n" ::"n"(G::kConsumers) : "memory");
    }
    mask(s, lo + j);
    float alpha_lo, alpha_hi;
    fa::softmax_tile<T, 1>(s, p, m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[k][4 * n] *= alpha_lo;
        o[k][4 * n + 1] *= alpha_lo;
        o[k][4 * n + 2] *= alpha_hi;
        o[k][4 * n + 3] *= alpha_hi;
      }
    }
    // O += P V over the warpgroup's V boxes, 16 keys (2048 bytes) a step
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= SPT) break;
      const int st = seq % kStages;
      mbar_wait(&bars->full[st], (seq / kStages) & 1);
      if (k < nb) {
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint32_t a[4] = {p[0][4 * ks], p[0][4 * ks + 1],
                                 p[0][4 * ks + 2], p[0][4 * ks + 3]};
          fa::wgmma_rs_t<T>(o[k], a,
                            desc_sw128(ring_addr + st * G::kStageBytes +
                                       ks * 2048));
        }
        wgmma_commit();
      }
      if (k > 0) release(k, st_prev);
      st_prev = st;
      ++seq;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < 4; ++k) fence_regs(o[k]);
    keep_regs(p[0]);
    mbar_arrive(&bars->empty[st_prev]);
  }

  // every row attends at least one key (its own, or key 0): l > 0
  const float inv_lo = 1.f / fmaxf(l_lo, 1e-30f);
  const float inv_hi = 1.f / fmaxf(l_hi, 1e-30f);
  const size_t q_row = (size_t)H * d_out;   // elements of O a token row
  const size_t lo_idx = ((size_t)b * S + r_lo) * q_row + (size_t)h * d_out;
  const size_t hi_idx = lo_idx + 8 * q_row;
  const bool pairs = d_out % 2 == 0;
  auto store = [&](auto* out) {   // in the output type, chosen once
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k >= nb) break;
      const int bx = k * NW + wg;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int d = bx * 64 + n * 8 + 2 * t;
        if (d >= d_out) continue;
        const bool second = d + 1 < d_out;
        if (r_lo < S)
          store_pair(out + lo_idx + d, o[k][4 * n] * inv_lo,
                     o[k][4 * n + 1] * inv_lo, pairs, second);
        if (r_hi < S)
          store_pair(out + hi_idx + d, o[k][4 * n + 2] * inv_hi,
                     o[k][4 * n + 3] * inv_hi, pairs, second);
      }
    }
  };
  if (out_code == fa::kOutF32)
    store(static_cast<float*>(O));
  else if (out_code == fa::kOutBF16)
    store(static_cast<__nv_bfloat16*>(O));
  else
    store(static_cast<half*>(O));
}

template <typename T, int NW>
int launch(const void* Q, const void* K, const void* V, void* O, int B,
           int S, int H, int Hkv, int D, int d_out, int causal, int window,
           int out_code, const int* pitch, float qscale,
           cudaStream_t stream) {
  using G = GShape<NW>;
  static_assert(G::smem(4 * NW) <= fa::kMaxSmem, "fits a block's smem");
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!fa::map_rows<T>(encode, &tq, Q, B, S, H, D, BQ, pitch[0]) ||
      !fa::map_rows<T>(encode, &tk, K, B, S, Hkv, D, BKV, pitch[1]) ||
      !fa::map_rows<T>(encode, &tv, V, B, S, Hkv, D, BKV, pitch[2]))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices];
  cudaError_t err =
      set_max_smem_once(gen_kernel<T, NW>, G::smem(4 * NW), smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  gen_kernel<T, NW><<<grid, G::kThreads, G::smem((D + 63) / 64), stream>>>(
      tq, tk, tv, O, S, H, Hkv, D, d_out, causal, causal ? window : 0,
      out_code, qscale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const void* Q, const void* K, const void* V, void* O,
                 int B, int S, int H, int Hkv, int D, int d_out, int causal,
                 int window, int out_code, const int* pitch, float qscale,
                 cudaStream_t stream) {
  if (D <= 256)
    return launch<T, 1>(Q, K, V, O, B, S, H, Hkv, D, d_out, causal, window,
                        out_code, pitch, qscale, stream);
  if (D <= 512)
    return launch<T, 2>(Q, K, V, O, B, S, H, Hkv, D, d_out, causal, window,
                        out_code, pitch, qscale, stream);
  return launch<T, 3>(Q, K, V, O, B, S, H, Hkv, D, d_out, causal, window,
                      out_code, pitch, qscale, stream);
}

}  // namespace fag
}  // namespace bbt

// head_dim: the tensors' head dim D (D % 16 == 0, up to kMaxHeadDim);
// d_out: O's (the true head dim, <= D); bf16: Q, K and V bfloat16 (else
// float16); out_code 0 float16, 1 bfloat16, 2 float32; window 0 for none
// (causal only), a window >= S is none; q_pitch / k_pitch / v_pitch: the
// elements between two token rows (heads * D or more, 16-byte multiples).
extern "C" int flash_attention_general(
    const void* Q, const void* K, const void* V, void* O, int B, int S,
    int H, int Hkv, int head_dim, int d_out, int bf16, int out_code,
    int causal, int window, int q_pitch, int k_pitch, int v_pitch,
    float qscale, void* stream) {
  const int D = head_dim;
  const int pitch[3] = {q_pitch, k_pitch, v_pitch};
  if (D < 16 || D > bbt::fag::kMaxHeadDim || D % 16 != 0 || d_out < 1 ||
      d_out > D || S < 1 || B < 1 || Hkv < 1 || H % Hkv != 0 ||
      (S + bbt::fa::BQ - 1) / bbt::fa::BQ > 65535 || window < 0 ||
      (window && !causal) || out_code < bbt::fa::kOutF16 ||
      out_code > bbt::fa::kOutF32 || q_pitch < H * D || k_pitch < Hkv * D ||
      v_pitch < Hkv * D || q_pitch % 8 || k_pitch % 8 || v_pitch % 8)
    return (int)cudaErrorInvalidValue;
  if (window >= S) window = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bbt::fag::launch_width<__nv_bfloat16>(
        Q, K, V, O, B, S, H, Hkv, D, d_out, causal, window, out_code, pitch,
        qscale, st);
  return bbt::fag::launch_width<half>(Q, K, V, O, B, S, H, Hkv, D, d_out,
                                      causal, window, out_code, pitch, qscale,
                                      st);
}
