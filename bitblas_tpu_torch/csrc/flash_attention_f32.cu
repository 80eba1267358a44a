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
// What bounds it on the H100: the products, 4*B*H*S^2*D FLOPs (half with
// causality). One TF32 product keeps 11 bits of each operand and would
// miss float32 results by about 1e-3 relative, so every product is the
// 3xTF32 split (CUTLASS's OpMultiplyAddFastF32 arithmetic): x = hi + lo,
// hi = tf32(x), lo = tf32(x - hi) (cvt.rna.tf32 rounding), a b = hi_a lo_b +
// lo_a hi_b + hi_a hi_b (lo_a lo_b, about 2^-22 of a b, is dropped), three
// mma.sync.m16n8k8 TF32 products accumulated in float32, the small terms
// first. The float32-accurate rate is then a third of the 495 TFLOP/s
// TF32 tensor cores, above the 67 TFLOP/s FFMA rate.
//
// Design (FlashAttention-2's partition, 16 query rows a warp). A block
// holds 16 RG query rows (RG row groups) and D is cut into parts of DPART
// columns, one warp a (row group, part): nwc = ceil(Dp / DPART) warps a
// row group (Dp = D rounded up to 8; the pad columns are zeros). A warp
// keeps its rows' Q hi and lo fragments of its part in registers, split
// once when the block loads Q, and its output columns' accumulators. Per
// key tile of BK keys:
//   - cp.async brings the raw float32 K and V tiles into a staging area
//     (the next tile's copies fly while this one is computed); the block
//     splits each once into hi and lo planes, K as [key][dim] and V with
//     keys 2j and 2j + 1 interleaved, pitches chosen so that every
//     fragment read is one conflict-free 64-bit load;
//   - each warp computes its part's dot products for its 16 rows x BK
//     keys; with nwc > 1 the warps of a row group exchange these partial
//     scores through shared memory and each sums all parts in part order
//     0 .. nwc-1, so the scores are computed once a tile and every warp of
//     the row group holds the same scores, m and l bit for bit;
//   - the online softmax runs on the score fragments, and P feeds the P V
//     product straight from them: the mma's reduction index k = t (t + 4)
//     is mapped to key 2t (2t + 1), so the accumulator's (row g, keys 2t,
//     2t + 1) is the A fragment, with no shuffle; V's fragments take the
//     same map (the interleaved keys). Q's and K's dims take it too.
// The tensor cores' float32 sums truncate, so no mma chain runs long: in
// Q K^T the small terms sum apart from hi hi, a part's dot products and a
// tile's P V sums start from zero, and they join the scores or O in
// float32 adds (one chain over 2048 keys drifted 4x past the limit).
// Tiles by Dp (shared memory and registers): up to 32, 64 rows and
// 64-key tiles; up to 128, 64 rows and 32 keys (parts of 64 columns, two
// warps a row group at D = 128); up to 384, 32 rows and 16 keys; up to
// 768, 16 rows and 8 keys (175 KB at D = 384 and 768: the planes and the
// staging of a bigger tile do not fit 227 KB, and a warp's registers hold
// one 64-column part of 16 rows, so the widest heads run narrow tiles).
// The walk and the masks are kernel 4's: causal tiles 0 .. the q tile's
// last row (from the band's first tile with a window, a max of -inf taken
// as 0 in the exponents; masks only on the tiles that cross S, the
// diagonal or the band's edge), dense every tile, keys >= S masked.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kOutF16 = 0, kOutBF16 = 1, kOutF32 = 2;
constexpr int kMaxHeadDim = 768;   // kernels/flash.py GENERAL_MAX_HEAD_DIM

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared memory in floats for head dims padded to Dp (the parts' columns
// to Wp = nwc DPART), BK-key tiles, BQ query rows and nwc parts: the K
// planes [BK][kp] (hi, lo; columns Dp .. Wp zeros), the V planes [BK /
// 2][vp] (hi, lo; keys 2j and 2j + 1 interleaved), the raw staging tiles
// (K [BK][Dp] or K^T [Dp][BK], then V [BK][Dp]) and, with nwc > 1, the
// partial scores [nwc][BQ][xp]. Each pitch is 8 floats past a multiple of 32 (a
// row's 64-bit fragment reads at 2t land on distinct banks).
struct Smem {
  int kp, vp, xp, k_hi, k_lo, v_hi, v_lo, sk, xs, total;
};

__host__ __device__ inline Smem smem_layout(int Dp, int Wp, int BK, int BQ,
                                            int nwc) {
  Smem s;
  s.kp = round_up(Wp, 32) + 8;
  s.vp = round_up(2 * Wp, 32) + 8;
  s.xp = round_up(BK, 32) + 8;
  s.k_hi = 0;
  s.k_lo = s.k_hi + BK * s.kp;
  s.v_hi = s.k_lo + BK * s.kp;
  s.v_lo = s.v_hi + BK / 2 * s.vp;
  s.sk = s.v_lo + BK / 2 * s.vp;
  s.xs = s.sk + 2 * BK * Dp;
  s.total = s.xs + (nwc > 1 ? nwc * BQ * s.xp : 0);
  return s;
}

// float32 -> TF32 (a 10-bit mantissa), round to nearest, ties away from
// 0. cvt.rna.tf32.f32 keeps Inf and NaN. The integer form (half an ulp
// added to the magnitude's bits, the 13 low bits dropped) rounds every
// finite x the same way, but a NaN whose high mantissa bits are all ones
// (0x7fffffff, CUDA's NaN) carries into the sign and comes out as -0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t tf32_finite(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32. hi by cvt.rna, so a NaN or Inf in x stays in
// hi and reaches the mma; lo = x - hi is finite wherever hi is, and where
// hi is not, hi carries the NaN or Inf itself, so lo takes the integer
// form.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_finite(x - __uint_as_float(hi));
}

__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  uint32_t h[4], l[4];
  split(x.x, h[0], l[0]);
  split(x.y, h[1], l[1]);
  split(x.z, h[2], l[2]);
  split(x.w, h[3], l[3]);
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
  return make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                     __uint_as_float(h[2]), __uint_as_float(h[3]));
}

// D (16x8) += A (16x8, row) B (8x8, col), TF32 operands, f32 sums.
// Fragment ownership (g = lane / 4, t = lane % 4):
//   a[0]: (row g, k t)  a[1]: (row g+8, k t)  a[2]: (row g, k t+4)
//   a[3]: (row g+8, k t+4)  b[0]: (k t, col g)  b[1]: (k t+4, col g)
//   d[0..1]: (row g, col 2t..2t+1)  d[2..3]: (row g+8, col 2t..2t+1)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 3xTF32 product of one fragment pair, the small terms first (into
// `small`, which may be `big`).
__device__ __forceinline__ void mma3(float* big, float* small,
                                     const uint32_t* ah, const uint32_t* al,
                                     const uint32_t* bh, const uint32_t* bl) {
  mma_tf32(small, al, bh);
  mma_tf32(small, ah, bl);
  mma_tf32(big, ah, bh);
}

__device__ __forceinline__ uint2 lds_u2(const float* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// A thread's walk over a [rows][cols] grid with the block's stride, row
// and column carried along (cols is a run-time value: no division a step).
struct Walk {
  int r, c, sr, sc, cols;
  __device__ __forceinline__ Walk(int start, int step, int cols_)
      : r(start / cols_), c(start % cols_), sr(step / cols_),
        sc(step % cols_), cols(cols_) {}
  __device__ __forceinline__ void next() {
    r += sr;
    c += sc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
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

// DPART: a warp's columns (k-steps of Q K^T, n-tiles of P V: DPART / 8);
// RG: the block's row groups of 16 rows; BK: keys a tile; DMAX: the
// instance's largest padded head dim.
template <int DPART, int RG, int BK, int DMAX>
__global__ void __launch_bounds__(32 * RG * (DMAX / DPART))
    f32_kernel(const float* __restrict__ Q, const float* __restrict__ K,
               const float* __restrict__ V, void* __restrict__ O, int S,
               int H, int Hkv, int D, int causal, int trans_k, int window,
               int out_code, float qscale) {
  constexpr int BQ = 16 * RG, KS = DPART / 8, NK = BK / 8;
  extern __shared__ __align__(16) float sm[];
  const int Dp = round_up(D, 8);
  const int nwc = (Dp + DPART - 1) / DPART;
  const int nthreads = 32 * RG * nwc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / nwc, part = warp % nwc;
  const int Wp = nwc * DPART;
  const Smem L = smem_layout(Dp, Wp, BK, BQ, nwc);
  const int nq = (S + BQ - 1) / BQ;
  const int qt = causal ? nq - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int r0 = q0 + 16 * rg + g;         // the thread's rows r0, r0 + 8
  const int d0 = part * DPART;             // the part's first column
  const int nkt = (S + BK - 1) / BK;
  const int hi_t = causal ? min((q0 + BQ - 1) / BK, nkt - 1) : nkt - 1;
  const int lo_t = causal && window > 0 ? max(0, (q0 - window + 1) / BK) : 0;
  const size_t kv_row = (size_t)Hkv * D;   // a key's stride in K and V
  const size_t kv_head = (size_t)b * S * kv_row + (size_t)hk * D;

  // Q's fragments of the part, scaled and split once
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e & 1) * 8, dim = d0 + 8 * ks + 2 * t + (e >> 1);
      const float x =
          row < S && dim < D
              ? Q[(((size_t)b * S + row) * H + h) * D + dim] * qscale
              : 0.f;
      split(x, qh[ks][e], ql[ks][e]);
    }

  // Raw tile kt into the staging area; keys >= S and dims >= D zeros.
  auto stage = [&](int kt) {
    const int kb = kt * BK;
    float* sk = sm + L.sk;
    float* sv = sk + BK * Dp;
    if (D % 4 == 0) {
      for (Walk w(tid, nthreads, Dp / 4); w.r < BK; w.next()) {
        const int j = w.r, d = w.c * 4;
        const bool ok = kb + j < S && d < D;
        const size_t at = ok ? kv_head + (size_t)(kb + j) * kv_row + d : 0;
        bbt::cp_async16(sv + j * Dp + d, V + at, ok);
        if (!trans_k) bbt::cp_async16(sk + j * Dp + d, K + at, ok);
      }
    } else {
      for (Walk w(tid, nthreads, Dp); w.r < BK; w.next()) {
        const int j = w.r, d = w.c;
        const bool ok = kb + j < S && d < D;
        const size_t at = ok ? kv_head + (size_t)(kb + j) * kv_row + d : 0;
        bbt::cp_async4(sv + j * Dp + d, V + at, ok);
        if (!trans_k) bbt::cp_async4(sk + j * Dp + d, K + at, ok);
      }
    }
    if (!trans_k) return;
    // K^T [B, D, Hkv, S]: rows of keys, staged as [Dp][BK]
    const size_t kt_head = (size_t)b * D * Hkv * S + (size_t)hk * S;
    if (S % 4 == 0) {
      for (int i = tid; i < Dp * BK / 4; i += nthreads) {
        const int d = i / (BK / 4), j = i % (BK / 4) * 4;
        const bool ok = kb + j < S && d < D;
        const size_t at =
            ok ? kt_head + (size_t)d * Hkv * S + kb + j : 0;
        bbt::cp_async16(sk + d * BK + j, K + at, ok);
      }
    } else {
      for (int i = tid; i < Dp * BK; i += nthreads) {
        const int d = i / BK, j = i % BK;
        const bool ok = kb + j < S && d < D;
        const size_t at =
            ok ? kt_head + (size_t)d * Hkv * S + kb + j : 0;
        bbt::cp_async4(sk + i, K + at, ok);
      }
    }
  };

  // The staged tile split once into the hi and lo planes.
  auto split_tile = [&]() {
    const float* sk = sm + L.sk;
    const float* sv = sk + BK * Dp;
    auto split_k = [&](int j, int d, float4 x) {
      float4 lo;
      const float4 hi = split4(x, lo);
      *reinterpret_cast<float4*>(sm + L.k_hi + j * L.kp + d) = hi;
      *reinterpret_cast<float4*>(sm + L.k_lo + j * L.kp + d) = lo;
    };
    if (trans_k)   // K^T's staged columns: a warp's lanes on adjacent keys
      for (Walk w(tid, nthreads, BK); w.r < Dp / 4; w.next()) {
        const int j = w.c, d = w.r * 4;
        split_k(j, d, make_float4(sk[d * BK + j], sk[(d + 1) * BK + j],
                                  sk[(d + 2) * BK + j], sk[(d + 3) * BK + j]));
      }
    else
      for (Walk w(tid, nthreads, Dp / 4); w.r < BK; w.next())
        split_k(w.r, w.c * 4,
                *reinterpret_cast<const float4*>(sk + w.r * Dp + w.c * 4));
    // V: keys 2j and 2j + 1 side by side, [BK / 2][2 Dp]
    for (Walk w(tid, nthreads, Dp / 4); w.r < BK / 2; w.next()) {
      const int j = w.r, d = w.c * 4;
      float4 lo0, lo1;
      const float4 hi0 = split4(
          *reinterpret_cast<const float4*>(sv + 2 * j * Dp + d), lo0);
      const float4 hi1 = split4(
          *reinterpret_cast<const float4*>(sv + (2 * j + 1) * Dp + d), lo1);
      float* vh = sm + L.v_hi + j * L.vp + 2 * d;
      float* vl = sm + L.v_lo + j * L.vp + 2 * d;
      *reinterpret_cast<float4*>(vh) = make_float4(hi0.x, hi1.x, hi0.y, hi1.y);
      *reinterpret_cast<float4*>(vh + 4) =
          make_float4(hi0.z, hi1.z, hi0.w, hi1.w);
      *reinterpret_cast<float4*>(vl) = make_float4(lo0.x, lo1.x, lo0.y, lo1.y);
      *reinterpret_cast<float4*>(vl + 4) =
          make_float4(lo0.z, lo1.z, lo0.w, lo1.w);
    }
  };

  float o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // rows r0 and r0 + 8: running max (base 2) and this thread's share of
  // the sum (the quad's four shares add up at the end)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // the K planes' columns past Dp stay zeros: Q's are zeros, and a
  // product with stale bits there could be NaN
  for (int i = tid; i < BK * (Wp - Dp); i += nthreads) {
    const int at = i / (Wp - Dp) * L.kp + Dp + i % (Wp - Dp);
    sm[L.k_hi + at] = 0.f;
    sm[L.k_lo + at] = 0.f;
  }
  stage(lo_t);
  bbt::cp_async_commit();
  for (int kt = lo_t; kt <= hi_t; ++kt) {
    bbt::cp_async_wait<0>();
    __syncthreads();   // tile kt staged; the planes are free
    split_tile();
    __syncthreads();   // the planes are written; the staging is free
    if (kt < hi_t) stage(kt + 1);
    bbt::cp_async_commit();

    // (1) the part's dot products: rows g, g + 8 x keys 8n + 2t, + 1;
    // hi hi and the small terms in sums of their own (the tensor cores'
    // additions truncate: each chain rounds against sums of its size)
    float s[NK][4], small[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = small[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int at = (8 * n + g) * L.kp + d0 + 8 * ks + 2 * t;
        const uint2 bh = lds_u2(sm + L.k_hi + at), bl = lds_u2(sm + L.k_lo + at);
        const uint32_t bhi[2] = {bh.x, bh.y}, blo[2] = {bl.x, bl.y};
        mma3(s[n], small[n], qh[ks], ql[ks], bhi, blo);
      }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += small[n][e];
    if (nwc > 1) {
      // the row group's parts summed in part order 0 .. nwc-1
      float* xs = sm + L.xs;
      float* mine = xs + (part * BQ + 16 * rg + g) * L.xp + 2 * t;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        *reinterpret_cast<float2*>(mine + 8 * n) = make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(mine + 8 * L.xp + 8 * n) =
            make_float2(s[n][2], s[n][3]);
      }
      named_sync(1 + rg, 32 * nwc);
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      for (int p = 0; p < nwc; ++p) {
        const float* x = xs + (p * BQ + 16 * rg + g) * L.xp + 2 * t;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float2 a = *reinterpret_cast<const float2*>(x + 8 * n);
          const float2 c = *reinterpret_cast<const float2*>(x + 8 * L.xp + 8 * n);
          s[n][0] += a.x;
          s[n][1] += a.y;
          s[n][2] += c.x;
          s[n][3] += c.y;
        }
      }
    }

    // (2) the masks (on the tiles that cross S, the diagonal or the
    // band's edge) and the online softmax of rows r0, r0 + 8
    const int kb = kt * BK;
    if (kb + BK > S || (causal && kb + BK - 1 > q0) ||
        (window > 0 && kb <= q0 + BQ - 1 - window)) {
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + 8 * n + 2 * t + (e & 1);
          const int row = r0 + (e >> 1) * 8;
          if (key >= S || (causal && key > row) ||
              (window > 0 && key <= row - window))
            s[n][e] = -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mu[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    // (3) O = alpha O + P V over the tile's keys: k-step kk's A fragment
    // is the score fragment of keys 8 kk + 2t, + 1 (k = t, t + 4), split
    // once. The tile's products sum from zero and join O in one float32
    // rounding (one truncating chain over 2048 keys drifted 4x past the
    // limit).
    float acc[KS][4];
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t ph[4], pl[4];
      split(s[kk][0], ph[0], pl[0]);
      split(s[kk][2], ph[1], pl[1]);
      split(s[kk][1], ph[2], pl[2]);
      split(s[kk][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        const int at = (4 * kk + t) * L.vp + 2 * (d0 + 8 * n + g);
        const uint2 bh = lds_u2(sm + L.v_hi + at), bl = lds_u2(sm + L.v_lo + at);
        const uint32_t bhi[2] = {bh.x, bh.y}, blo[2] = {bl.x, bl.y};
        mma3(acc[n], acc[n], ph, pl, bhi, blo);
      }
    }
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[n][e] = fmaf(o[n][e], alpha[e >> 1], acc[n][e]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e >> 1) * 8;
      const int col = d0 + 8 * n + 2 * t + (e & 1);
      if (row < S && col < D)
        store1(O, (((size_t)b * S + row) * H + h) * D + col,
               o[n][e] * inv[e >> 1], out_code);
    }
  }
}

template <int DPART, int RG, int BK, int DMAX>
int launch(const void* Q, const void* K, const void* V, void* O, int B,
           int S, int H, int Hkv, int D, int causal, int trans_k, int window,
           int out_code, float qscale, cudaStream_t stream) {
  constexpr int BQ = 16 * RG;
  static bool smem_set[bbt::kMaxDevices];
  auto* kernel = f32_kernel<DPART, RG, BK, DMAX>;
  const int most = smem_layout(DMAX, DMAX, BK, BQ, DMAX / DPART).total * 4;
  cudaError_t err = bbt::set_max_smem_once(kernel, most, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int Dp = round_up(D, 8);
  const int nwc = (Dp + DPART - 1) / DPART;
  const dim3 grid(B * H, (S + BQ - 1) / BQ);
  kernel<<<grid, 32 * RG * nwc,
           smem_layout(Dp, nwc * DPART, BK, BQ, nwc).total * 4,
           stream>>>(static_cast<const float*>(Q),
                     static_cast<const float*>(K),
                     static_cast<const float*>(V), O, S, H, Hkv, D, causal,
                     trans_k, window, out_code, qscale);
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
      H % Hkv != 0 || (S + 15) / 16 > 65535 || window < 0 ||
      (window && !causal) || out_code < kOutF16 || out_code > kOutF32)
    return (int)cudaErrorInvalidValue;
  if (window >= S) window = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Dp = round_up(D, 8);
  if (Dp <= 32)
    return launch<32, 4, 64, 32>(Q, K, V, O, B, S, H, Hkv, D, causal,
                                 trans_k, window, out_code, qscale, st);
  if (Dp <= 128)
    return launch<64, 4, 32, 128>(Q, K, V, O, B, S, H, Hkv, D, causal,
                                  trans_k, window, out_code, qscale, st);
  if (Dp <= 384)
    return launch<64, 2, 16, 384>(Q, K, V, O, B, S, H, Hkv, D, causal,
                                  trans_k, window, out_code, qscale, st);
  return launch<64, 1, 8, 768>(Q, K, V, O, B, S, H, Hkv, D, causal, trans_k,
                               window, out_code, qscale, st);
}
