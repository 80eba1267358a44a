// Kernels 1 and 2 for every quantized weight format with float16 or
// bfloat16 activations (kernels/dequant_matmul.py dequant_matmul_fmt,
// kernels/materialize.py weight_decode_fmt): uint1/2/4, int1/2/4/8, nf4,
// fp4_e2m1 and fp8 e4m3 / e5m2 weights. Each dequant_fmt_*.cu source
// instantiates them for a few formats and one activation type
// (BBT_FMT_ENTRIES below), so that nvcc builds the sources in parallel.
//
// Replaces bitblas_tpu/kernels/dequant_matmul.py:make_dequant_matmul (its
// pallas_call at :629) for these formats, and
// bitblas_tpu/kernels/materialize.py:make_weight_decode_pallas (:378).
//
// What they compute, on the Hopper layout of quantization/packing.py:
//   A      [M, K]        A's type (f16 / bf16), row-major
//   Wq     [N, K*b/32]   int32, 32/b codes of b bits a word along K, LSB
//                        first (int b < 8 biased by 2^(b-1); 8-bit formats
//                        one byte a code)
//   scales [K/g, N]      A's type     zeros [K/g, N] A's type (uint only)
//   bias   [N]           float32, or none
//   out    [M, N]        A's type or float32
// W[n, k] is the code decoded to A's type (decode_formats.cuh) with its
// scale and zero applied there, bit for bit the plain version's dense
// weight (ops/reference.py dequantize_weight, the JAX oracle); the
// products sum in f32, the bias is added and the sum rounded once. Kernel
// and plain version differ only in the order of the f32 sums. Kernel 2
// writes that weight, [N, K] in A's type.
//
// What bounds it on the H100: at decode M the weight bytes, N K b / 8 plus
// the scale and zero bytes, over 3.35 TB/s; at prefill M the tensor
// cores, 2 M N K over 989 TFLOP/s. Kernel 2: its bytes.
//
// The decode instance (M <= 16; kernels/dequant_matmul.py fmt_decode_tile)
// has the design of the uint4 one (dequant_matmul.cu): mma.sync m16n8k16
// with the weight on its 16-row side and the tokens on its 8-wide side, a
// warp 16 weight rows (thread (g, t): rows 2 g and 2 g + 1 of its warp's
// 16, the mma's rows g and g + 8), 8 warps a block, K split across blocks
// in whole steps (plan_splits_fmt), a thread's 16-byte weight chunks of
// both its rows and their scale / zero pairs streamed through a private
// 4-stage cp.async ring. A quad's four threads take the four 16-byte
// chunks of a 64-byte slice of each row, so a step is 512 / b of K. What
// differs:
//   - Each thread decodes only its own chunk: product q of a step takes
//     codes 4 q .. 4 q + 3 of thread t's chunk as logical k 2t, 2t + 1
//     and 2t + 8, 2t + 9. A's copy in shared memory follows: the 8 bytes
//     of token m at those k lie together ([m][step][q][t], rows padded by
//     32 bytes so that a warp's reads hit 32 banks). No sums of A: the
//     scale and zero apply to each decoded pair in A's type, as the plain
//     version applies them, so a step straddling groups (b = 1: 128 codes
//     a chunk against g = 32) takes each word's pair (up to four pairs a
//     chunk) with no correction of sums.
//   - The K range of a split in shared memory is at most FMT_MAX_SPLIT_K
//     (1024) of K; a K tail past the last whole step (K a multiple of 128)
//     is zero: zero activations add nothing whatever the weight decodes
//     to, and zero-filled weight chunks decode to finite values.
// Each split writes its f32 partial; the last block of each (N tile, M
// tile), by an atomic on the per-device counter it resets, sums them in
// split order, adds the bias and rounds once: one launch a call and the
// same bits on every call.
//
// Kernel 2: eight codes a thread and iteration, decoded and scaled and
// written with one 16-byte store, a warp's stores 512 contiguous bytes
// (N K b / 8 bytes read, 2 N K written).
//
// The tiled instance (M > 16): dequant_wgmma.cuh with the Fmt functor.
#pragma once

#include "common.cuh"
#include "decode_formats.cuh"
#include "dequant_wgmma.cuh"

namespace bbt {
namespace fmt {

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecBN = kDecWarps * 16;   // weight rows a block
constexpr int kDecStages = 4;
constexpr int kMaxSplitK = 1024;         // K of a split's A in shared memory

template <class Fam>
struct DecGeom {
  static constexpr int B = Fam::kBits;
  static constexpr int C = 128 / B;        // codes of a thread's chunk
  static constexpr int KS = 4 * C;         // K of a step (a quad's 4 chunks)
  static constexpr int Q = C / 4;          // products a step
  static constexpr int P = C > 32 ? C / 32 : 1;   // scale pairs a chunk
  // ring stage: [2 rows][threads] 16-byte chunks, then [P][threads] scale
  // pairs and [P][threads] zero pairs
  static constexpr int kStageBytes = kDecThreads * (2 * 16 + 2 * P * 4);
  static constexpr int kMaxChunk = kMaxSplitK / KS;
  // A: [16 rows][steps][Q][4] 8-byte units, each row padded by 32 bytes
  __host__ __device__ static constexpr int a_row_bytes(int chunk) {
    return chunk * KS * 2 + 32;
  }
  __host__ __device__ static constexpr int smem_bytes(int chunk) {
    return 16 * a_row_bytes(chunk) + kDecStages * kStageBytes;
  }
};

template <class Fam, class AT, int NB8, int MODE>
__global__ void __launch_bounds__(kDecThreads)
    fmt_decode_kernel(const typename AT::T* __restrict__ A,
                      const uint32_t* __restrict__ Wq,
                      const typename AT::T* __restrict__ scales,
                      const typename AT::T* __restrict__ zeros,
                      const float* __restrict__ bias, void* __restrict__ out,
                      int out_f32, float* __restrict__ part,
                      int* __restrict__ count, int M, int N, int K,
                      int chunk, int group) {
  using G = DecGeom<Fam>;
  constexpr int B = G::B, C = G::C, KS = G::KS, Q = G::Q, P = G::P;
  constexpr int ROWS = NB8 * 8;            // rows of A a block holds
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint16_t lut[16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y, splits = gridDim.y;
  const int steps = (K + KS - 1) / KS;
  const int s0 = split * chunk;
  const int ns = min(chunk, steps - s0);   // >= 1: the planner's splits
  const int m0 = blockIdx.z * 16;
  const int mrows = min(16, M - m0);
  const int KW = K * B / 32;               // words of a weight row
  const int n_lo = blockIdx.x * kDecBN + warp * 16 + 2 * g;
  const bool n_ok = n_lo < N;              // N % 8 == 0: n_lo + 1 too
  const int a_row = G::a_row_bytes(chunk) / 8;   // in 8-byte units
  if constexpr (Fam::kLut) {
    if (tid < 16) lut[tid] = AT::kBf16 ? kNf4Bf16[tid] : kNf4F16[tid];
  }

  uint2* As = reinterpret_cast<uint2*>(smem);
  unsigned char* ring = smem + 16 * G::a_row_bytes(chunk);
  auto ring_w = [&](int st, int r) {
    return reinterpret_cast<uint4*>(ring + st * G::kStageBytes) +
           r * kDecThreads + tid;
  };
  // r = 0: scales, 1: zeros; pair p
  auto ring_sz = [&](int st, int r, int p) {
    return reinterpret_cast<uint32_t*>(ring + st * G::kStageBytes +
                                       2 * 16 * kDecThreads) +
           (r * P + p) * kDecThreads + tid;
  };
  auto load_step = [&](int si, int st) {
    const int kc = (s0 + si) * KS + t * C;   // K of this thread's chunk
    const bool ok = n_ok && kc < K;          // K % C == 0: all or nothing
    const uint32_t* w = Wq + (size_t)n_lo * KW + kc * B / 32;
    bbt::cp_async16(ring_w(st, 0), ok ? w : Wq, ok);
    bbt::cp_async16(ring_w(st, 1), ok ? w + KW : Wq, ok);
    if constexpr (MODE != kNone) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const size_t at = (size_t)((kc + p * (C / P)) / group) * N + n_lo;
        bbt::cp_async4(ring_sz(st, 0, p), ok ? scales + at : scales, ok);
        if (zeros != nullptr)
          bbt::cp_async4(ring_sz(st, 1, p), ok ? zeros + at : zeros, ok);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < ns) load_step(s, s);
    bbt::cp_async_commit();
  }
  // A's rows m0 .. m0 + ROWS - 1 over the split's K range: 16 bytes (8 k)
  // of global row m at a time, into units (m, step, q, t) and (.., q + 1,
  // ..) of that k; rows past M and K past the end are zeros
  const int per_row = ns * KS / 8;
  for (int c = tid; c < ROWS * per_row; c += kDecThreads) {
    const int m = c / per_row, kl = (c % per_row) * 8;
    const int k = s0 * KS + kl;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (m < mrows && k < K)
      x = __ldg(reinterpret_cast<const uint4*>(A + (size_t)(m0 + m) * K + k));
    const int si = kl / KS, tt = (kl % KS) / C, q = (kl % C) / 4;
    uint2* dst = As + (size_t)m * a_row + (si * Q + q) * 4 + tt;
    dst[0] = make_uint2(x.x, x.y);
    dst[4] = make_uint2(x.z, x.w);
  }
  __syncthreads();

  float acc[NB8][4];
#pragma unroll
  for (int h = 0; h < NB8; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;

  for (int si = 0; si < ns; ++si) {
    const int st = si % kDecStages;
    bbt::cp_async_wait<kDecStages - 2>();   // this thread's step si
    const uint4 wl = *ring_w(st, 0), wh = *ring_w(st, 1);
    const uint32_t lo[4] = {wl.x, wl.y, wl.z, wl.w};
    const uint32_t hi[4] = {wh.x, wh.y, wh.z, wh.w};
    uint32_t s_lo[P], s_hi[P], z_lo[P], z_hi[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      s_lo[p] = s_hi[p] = z_lo[p] = z_hi[p] = 0u;
      if constexpr (MODE != kNone) {
        const uint32_t s = *ring_sz(st, 0, p);
        s_lo[p] = __byte_perm(s, 0, 0x1010);
        s_hi[p] = __byte_perm(s, 0, 0x3232);
        if (zeros != nullptr) {
          const uint32_t z = *ring_sz(st, 1, p);
          z_lo[p] = __byte_perm(z, 0, 0x1010);
          z_hi[p] = __byte_perm(z, 0, 0x3232);
        }
      }
    }
    if (si + kDecStages - 1 < ns)
      load_step(si + kDecStages - 1, (si + kDecStages - 1) % kDecStages);
    bbt::cp_async_commit();
    const uint2* ag = As + (size_t)si * Q * 4 + t;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      // codes 4 q .. 4 q + 3 of the chunk: word 4 q b / 32, pair p of it
      constexpr int kWordCodes = 32 / B;
      const int p = (4 * q / kWordCodes) * (32 / B) / (C / P);
      uint32_t a[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t rl = raw_pair<B>(lo, 4 * q + 2 * j);
        const uint32_t rh = raw_pair<B>(hi, 4 * q + 2 * j);
        a[2 * j] = scale2<AT, MODE>(Fam::template convert<AT>(rl, lut),
                                    s_lo[p], z_lo[p]);
        a[2 * j + 1] = scale2<AT, MODE>(Fam::template convert<AT>(rh, lut),
                                        s_hi[p], z_hi[p]);
      }
#pragma unroll
      for (int h = 0; h < NB8; ++h) {
        const uint2 x = ag[(size_t)(h * 8 + g) * a_row + q * 4];
        const uint32_t b[2] = {x.x, x.y};
        AT::mma(acc[h], a, b);
      }
    }
  }
  bbt::cp_async_wait<0>();

  float b_lo = 0.f, b_hi = 0.f;
  if (bias != nullptr && n_ok) {
    b_lo = bias[n_lo];
    b_hi = bias[n_lo + 1];
  }
  // acc[h]: (row lo, token 2t), (lo, 2t + 1), (hi, 2t), (hi, 2t + 1) of
  // tokens m0 + 8 h ...
  auto store = [&](int m, float lo_v, float hi_v) {
    const size_t at = (size_t)(m0 + m) * N + n_lo;
    if (out_f32)
      *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
          make_float2(lo_v, hi_v);
    else
      *reinterpret_cast<uint32_t*>(static_cast<typename AT::T*>(out) + at) =
          AT::pack(lo_v, hi_v);
  };
  if (splits == 1) {
    if (!n_ok) return;
#pragma unroll
    for (int h = 0; h < NB8; ++h) {
      const int m = 8 * h + 2 * t;
      if (m < mrows) store(m, acc[h][0] + b_lo, acc[h][2] + b_hi);
      if (m + 1 < mrows) store(m + 1, acc[h][1] + b_lo, acc[h][3] + b_hi);
    }
    return;
  }
  auto at = [&](int sp, int m) {
    return part + ((size_t)sp * M + m0 + m) * N + n_lo;
  };
  if (n_ok) {
#pragma unroll
    for (int h = 0; h < NB8; ++h) {
      const int m = 8 * h + 2 * t;
      if (m < mrows)
        *reinterpret_cast<float2*>(at(split, m)) =
            make_float2(acc[h][0], acc[h][2]);
      if (m + 1 < mrows)
        *reinterpret_cast<float2*>(at(split, m + 1)) =
            make_float2(acc[h][1], acc[h][3]);
    }
  }
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = count + (size_t)blockIdx.z * gridDim.x + blockIdx.x;
    last = atomicAdd(cnt, 1) == splits - 1;
    if (last) *cnt = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!last || !n_ok) return;
  __threadfence();
#pragma unroll
  for (int h = 0; h < NB8; ++h) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * h + 2 * t + e;
      if (m >= mrows) continue;
      float2 o = make_float2(0.f, 0.f);
      for (int sp = 0; sp < splits; ++sp) {
        const float2 p = __ldcg(reinterpret_cast<const float2*>(at(sp, m)));
        o.x += p.x;
        o.y += p.y;
      }
      store(m, o.x + b_lo, o.y + b_hi);
    }
  }
}

template <class Fam, class AT, int NB8, int MODE>
cudaError_t launch_decode(const void* A, const void* Wq, const void* s,
                          const void* z, const float* bias, void* out,
                          int out_f32, float* part, int* count, int M, int N,
                          int K, int group, int chunk, int splits,
                          cudaStream_t st) {
  using G = DecGeom<Fam>;
  using T = typename AT::T;
  auto kernel = fmt_decode_kernel<Fam, AT, NB8, MODE>;
  static bool smem_set[kMaxDevices];
  cudaError_t err =
      set_max_smem_once(kernel, G::smem_bytes(G::kMaxChunk), smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kDecBN - 1) / kDecBN, splits, (M + 15) / 16);
  kernel<<<grid, kDecThreads, G::smem_bytes(chunk), st>>>(
      static_cast<const T*>(A), static_cast<const uint32_t*>(Wq),
      static_cast<const T*>(s), static_cast<const T*>(z), bias, out, out_f32,
      part, count, M, N, K, chunk, group);
  return cudaGetLastError();
}

using dqw::group_ok;

template <class Fam, class AT, int MODE>
cudaError_t run_decode(const void* A, const void* Wq, const void* s,
                       const void* z, const float* bias, void* out,
                       int out_f32, void* part, void* count, int M, int N,
                       int K, int group, int chunk, int splits,
                       cudaStream_t st) {
  using G = DecGeom<Fam>;
  const int steps = (K + G::KS - 1) / G::KS;
  if (!group_ok(K, group) || N % 8 != 0 || M < 1 || chunk < 1 ||
      chunk > G::kMaxChunk || splits != (steps + chunk - 1) / chunk ||
      splits > 65535 || (M + 15) / 16 > 65535 ||
      (splits > 1 && (part == nullptr || count == nullptr)) ||
      (MODE != kNone && s == nullptr))
    return cudaErrorInvalidValue;
  auto p = static_cast<float*>(part);
  auto c = static_cast<int*>(count);
  if (M <= 8)
    return launch_decode<Fam, AT, 1, MODE>(A, Wq, s, z, bias, out, out_f32,
                                           p, c, M, N, K, group, chunk,
                                           splits, st);
  return launch_decode<Fam, AT, 2, MODE>(A, Wq, s, z, bias, out, out_f32, p,
                                         c, M, N, K, group, chunk, splits,
                                         st);
}

// -- kernel 2: the decoded weight ----------------------------------------------

// Eight consecutive codes (flattened index 8 i .. 8 i + 7 of the [N, K]
// codes, one row: K % 8 == 0) of a B-bit weight at the low bits of x[]:
// 8 B bits from bit 8 i B of the packed words.
template <int B>
__device__ __forceinline__ void load8(const uint32_t* __restrict__ Wq,
                                      long long i, uint32_t (&x)[2]) {
  if constexpr (B == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(Wq) + i);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    constexpr int kPer = 32 / (8 * B);   // pieces of 8 codes a word
    const uint32_t w = __ldg(Wq + i / kPer);
    x[0] = w >> (8 * B * (int)(i % kPer));
    x[1] = 0u;
  }
}

// One 16-byte piece a thread and iteration: eight codes decoded and
// scaled, written with one 16-byte store, so that a warp's 32 stores are
// 512 contiguous bytes (and its reads 32 pieces of packed bits side by
// side) at every width.
template <class Fam, class AT, int MODE>
__global__ void __launch_bounds__(256)
    fmt_weight_decode_kernel(const uint32_t* __restrict__ Wq,
                             const typename AT::T* __restrict__ scales,
                             const typename AT::T* __restrict__ zeros,
                             typename AT::T* __restrict__ out, int N, int K,
                             int group) {
  constexpr int B = Fam::kBits;
  __shared__ uint16_t lut[16];
  if constexpr (Fam::kLut) {
    if (threadIdx.x < 16)
      lut[threadIdx.x] = AT::kBf16 ? kNf4Bf16[threadIdx.x]
                                   : kNf4F16[threadIdx.x];
    __syncthreads();
  }
  const long long pieces = (long long)N * K / 8;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < pieces; i += (long long)gridDim.x * blockDim.x) {
    uint32_t s = 0u, z = 0u;
    if constexpr (MODE != kNone) {
      const int n = (int)(8 * i / K), k = (int)(8 * i % K);
      const size_t sg = (size_t)(k / group) * N + n;
      s = splat16(__ldg(reinterpret_cast<const uint16_t*>(scales) + sg));
      if (zeros != nullptr)
        z = splat16(__ldg(reinterpret_cast<const uint16_t*>(zeros) + sg));
    }
    uint32_t x[2];
    load8<B>(Wq, i, x);
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = scale2<AT, MODE>(
          Fam::template convert<AT>(raw_pair<B>(x, 2 * j), lut), s, z);
    reinterpret_cast<uint4*>(out)[i] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

template <class Fam, class AT, int MODE>
cudaError_t run_weight_decode(const void* Wq, const void* s, const void* z,
                              void* out, int N, int K, int group,
                              cudaStream_t st) {
  if (N < 1 || K % 128 != 0 ||
      (MODE != kNone && (group < 8 || group % 8 != 0 || K % group != 0)))
    return cudaErrorInvalidValue;
  using T = typename AT::T;
  const long long pieces = (long long)N * K / 8;
  const long long want = (pieces + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  fmt_weight_decode_kernel<Fam, AT, MODE><<<blocks, 256, 0, st>>>(
      static_cast<const uint32_t*>(Wq), static_cast<const T*>(s),
      static_cast<const T*>(z), static_cast<T*>(out), N, K,
      MODE == kNone ? 1 : group);
  return cudaGetLastError();
}

// -- the tiled instance --------------------------------------------------------

template <class Fam, class AT, int MODE>
cudaError_t run_tiled(const void* A, const void* Wq, const void* s,
                      const void* z, const float* bias, void* out,
                      int out_f32, int M, int N, int K, int group,
                      cudaStream_t st) {
  if (!group_ok(K, group) || N % 8 != 0 || M < 1 ||
      (MODE != kNone && s == nullptr))
    return cudaErrorInvalidValue;
  return dqw::run_tiled_fmt<dqw::Fmt<Fam, AT, MODE>>(
      A, Wq, s, z, bias, out, out_f32, M, N, K, group, st);
}

}  // namespace fmt
}  // namespace bbt

// The C entry points of one source: `fam` 0 uint, 1 int, 2 nf4, 3
// fp4_e2m1, 4 e4m3, 5 e5m2; `bits`; `mode` 0 none, 1 (w - z) s (zeros
// null: scale only), 2 w s - z (uint only). CASES(X) expands to X(FAMCODE,
// BITS, FAMTYPE, MODE, AT) for each instance the source compiles.
#define BBT_FMT_ENTRIES(TAG, CASES)                                       \
  extern "C" int dqf_##TAG##_decode(                                          \
      int fam, int bits, int mode, const void* A, const void* Wq,             \
      const void* s, const void* z, const void* bias, void* out, int out_f32, \
      void* part, void* count, int M, int N, int K, int group, int chunk,     \
      int splits, void* stream) {                                             \
    auto st = static_cast<cudaStream_t>(stream);                              \
    auto b = static_cast<const float*>(bias);                                 \
    CASES(BBT_FMT_DECODE_ONE)                                                 \
    return (int)cudaErrorInvalidValue;                                        \
  }                                                                           \
  extern "C" int dqf_##TAG##_tiled(                                           \
      int fam, int bits, int mode, const void* A, const void* Wq,             \
      const void* s, const void* z, const void* bias, void* out, int out_f32, \
      int M, int N, int K, int group, void* stream) {                         \
    auto st = static_cast<cudaStream_t>(stream);                              \
    auto b = static_cast<const float*>(bias);                                 \
    CASES(BBT_FMT_TILED_ONE)                                                  \
    return (int)cudaErrorInvalidValue;                                        \
  }                                                                           \
  extern "C" int dqf_##TAG##_weight_decode(                                   \
      int fam, int bits, int mode, const void* Wq, const void* s,             \
      const void* z, void* out, int N, int K, int group, void* stream) {      \
    auto st = static_cast<cudaStream_t>(stream);                              \
    CASES(BBT_FMT_WD_ONE)                                                     \
    return (int)cudaErrorInvalidValue;                                        \
  }

#define BBT_FMT_DECODE_ONE(FC, BITS, FAM, MODE, AT)                           \
  if (fam == FC && bits == BITS && mode == MODE)                              \
    return (int)bbt::fmt::run_decode<FAM, AT, MODE>(                          \
        A, Wq, s, z, b, out, out_f32, part, count, M, N, K, group, chunk,     \
        splits, st);
#define BBT_FMT_TILED_ONE(FC, BITS, FAM, MODE, AT)                            \
  if (fam == FC && bits == BITS && mode == MODE)                              \
    return (int)bbt::fmt::run_tiled<FAM, AT, MODE>(                           \
        A, Wq, s, z, b, out, out_f32, M, N, K, group, st);
#define BBT_FMT_WD_ONE(FC, BITS, FAM, MODE, AT)                               \
  if (fam == FC && bits == BITS && mode == MODE)                              \
    return (int)bbt::fmt::run_weight_decode<FAM, AT, MODE>(Wq, s, z, out, N,  \
                                                           K, group, st);
