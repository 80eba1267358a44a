// Kernel 1 for int8 activations with uint1/2/4 and int1/2/4 weights
// (kernels/dequant_matmul.py dequant_matmul_int; the integer column of
// ops/matmul_config.INT_PAIRS but BitNet's int2 configuration, which keeps
// dequant_matmul_i2.cu). Each dequant_int_<f><b>.cu source instantiates
// one weight format (BBT_INT_ENTRIES below), so that nvcc builds them in
// parallel.
//
// Replaces bitblas_tpu/kernels/dequant_matmul.py:make_dequant_matmul (its
// pallas_call at :629) on its integer path (:277-290 the int32
// accumulator, :395-480 the raw int fields dotted against int8 A, grouped
// scales and zeros applied in an f32 epilogue).
//
// What it computes, on the Hopper layout of quantization/packing.py:
//   A      [M, K]        int8, row-major
//   Wq     [N, K*b/32]   int32, 32/b codes of b bits a word along K, LSB
//                        first (int: stored biased by 2^(b-1))
//   scales [K/g, N]      f16 or none     zeros [K/g, N] f16 (uint only)
//   bias   [N]           f32, or none
//   out    [M, N]        f32, f16, int32 (unscaled only) or int8
// v = the code (uint) or the code less 2^(b-1) (int). Unscaled, out = the
// exact int32 sums of a . v. Scaled, each group's exact int32 sum d and
// the group's sum of A, r, make one f32 term: d s, (d - r z) s (zeros
// original), or d s - r z (rescale), and the terms sum in f32. The f32
// bias is added, then the output cast: f16 round to nearest, int8
// rounded half to even and clamped (the exact sums clamped when unscaled
// with no bias), int32 the sums (truncated through f32 with a bias), as
// the plain version (JAX's oracle) casts.
//
// What bounds it on the H100: at decode M the weight bytes, N K b / 8 plus
// 2 N K / g a scale or zero tensor, over 3.35 TB/s (uint4 at N = 11008,
// K = 4096: 0.0067 ms); at prefill M the int8 tensor cores, 2 M N K over
// 1979 TOP/s (M = 256: 0.0117 ms).
//
// The decode instance (M <= 16; kernels/dequant_matmul.py int_decode_tile)
// is int2's (dequant_matmul_i2.cu) for every width: split-K across blocks
// from static sizes only (plan_splits_k_int), mma.sync m16n8k32 s8 x s8 ->
// s32 with the weight on its 16-row side (thread (g, t): rows 2 g and 2 g
// + 1 of its warp's 16, the mma's rows g and g + 8) and the tokens on its
// 8-wide side, A's split range copied once into shared memory, each
// thread's 16-byte weight chunks streamed through a private 4-stage
// cp.async ring, codes fed to the mma as they are (the int family's bias
// taken off through the sums of A: sum (f - b) a = sum f a - b sum a).
// What differs: a quad's four chunks are a 64-byte slice of each row, so a
// step is 512 / b of K, and every mma takes one 32-deep window of K, its
// eight codes of thread t at 32 x + 8 t ..: a group of 32 and every
// larger one then holds whole mmas, and each group's sums come apart. A
// thread's window codes sit in one chunk of its quad, read from the ring
// after __syncwarp (the chunks' places in the ring are swizzled by quad so
// that eight quads reading one word each hit distinct banks). The codes
// are spread to bytes by shifts and masks (b = 4: the even and the odd
// nibbles; 2: __byte_perm, then the even and odd fields; 1: a multiply by
// 0x00204081), and A's copy in shared memory follows their order (b = 2,
// 4: the even bytes of each 8 then the odd; 1: as it is). While A is
// copied, its sums by 32-deep window are taken (dp4a); a group's sums of A
// add those of its windows. Unscaled, the int32 sums of a split less b r
// go to an int32 partial; scaled, each run of a group within the split
// folds into an f32 partial (dqw::fold). The last block of each (N tile,
// M tile), by an atomic on the per-device counter it resets, sums the
// partials in split order and stores: one launch a call and the same bits
// on every call; the same arithmetic as the split plain version
// (dequant_matmul_int_split_plain), so equal to it bit for bit.
// K is a multiple of 128: a chunk (128 / b codes) is wholly in or out of
// K, zero-filled past it, and A is zero past K and past M.
//
// The tiled instance (M > 16): dequant_wgmma.cuh with the IntFmt functor.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "dequant_wgmma.cuh"

namespace bbt {
namespace dqi {

using dqw::kOutI32;
using dqw::kOutI8;
using dqw::kRescale;
using dqw::kScale;
using dqw::kUnscaled;
using dqw::kZeros;

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecBN = kDecWarps * 16;   // weight rows a block
constexpr int kDecStages = 4;
constexpr int kMaxSplitK = 2048;         // K of a split's A in shared memory

template <int B>
struct DecGeom {
  static constexpr int KS = 512 / B;       // K of a step (64 bytes a row)
  static constexpr int NW = KS / 32;       // mma windows a step
  static constexpr int kMaxChunk = kMaxSplitK / KS;
  // ring stage: [2 rows][threads] 16-byte chunks
  static constexpr int kStageBytes = kDecThreads * 2 * 16;
  // A: [16 rows][split K + 32] bytes; its sums: [16 rows][windows] int
  __host__ __device__ static constexpr int a_row_bytes(int chunk) {
    return chunk * KS + 32;
  }
  __host__ __device__ static constexpr int sum_bytes(int chunk) {
    return 16 * (chunk * KS / 32) * 4;
  }
  __host__ __device__ static constexpr int smem_bytes(int chunk) {
    return 16 * a_row_bytes(chunk) + sum_bytes(chunk) +
           kDecStages * kStageBytes;
  }
};

// A window's eight codes of one row (8 b bits at the low bits of x) -> two
// s8x4 registers, one code a byte: b = 4 and 2, codes 0, 2, 4, 6 then 1,
// 3, 5, 7; b = 1, codes 0-3 then 4-7.
template <int B>
__device__ __forceinline__ void spread8(uint32_t x, uint32_t& r0,
                                        uint32_t& r1) {
  if constexpr (B == 4) {
    r0 = x & 0x0F0F0F0Fu;
    r1 = (x >> 4) & 0x0F0F0F0Fu;
  } else if constexpr (B == 2) {
    // byte p: fields 2 p (bits 0-1) and 2 p + 1 (bits 2-3)
    const uint32_t y = __byte_perm(x, x >> 4, 0x5140) & 0x0F0F0F0Fu;
    r0 = y & 0x03030303u;
    r1 = (y >> 2) & 0x03030303u;
  } else {
    r0 = ((x & 0xFu) * 0x00204081u) & 0x01010101u;
    r1 = (((x >> 4) & 0xFu) * 0x00204081u) & 0x01010101u;
  }
}

// One block: (N tile of 128 rows, split, M tile of 16 rows); NB8 = 1 for
// at most 8 rows of A (one n8 product a window), 2 for up to 16.
template <int FAM, int B, int NB8, int MODE>
__global__ void __launch_bounds__(kDecThreads)
    int_decode_kernel(const int8_t* __restrict__ A,
                      const uint32_t* __restrict__ Wq,
                      const half* __restrict__ scales,
                      const half* __restrict__ zeros,
                      const float* __restrict__ bias, void* __restrict__ out,
                      int out_kind, void* __restrict__ part,
                      int* __restrict__ count, int M, int N, int K, int chunk,
                      int group) {
  using G = DecGeom<B>;
  constexpr int KS = G::KS, NW = G::NW;
  constexpr int ROWS = NB8 * 8;                    // rows of A a block holds
  constexpr int BIAS = FAM == 1 ? 1 << (B - 1) : 0;   // of the int codes
  constexpr bool kScaled = MODE != kUnscaled;
  constexpr bool kSumsA = BIAS != 0 || MODE >= kZeros;
  using V = typename std::conditional<kScaled, float, int>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y, splits = gridDim.y;
  const int steps = (K + KS - 1) / KS;
  const int ns = min(chunk, steps - split * chunk);   // >= 1: the plan's
  const int k0 = split * chunk * KS;
  const int kend = min(K, k0 + ns * KS);
  const int m0 = blockIdx.z * 16;
  const int mrows = min(16, M - m0);
  const int KW = K * B / 32;                // words of a weight row
  const int n_lo = blockIdx.x * kDecBN + warp * 16 + 2 * g;
  const bool n_ok = n_lo < N;               // N % 8 == 0: n_lo + 1 too
  const int a_row = G::a_row_bytes(chunk);
  const int wins = chunk * KS / 32;         // a row of A's window sums
  unsigned char* As = smem;
  int* sums = reinterpret_cast<int*>(smem + 16 * a_row);
  unsigned char* ring = smem + 16 * a_row + G::sum_bytes(chunk);
  // the ring chunk of thread q of this thread's quad
  auto ring_w = [&](int st, int r, int q) {
    return reinterpret_cast<uint4*>(ring + st * G::kStageBytes) +
           r * kDecThreads + warp * 32 + 4 * g + (q ^ ((g >> 1) & 3));
  };

  // step si: chunk t (16 bytes, 128 / b codes from K 64 / b t of the step)
  // of both rows, zero-filled past N or K
  auto load_step = [&](int si, int st) {
    const int kc = k0 + si * KS + t * (128 / B);
    const bool ok = n_ok && kc < K;
    const uint32_t* w = Wq + (size_t)n_lo * KW + kc * B / 32;
    bbt::cp_async16(ring_w(st, 0, t), ok ? w : Wq, ok);
    bbt::cp_async16(ring_w(st, 1, t), ok ? w + KW : Wq, ok);
  };
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < ns) load_step(s, s);
    bbt::cp_async_commit();
  }
  // A's rows m0 .. m0 + ROWS - 1 over the split's K range, 16 bytes at a
  // time (rows past M and K past the end zeros), each 8 bytes in the
  // codes' order; the sums of each 32-deep window, from the two lanes of
  // its two 16-byte pieces (ROWS * per_row is a multiple of 64: whole
  // warps run the loop)
  const int per_row = ns * KS / 16;
  for (int c = tid; c < ROWS * per_row; c += kDecThreads) {
    const int m = c / per_row, cc = c % per_row;
    const int k = k0 + cc * 16;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (m < mrows && k < K)
      x = __ldg(reinterpret_cast<const uint4*>(A + (size_t)(m0 + m) * K + k));
    if constexpr (kSumsA) {
      int s = __dp4a((int)x.x, 0x01010101, 0);
      s = __dp4a((int)x.y, 0x01010101, s);
      s = __dp4a((int)x.z, 0x01010101, s);
      s = __dp4a((int)x.w, 0x01010101, s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (!(cc & 1)) sums[m * wins + cc / 2] = s;
    }
    if constexpr (B != 1)
      x = make_uint4(__byte_perm(x.x, x.y, 0x6420),
                     __byte_perm(x.x, x.y, 0x7531),
                     __byte_perm(x.z, x.w, 0x6420),
                     __byte_perm(x.z, x.w, 0x7531));
    *reinterpret_cast<uint4*>(As + (size_t)m * a_row + cc * 16) = x;
  }
  __syncthreads();

  // the sums of A of tokens 8 h + 2 t (+ 1) over windows [wa, wb)
  auto sum_a = [&](int h, int e, int wa, int wb) {
    int r = 0;
    for (int w = wa; w < wb; ++w) r += sums[(8 * h + 2 * t + e) * wins + w];
    return r;
  };
  int acc[NB8][4];
  V val[NB8][4];   // scaled: the split's f32 terms; unscaled: its sums
#pragma unroll
  for (int h = 0; h < NB8; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = 0, val[h][e] = 0;
  // a run of a group within the split ends at window wb: fold its sums
  // (windows [wa, wb), group gi) into val
  auto promote = [&](int wa, int wb, int gi) {
    if constexpr (kScaled) {
      float s2[2] = {0.f, 0.f}, z2[2] = {0.f, 0.f};
      if (n_ok) {
        const half2 sv = __ldg(reinterpret_cast<const half2*>(
            scales + (size_t)gi * N + n_lo));
        s2[0] = __low2float(sv);
        s2[1] = __high2float(sv);
        if constexpr (MODE >= kZeros) {
          const half2 zv = __ldg(reinterpret_cast<const half2*>(
              zeros + (size_t)gi * N + n_lo));
          z2[0] = __low2float(zv);
          z2[1] = __high2float(zv);
        }
      }
#pragma unroll
      for (int h = 0; h < NB8; ++h) {
        int r[2] = {0, 0};
        if constexpr (kSumsA) {
          r[0] = sum_a(h, 0, wa, wb);
          r[1] = sum_a(h, 1, wa, wb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {   // e: token 2 t + (e & 1), row e / 2
          const int d = acc[h][e] - BIAS * r[e & 1];
          val[h][e] = __fadd_rn(val[h][e], dqw::fold<MODE>(d, r[e & 1],
                                                           s2[e >> 1],
                                                           z2[e >> 1]));
          acc[h][e] = 0;
        }
      }
    }
  };

  int wa = 0;   // the running group's first window of the split
  for (int si = 0; si < ns; ++si) {
    const int st = si % kDecStages;
    bbt::cp_async_wait<kDecStages - 2>();   // this thread's step si
    __syncwarp();                           // and its quad's
    // window x's codes of thread t: byte 4 x b + b t of the row's slice,
    // in chunk o / 16 of the quad
    uint32_t xl[NW], xh[NW];
#pragma unroll
    for (int x = 0; x < NW; ++x) {
      const int o = 4 * x * B + B * t;
      xl[x] = reinterpret_cast<const uint32_t*>(ring_w(st, 0, o / 16))
                  [(o % 16) / 4] >> (8 * (o % 4));
      xh[x] = reinterpret_cast<const uint32_t*>(ring_w(st, 1, o / 16))
                  [(o % 16) / 4] >> (8 * (o % 4));
    }
    if (si + kDecStages - 1 < ns)
      load_step(si + kDecStages - 1, (si + kDecStages - 1) % kDecStages);
    bbt::cp_async_commit();
    const int kstep = k0 + si * KS;
    const int nwv = min(NW, (K - kstep) / 32);   // windows inside K
#pragma unroll
    for (int x = 0; x < NW; ++x) {
      if (x >= nwv) break;
      uint32_t a[4];
      spread8<B>(xl[x], a[0], a[2]);
      spread8<B>(xh[x], a[1], a[3]);
#pragma unroll
      for (int h = 0; h < NB8; ++h) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            As + (size_t)(h * 8 + g) * a_row + si * KS + 32 * x + 8 * t);
        const uint32_t b[2] = {v.x, v.y};
        bbt::mma_16832_s8(acc[h], a, b);
      }
      if constexpr (kScaled) {
        const int kw = kstep + 32 * (x + 1);   // K after the window
        if (kw % group == 0 || kw == kend) {
          promote(wa, (kw - k0) / 32, (kw - 1) / group);
          wa = (kw - k0) / 32;
        }
      }
    }
  }
  bbt::cp_async_wait<0>();
  if constexpr (!kScaled) {
#pragma unroll
    for (int h = 0; h < NB8; ++h) {
      int r[2] = {0, 0};
      if constexpr (BIAS != 0) {
        r[0] = sum_a(h, 0, 0, (kend - k0) / 32);
        r[1] = sum_a(h, 1, 0, (kend - k0) / 32);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) val[h][e] = acc[h][e] - BIAS * r[e & 1];
    }
  }

  // the outputs of token m (of the tile) in rows n_lo, n_lo + 1
  auto store = [&](int m, V lo, V hi) {
    const size_t at = (size_t)(m0 + m) * N + n_lo;
    if constexpr (kScaled) {
      dqw::store_float(out, at, bias ? __fadd_rn(lo, bias[n_lo]) : lo,
                       out_kind);
      dqw::store_float(out, at + 1,
                       bias ? __fadd_rn(hi, bias[n_lo + 1]) : hi, out_kind);
    } else {
      dqw::store_int(out, at, lo, bias ? bias + n_lo : nullptr, out_kind);
      dqw::store_int(out, at + 1, hi, bias ? bias + n_lo + 1 : nullptr,
                     out_kind);
    }
  };
  // val[h]: (row lo, token 2t), (lo, 2t + 1), (hi, 2t), (hi, 2t + 1) of
  // tokens m0 + 8 h ...
  if (splits == 1) {
    if (!n_ok) return;
#pragma unroll
    for (int h = 0; h < NB8; ++h) {
      const int m = 8 * h + 2 * t;
      if (m < mrows) store(m, val[h][0], val[h][2]);
      if (m + 1 < mrows) store(m + 1, val[h][1], val[h][3]);
    }
    return;
  }
  // partial of split s: [s][M][N] (int32 unscaled, f32 scaled), rows < M
  V* P = static_cast<V*>(part);
  auto at = [&](int sp, int m) {
    return P + ((size_t)sp * M + m0 + m) * N + n_lo;
  };
  if (n_ok) {
#pragma unroll
    for (int h = 0; h < NB8; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * h + 2 * t + e;
        if (m >= mrows) continue;
        at(split, m)[0] = val[h][e];
        at(split, m)[1] = val[h][e + 2];
      }
    }
  }
  // The last block of this (N tile, M tile) sums the partials in split
  // order.
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
      V lo = 0, hi = 0;
      for (int sp = 0; sp < splits; ++sp) {
        lo = lo + __ldcg(at(sp, m));
        hi = hi + __ldcg(at(sp, m) + 1);
      }
      store(m, lo, hi);
    }
  }
}

template <int FAM, int B, int MODE>
cudaError_t run_decode(const void* A, const void* Wq, const void* s,
                       const void* z, const float* bias, void* out,
                       int out_kind, void* part, void* count, int M, int N,
                       int K, int group, int chunk, int splits,
                       cudaStream_t st) {
  using G = DecGeom<B>;
  const int steps = (K + G::KS - 1) / G::KS;
  if (K % 128 != 0 || N % 8 != 0 || M < 1 || chunk < 1 ||
      chunk > G::kMaxChunk || splits != (steps + chunk - 1) / chunk ||
      splits > 65535 || (M + 15) / 16 > 65535 ||
      (splits > 1 && (part == nullptr || count == nullptr)))
    return cudaErrorInvalidValue;
  const dim3 grid((N + kDecBN - 1) / kDecBN, splits, (M + 15) / 16);
  auto a = static_cast<const int8_t*>(A);
  auto w = static_cast<const uint32_t*>(Wq);
  auto sc = static_cast<const half*>(s);
  auto zr = static_cast<const half*>(z);
  auto c = static_cast<int*>(count);
  cudaError_t err;
  static bool smem_set[2][kMaxDevices];
  if (M <= 8) {
    auto kernel = int_decode_kernel<FAM, B, 1, MODE>;
    err = set_max_smem_once(kernel, G::smem_bytes(G::kMaxChunk), smem_set[0]);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kDecThreads, G::smem_bytes(chunk), st>>>(
        a, w, sc, zr, bias, out, out_kind, part, c, M, N, K, chunk, group);
  } else {
    auto kernel = int_decode_kernel<FAM, B, 2, MODE>;
    err = set_max_smem_once(kernel, G::smem_bytes(G::kMaxChunk), smem_set[1]);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kDecThreads, G::smem_bytes(chunk), st>>>(
        a, w, sc, zr, bias, out, out_kind, part, c, M, N, K, chunk, group);
  }
  return cudaGetLastError();
}

// The options every instance checks: a group the kernels take (the scaled
// modes; K itself unscaled), scales and zeros where the mode reads them,
// an int32 output only unscaled.
inline bool options_ok(int mode, const void* s, const void* z, int out_kind,
                       int M, int N, int K, int group) {
  return M >= 1 && N % 8 == 0 && dqw::group_ok(K, group) && out_kind >= 0 &&
         out_kind <= kOutI8 && (mode == kUnscaled || s != nullptr) &&
         (mode < kZeros || z != nullptr) &&
         (mode == kUnscaled || out_kind != kOutI32);
}

// The C entry points of one format (FAM 0 uint, 1 int; B bits): `mode`
// an IntMode (the int family takes kUnscaled and kScale), `out_kind` a
// dqw::OutKind.
template <int FAM, int B>
int decode_entry(int mode, const void* A, const void* Wq, const void* s,
                 const void* z, const void* bias, void* out, int out_kind,
                 void* part, void* count, int M, int N, int K, int group,
                 int chunk, int splits, void* stream) {
  if (!options_ok(mode, s, z, out_kind, M, N, K, group))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
#define BBT_DQI_DECODE(MODE)                                                 \
  if (mode == MODE)                                                          \
    return (int)run_decode<FAM, B, MODE>(A, Wq, s, z, b, out, out_kind, part, \
                                         count, M, N, K, group, chunk,       \
                                         splits, st);
  BBT_DQI_DECODE(kUnscaled)
  BBT_DQI_DECODE(kScale)
  if constexpr (FAM == 0) {
    BBT_DQI_DECODE(kZeros)
    BBT_DQI_DECODE(kRescale)
  }
#undef BBT_DQI_DECODE
  return (int)cudaErrorInvalidValue;
}

template <int FAM, int B>
int tiled_entry(int mode, const void* A, const void* Wq, const void* s,
                const void* z, const void* bias, void* out, int out_kind,
                int M, int N, int K, int group, void* stream) {
  if (!options_ok(mode, s, z, out_kind, M, N, K, group))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
#define BBT_DQI_TILED(MODE)                                                  \
  if (mode == MODE)                                                          \
    return (int)dqw::run_tiled_fmt<dqw::IntFmt<FAM, B, MODE>>(              \
        A, Wq, s, z, b, out, out_kind, M, N, K, group, st);
  BBT_DQI_TILED(kUnscaled)
  BBT_DQI_TILED(kScale)
  if constexpr (FAM == 0) {
    BBT_DQI_TILED(kZeros)
    BBT_DQI_TILED(kRescale)
  }
#undef BBT_DQI_TILED
  return (int)cudaErrorInvalidValue;
}

}  // namespace dqi
}  // namespace bbt

// dqi_<TAG>_decode (the split-K decode instance: grid (ceil(N / 128),
// splits, ceil(M / 16)), splits = ceil(ceil(K / (512 / b)) / chunk) from
// kernels/dequant_matmul.plan_splits_k_int; `part` holds splits * M * N
// int32 (unscaled) or f32 and `count` ceil(N / 128) * ceil(M / 16) zero
// ints when splits > 1, left at 0) and dqi_<TAG>_tiled (the 64 x 128
// wgmma + TMA instance).
#define BBT_INT_ENTRIES(TAG, FAM, B)                                         \
  extern "C" int dqi_##TAG##_decode(                                         \
      int mode, const void* A, const void* Wq, const void* s, const void* z, \
      const void* bias, void* out, int out_kind, void* part, void* count,    \
      int M, int N, int K, int group, int chunk, int splits, void* stream) { \
    return bbt::dqi::decode_entry<FAM, B>(mode, A, Wq, s, z, bias, out,     \
                                          out_kind, part, count, M, N, K,   \
                                          group, chunk, splits, stream);    \
  }                                                                          \
  extern "C" int dqi_##TAG##_tiled(                                          \
      int mode, const void* A, const void* Wq, const void* s, const void* z, \
      const void* bias, void* out, int out_kind, int M, int N, int K,        \
      int group, void* stream) {                                             \
    return bbt::dqi::tiled_entry<FAM, B>(mode, A, Wq, s, z, bias, out,      \
                                         out_kind, M, N, K, group, stream); \
  }
