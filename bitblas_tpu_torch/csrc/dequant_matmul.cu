// dequant_matmul_u4: out[M, N] = A[M, K] @ dequant(Wq)^T for GPTQ W4A16.
//
// Replaces bitblas_tpu/kernels/dequant_matmul.py:make_dequant_matmul (its
// pallas_call at :629) for the uint4 / float16 / group-128 / original-zeros
// configuration.
//
// Operands (layout of quantization/packing.py, "Hopper device layout"):
//   A      [M, K]    float16, row-major
//   Wq     [N, K/8]  int32, eight uint4 codes per word along K, LSB first
//   scales [K/g, N]  float16      zeros [K/g, N] float16
//   out    [M, N]    float16      (f32 accumulation, one rounding at the end)
// The dequantized weight is (q - z) * s evaluated in f16 -- exactly the
// value the plain reference (ops/reference.py dequantize_weight, and the
// JAX oracle) produces -- so kernel and plain version differ only in the
// order of the f32 sums.
//
// What bounds it on the H100: at decode M (1..16) the weight bytes,
// N*K/2 plus 4*N*K/g for scales and zeros, over 3.35 TB/s; at prefill M
// (256, 512) the f16 tensor-core rate, 2*M*N*K over 989 TFLOP/s.
//
// Design: one kernel for every M, a tile over (M, N) chosen by the caller
// from the compiled instances at the end of this file, and a loop over K in
// group-sized steps (BK = 128 = g, so each step needs one scale and one
// zero per column). A STAGES-deep cp.async ring keeps several K slabs of A,
// packed weights, scales and zeros in flight -- at decode M the kernel does
// little arithmetic, so bytes in flight are what reach the bandwidth. Each
// step decodes its packed slab once into a shared f16 tile with the 0x6400
// magic (quantization/numerics.py fast_decode_uint_to_f16; BitBLAS LOP3):
// ((w >> 8p) & 0xF) | ((w >> 8p) & 0xF0) << 12 | 0x64006400 is the f16x2
// (1024 + q_k, 1024 + q_{k+1}); subtracting 1024 is exact. The warps then
// run mma.sync m16n8k16 (f16 in, f32 accumulate). Rows past M and columns
// past N are zero-filled on load and masked on store (N = 11008 is not a
// tile multiple). The f16 store is a plain round-to-nearest cast: for a
// float output the JAX epilogue's saturate_cast is exactly that cast.
// wgmma, TMA and a split-K small-M variant are left for later work.

#include "common.cuh"

namespace {

constexpr int BK = 128;       // == group size
constexpr int LDA = BK + 8;   // smem row stride in halves (bank spread)

template <int BM, int BN, int WM, int WN, int STAGES>
struct Tile {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kAHalves = BM * LDA;   // per stage
  static constexpr int kWWords = BN * BK / 8; // per stage
  static constexpr size_t kStageBytes =
      kAHalves * 2 + kWWords * 4 + 2 * BN * 2;
  static constexpr size_t kSmemBytes =
      STAGES * kStageBytes + (size_t)BN * LDA * 2;
};

template <int BM, int BN, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM * WN * 32)
    dequant_matmul_u4_kernel(const half* __restrict__ A,
                             const uint32_t* __restrict__ Wq,
                             const half* __restrict__ scales,
                             const half* __restrict__ zeros,
                             half* __restrict__ out, int M, int N, int K) {
  using T = Tile<BM, BN, WM, WN, STAGES>;
  constexpr int kThreads = T::kThreads;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(WTM % 16 == 0 && WTN % 8 == 0, "warp tile");

  extern __shared__ __align__(16) unsigned char smem[];
  half* As = reinterpret_cast<half*>(smem);
  uint32_t* Wr = reinterpret_cast<uint32_t*>(As + STAGES * T::kAHalves);
  half* Sr = reinterpret_cast<half*>(Wr + STAGES * T::kWWords);
  half* Zr = Sr + STAGES * BN;
  half* Ws = Zr + STAGES * BN;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KW = K / 8;
  const int nk = K / BK;

  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * BK;
    half* as = As + stage * T::kAHalves;
    for (int c = tid; c < BM * (BK / 8); c += kThreads) {
      const int r = c / (BK / 8), cc = c % (BK / 8);
      const int gm = m0 + r;
      const bool ok = gm < M;
      bbt::cp_async16(as + r * LDA + cc * 8,
                      ok ? A + (size_t)gm * K + k0 + cc * 8 : A, ok);
    }
    uint32_t* wr = Wr + stage * T::kWWords;
    for (int c = tid; c < BN * (BK / 32); c += kThreads) {
      const int r = c / (BK / 32), cc = c % (BK / 32);
      const int gn = n0 + r;
      const bool ok = gn < N;
      bbt::cp_async16(wr + r * (BK / 8) + cc * 4,
                      ok ? Wq + (size_t)gn * KW + k0 / 8 + cc * 4 : Wq, ok);
    }
    for (int c = tid; c < 2 * (BN / 8); c += kThreads) {
      const bool is_z = c >= BN / 8;
      const int cc = is_z ? c - BN / 8 : c;
      const int gn = n0 + cc * 8;   // N % 8 == 0: chunks never straddle N
      const bool ok = gn < N;
      const half* src = is_z ? zeros : scales;
      half* dst = (is_z ? Zr : Sr) + stage * BN + cc * 8;
      bbt::cp_async16(dst, ok ? src + (size_t)kt * N + gn : src, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    bbt::cp_async_commit();
  }

  const half2 k1024 = __float2half2_rn(1024.f);
  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt % STAGES;
    bbt::cp_async_wait<STAGES - 2>();
    __syncthreads();   // slab kt landed; every warp is done with kt - 1
    if (kt + STAGES - 1 < nk)
      load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    bbt::cp_async_commit();

    // Decode the packed slab into the shared f16 tile Ws [BN][BK].
    const uint32_t* wr = Wr + stage * T::kWWords;
    for (int c = tid; c < BN * (BK / 32); c += kThreads) {
      const int r = c / (BK / 32), cc = c % (BK / 32);
      const uint4 wv = *reinterpret_cast<const uint4*>(wr + r * (BK / 8) +
                                                       cc * 4);
      const half2 s2 = __half2half2(Sr[stage * BN + r]);
      const half2 z2 = __half2half2(Zr[stage * BN + r]);
      const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
      half* dst = Ws + r * LDA + cc * 32;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t o[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint32_t b = words[i] >> (8 * p);
          uint32_t bits = (b & 0xFu) | ((b & 0xF0u) << 12) | 0x64006400u;
          half2 q = *reinterpret_cast<half2*>(&bits);
          q = __hsub2(q, k1024);                 // exact: q in [0, 15]
          q = __hmul2(__hsub2(q, z2), s2);       // (q - z) * s in f16
          o[p] = *reinterpret_cast<uint32_t*>(&q);
        }
        *reinterpret_cast<uint4*>(dst + i * 8) = make_uint4(o[0], o[1],
                                                            o[2], o[3]);
      }
    }
    __syncthreads();

    const half* as = As + stage * T::kAHalves;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const half* p = as + (wm * WTM + i * 16 + g) * LDA + kk + 2 * t;
        af[i][0] = bbt::lds32(p);
        af[i][1] = bbt::lds32(p + 8 * LDA);
        af[i][2] = bbt::lds32(p + 8);
        af[i][3] = bbt::lds32(p + 8 * LDA + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const half* p = Ws + (wn * WTN + j * 8 + g) * LDA + kk + 2 * t;
        bf[j][0] = bbt::lds32(p);
        bf[j][1] = bbt::lds32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) bbt::mma_16816(acc[i][j], af[i], bf[j]);
    }
  }
  bbt::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = m0 + wm * WTM + i * 16 + g;
      const int col = n0 + wn * WTN + j * 8 + 2 * t;
      if (col >= N) continue;   // N even: col + 1 < N too
      if (row < M)
        *reinterpret_cast<half2*>(out + (size_t)row * N + col) =
            __floats2half2_rn(acc[i][j][0], acc[i][j][1]);
      if (row + 8 < M)
        *reinterpret_cast<half2*>(out + (size_t)(row + 8) * N + col) =
            __floats2half2_rn(acc[i][j][2], acc[i][j][3]);
    }
  }
}

template <int BM, int BN, int WM, int WN, int STAGES>
cudaError_t launch(const half* A, const uint32_t* Wq, const half* s,
                   const half* z, half* out, int M, int N, int K,
                   cudaStream_t stream) {
  using T = Tile<BM, BN, WM, WN, STAGES>;
  auto kernel = dequant_matmul_u4_kernel<BM, BN, WM, WN, STAGES>;
  static bool smem_set[bbt::kMaxDevices];
  cudaError_t err =
      bbt::set_max_smem_once(kernel, (int)T::kSmemBytes, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(A, Wq, s, z, out, M,
                                                       N, K);
  return cudaGetLastError();
}

}  // namespace

// The compiled tile instances, (BM, BN, BK = 128, STAGES) with their warp
// grid; kernels/dequant_matmul.py FUSED_TILES lists the same four and the
// tuner (tuner/space.py) picks one per M bucket. 16x32 keeps many narrow
// blocks with a deep ring in flight at decode M, where the weight bytes
// bound the kernel; the taller tiles re-read the packed weight fewer
// times as M grows. 128x128 with 3 stages takes 161.5 KB of the 227 KB.
extern "C" int dequant_matmul_u4(const void* A, const void* Wq,
                                 const void* scales, const void* zeros,
                                 void* out, int M, int N, int K, int group,
                                 int bm, int bn, int bk, int stages,
                                 void* stream) {
  if (group != BK || bk != BK || K % BK != 0 || N % 8 != 0 || M < 1)
    return (int)cudaErrorInvalidValue;
  auto a = static_cast<const half*>(A);
  auto w = static_cast<const uint32_t*>(Wq);
  auto s = static_cast<const half*>(scales);
  auto z = static_cast<const half*>(zeros);
  auto o = static_cast<half*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (bm == 16 && bn == 32 && stages == 6)
    return (int)launch<16, 32, 1, 4, 6>(a, w, s, z, o, M, N, K, st);
  if (bm == 32 && bn == 64 && stages == 4)
    return (int)launch<32, 64, 2, 2, 4>(a, w, s, z, o, M, N, K, st);
  if (bm == 64 && bn == 128 && stages == 3)
    return (int)launch<64, 128, 2, 2, 3>(a, w, s, z, o, M, N, K, st);
  if (bm == 128 && bn == 128 && stages == 3)
    return (int)launch<128, 128, 2, 4, 3>(a, w, s, z, o, M, N, K, st);
  return (int)cudaErrorInvalidValue;
}
