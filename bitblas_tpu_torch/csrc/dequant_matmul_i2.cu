// dequant_matmul_i2: out[M, N] = A[M, K] @ (Wq - 2)^T for BitNet W2A8.
//
// Replaces bitblas_tpu/kernels/dequant_matmul.py:make_dequant_matmul (its
// pallas_call at :629) for the int2 weight / int8 activation / int32
// accumulation / float32 output configuration (models/bitnet.py
// BitLinearInference).
//
// Operands (layout of quantization/packing.py, "Hopper device layout"):
//   A    [M, K]     int8, row-major (per-token quantized activations)
//   Wq   [N, K/16]  int32, sixteen int2 fields per word along K, LSB first,
//                   each stored biased (value + 2)
//   out  [M, N]     float32: the int32 sums converted once; exact, since
//                   |acc| <= K * 128 * 2 <= 2^24 for K <= 65536
// Integer arithmetic end to end, so the kernel equals the plain version
// (kernels/dequant_matmul.py dequant_matmul_i2_plain) bit for bit.
//
// What bounds it on the H100: at decode M (1..16) the weight bytes, N*K/4,
// over 3.35 TB/s; at prefill M the int8 tensor-core rate, 2*M*N*K over
// 1979 TOP/s.
//
// Two designs, chosen by the caller's tile:
//
// Decode M (the 16 x 32 x 256 instance, 4 stages; the default up to M =
// 16): one kernel, a tile over (M, N) and a loop over K in 256-deep steps;
// a 4-stage cp.async ring keeps K slabs of A and of the packed words in
// flight (at decode M the kernel does little arithmetic, so bytes in
// flight are what reach the bandwidth). Each step decodes its packed slab
// once into a shared int8 tile: byte p of a word holds k = 4p..4p+3, which
// bbt::decode_i2x4 spreads into four int8 values field - 2 with two masks,
// a subtract and an XOR. The warps then run mma.sync m16n8k32 (s8 in, s32
// accumulate). Rows past M, columns past N and K past the end are
// zero-filled on load (a zero-filled A slab makes the K tail contribute
// nothing whatever its decoded weights) and masked on store. A split-K
// decode path is left for later work.
//
// Prefill M (the tiled instances, every call with M > 16 on the default
// route): the mixed-input wgmma + TMA main loop of dequant_wgmma.cuh,
// shared with the uint4 x f16 kernel (design and bound written there),
// the int2 fields decoded in registers straight into wgmma's s8 A
// fragments.

#include "common.cuh"
#include "dequant_wgmma.cuh"

namespace {

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
struct Tile {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int kLds = BK + 16;          // smem row stride, bytes
  static constexpr int kABytes = BM * kLds;     // per stage
  static constexpr int kWWords = BN * BK / 16;  // per stage
  static constexpr size_t kStageBytes = kABytes + kWWords * 4;
  static constexpr size_t kSmemBytes =
      STAGES * kStageBytes + (size_t)BN * kLds;
};

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(WM * WN * 32)
    dequant_matmul_i2_kernel(const int8_t* __restrict__ A,
                             const uint32_t* __restrict__ Wq,
                             float* __restrict__ out, int M, int N, int K) {
  using T = Tile<BM, BN, BK, WM, WN, STAGES>;
  constexpr int kThreads = T::kThreads, LDS = T::kLds;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && BK % 64 == 0, "tile");

  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  uint32_t* Wr = reinterpret_cast<uint32_t*>(smem + STAGES * T::kABytes);
  int8_t* Ws = reinterpret_cast<int8_t*>(Wr + STAGES * T::kWWords);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KW = K / 16;
  const int nk = (K + BK - 1) / BK;

  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * BK;
    int8_t* as = As + stage * T::kABytes;
    for (int c = tid; c < BM * (BK / 16); c += kThreads) {
      const int r = c / (BK / 16), cc = c % (BK / 16);
      const int gm = m0 + r, gk = k0 + cc * 16;
      const bool ok = gm < M && gk < K;
      bbt::cp_async16(as + r * LDS + cc * 16,
                      ok ? A + (size_t)gm * K + gk : A, ok);
    }
    uint32_t* wr = Wr + stage * T::kWWords;
    for (int c = tid; c < BN * (BK / 64); c += kThreads) {
      const int r = c / (BK / 64), cc = c % (BK / 64);
      const int gn = n0 + r, gk = k0 + cc * 64;
      const bool ok = gn < N && gk < K;   // K % 64 == 0: no chunk straddles K
      bbt::cp_async16(wr + r * (BK / 16) + cc * 4,
                      ok ? Wq + (size_t)gn * KW + gk / 16 : Wq, ok);
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    bbt::cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt % STAGES;
    bbt::cp_async_wait<STAGES - 2>();
    __syncthreads();   // slab kt landed; every warp is done with kt - 1
    if (kt + STAGES - 1 < nk)
      load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    bbt::cp_async_commit();

    // Decode the packed slab into the shared int8 tile Ws [BN][BK].
    const uint32_t* wr = Wr + stage * T::kWWords;
    for (int c = tid; c < BN * (BK / 64); c += kThreads) {
      const int r = c / (BK / 64), cc = c % (BK / 64);
      const uint4 wv =
          *reinterpret_cast<const uint4*>(wr + r * (BK / 16) + cc * 4);
      const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
      int8_t* dst = Ws + r * LDS + cc * 64;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t o[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          o[p] = bbt::decode_i2x4(words[i] >> (8 * p));
        *reinterpret_cast<uint4*>(dst + i * 16) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();

    const int8_t* as = As + stage * T::kABytes;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = as + (wm * WTM + i * 16 + g) * LDS + kk + 4 * t;
        af[i][0] = bbt::lds32(p);
        af[i][1] = bbt::lds32(p + 8 * LDS);
        af[i][2] = bbt::lds32(p + 16);
        af[i][3] = bbt::lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = Ws + (wn * WTN + j * 8 + g) * LDS + kk + 4 * t;
        bf[j][0] = bbt::lds32(p);
        bf[j][1] = bbt::lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          bbt::mma_16832_s8(acc[i][j], af[i], bf[j]);
    }
  }
  bbt::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = m0 + wm * WTM + i * 16 + g;
      const int col = n0 + wn * WTN + j * 8 + 2 * t;
      if (col >= N) continue;   // N % 8 == 0: col + 1 < N too
      if (row < M)
        *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
            make_float2((float)acc[i][j][0], (float)acc[i][j][1]);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8) * N + col) =
            make_float2((float)acc[i][j][2], (float)acc[i][j][3]);
    }
  }
}

template <int BM, int BN, int BK, int WM, int WN, int STAGES>
cudaError_t launch(const int8_t* A, const uint32_t* Wq, float* out, int M,
                   int N, int K, cudaStream_t stream) {
  using T = Tile<BM, BN, BK, WM, WN, STAGES>;
  auto kernel = dequant_matmul_i2_kernel<BM, BN, BK, WM, WN, STAGES>;
  static bool smem_set[bbt::kMaxDevices];
  cudaError_t err =
      bbt::set_max_smem_once(kernel, (int)T::kSmemBytes, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, T::kThreads, T::kSmemBytes, stream>>>(A, Wq, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// The decode instance (16, 32, 256, 4) on mma.sync and the tiled
// instances (bbt::dqw::run_tiled lists them); kernels/dequant_matmul.py
// FUSED_TILES names the same and the tuner (tuner/space.py) picks one per
// M bucket.
extern "C" int dequant_matmul_i2(const void* A, const void* Wq, void* out,
                                 int M, int N, int K, int bm, int bn, int bk,
                                 int stages, void* stream) {
  if (K % 64 != 0 || K > 65536 || N % 8 != 0 || M < 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bm == 16 && bn == 32 && bk == 256 && stages == 4)
    return (int)launch<16, 32, 256, 1, 4, 4>(
        static_cast<const int8_t*>(A), static_cast<const uint32_t*>(Wq),
        static_cast<float*>(out), M, N, K, st);
  return (int)bbt::dqw::run_tiled<bbt::dqw::I2>(A, Wq, nullptr, nullptr, out,
                                               M, N, K, bm, bn, bk, stages,
                                               st);
}
