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
// Two designs, chosen by the caller's tile from the instances at the end of
// this file.
//
// Decode M (the 16 x 128 instance; the default up to M = 16): split-K with
// the weight decoded in registers. At M = 4 the bytes are all weight
// (N*K/2 + 4*N*K/g), and what held the tiled kernel back was its per-K-step
// loop (two block barriers, a decode into a shared f16 tile, 12 of the
// mma's 16 rows padding) and too few blocks (344 at N = 11008) to keep
// enough bytes in flight. So:
//   - mma.sync m16n8k16 takes the weight on its 16-row side and the tokens
//     on its 8-wide side (out^T = W A^T): a warp owns 16 weight rows, a
//     block 8 warps (128 rows); M <= 8 runs one n8 product a k16 step,
//     M <= 16 two. Larger M runs more M tiles of 16 on the grid.
//   - K is split across blocks in whole 128-groups (chunk groups a split,
//     kernels/dequant_matmul.plan_splits_k: static sizes only, several
//     blocks in flight on every SM). A block copies its K range of A once
//     into shared memory (one barrier), then each thread streams its own
//     16-byte chunks of packed weights (32 codes of each of its two rows
//     a group) and its rows' scale and zero pairs through a private
//     4-stage cp.async ring: it reads back only what it copied, so no
//     barrier sits in the K loop.
//   - The decode stays in registers and costs two integer ops and one
//     f16 subtraction a pair of codes: (w >> 4j) & 0x000F000F |
//     0x64006400 is the f16x2 (1024 + q_j, 1024 + q_{j+4}) of a word's
//     codes j and j + 4 (the 0x6400 magic of quantization/numerics.py
//     fast_decode_uint_to_f16, BitBLAS LOP3), less 1024 exactly the
//     codes, which the mma takes: q a is exact in f32. Scale and zero
//     apply once a group in f32, as the JAX kernel applies them to its
//     accumulator: s (sum q a - z sum a), with sum a of each group and
//     row of A computed once a block. (Feeding the mma 1024 + q instead
//     saves the subtraction but sums values 1024 times larger, which
//     costs the f32 group sums 10 bits.) Any order of k inside a product is fine as long as A
//     follows it: A's halves are paired to match once, in shared memory.
//     Rounding (q - z) s to f16 per pair, as the plain version does,
//     would cost three more f16 ops a pair for no accuracy the f32
//     correction lacks.
//   - Each split writes its f32 partial (rows < M only); the last block of
//     each (N tile, M tile) to finish -- an atomic on a per-device counter
//     it resets to 0 -- sums the partials in split order 0, 1, ... and
//     writes f16: one launch a call and the same bits on every call.
//
// Prefill M (the tiled instances, every call with M > 16 on the default
// route): the mixed-input wgmma + TMA main loop of dequant_wgmma.cuh,
// shared with the int2 x int8 kernel (design and bound written there):
// one producer warp with TMA, the weight decoded in registers straight
// into wgmma's A fragments as (q - z) * s in f16 (the plain version's
// weight, bit for bit), the tokens on wgmma's n side.
//
// The f16 store is a plain round-to-nearest cast: for a float output the
// JAX epilogue's saturate_cast is exactly that cast.

#include "common.cuh"
#include "dequant_wgmma.cuh"

namespace {

constexpr int BK = 128;       // == group size
// -- decode M: split-K, register decode ------------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecBN = kDecWarps * 16;      // weight rows a block
constexpr int kDecStages = 4;               // groups in flight a thread
constexpr int kDecMaxChunk = 8;             // groups a split (A in smem)
// shared memory: A [chunk][4][16 rows][4] 16-byte chunks (its halves
// paired as the mma's B fragments take them), the sums of A [chunk][16],
// then the ring: [stage][2 rows][thread] weight chunks and
// [stage][2][thread] scale / zero pairs
constexpr int kDecABytes = 16 * BK * 2;
constexpr int kDecSumBytes = kDecMaxChunk * 16 * 4;
constexpr int kDecStageBytes = kDecThreads * (2 * 16 + 2 * 4);
constexpr int kDecSmemMax = kDecMaxChunk * kDecABytes + kDecSumBytes +
                            kDecStages * kDecStageBytes;

// One block: (N tile of 128 rows, split, M tile of 16 rows); NB8 = 1 for
// at most 8 rows of A (one n8 product a k16 step), 2 for up to 16.
// f16x2 (1024 + q0, 1024 + q1) -> (q0, q1), exact.
__device__ __forceinline__ uint32_t codes(uint32_t magic) {
  half2 q = __hsub2(*reinterpret_cast<const half2*>(&magic),
                    __float2half2_rn(1024.f));
  return *reinterpret_cast<uint32_t*>(&q);
}

template <int NB8>
__global__ void __launch_bounds__(kDecThreads)
    dequant_decode_kernel(const half* __restrict__ A,
                          const uint32_t* __restrict__ Wq,
                          const half* __restrict__ scales,
                          const half* __restrict__ zeros,
                          half* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ count, int M, int N, int K,
                          int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y, splits = gridDim.y;
  const int groups = K / BK;
  const int kg0 = split * chunk;
  const int ng = min(chunk, groups - kg0);   // >= 1: the planner's splits
  const int m0 = blockIdx.z * 16;
  const int mrows = min(16, M - m0);
  const int KW = K / 8;
  constexpr int ROWS = NB8 * 8;              // rows of A a block holds
  // this thread's two weight rows (adjacent, so one 4-byte scale pair)
  const int n_lo = blockIdx.x * kDecBN + warp * 16 + 2 * g;
  const bool n_ok = n_lo < N;                // N % 8 == 0: n_lo + 1 too

  uint4* As = reinterpret_cast<uint4*>(smem);
  float* sums = reinterpret_cast<float*>(smem + chunk * kDecABytes);
  unsigned char* ring = smem + chunk * kDecABytes + kDecSumBytes;
  auto ring_w = [&](int st, int r) {
    return reinterpret_cast<uint4*>(ring + st * kDecStageBytes) +
           r * kDecThreads + tid;
  };
  auto ring_sz = [&](int st, int r) {
    return reinterpret_cast<uint32_t*>(ring + st * kDecStageBytes +
                                       2 * 16 * kDecThreads) +
           r * kDecThreads + tid;
  };

  auto load_group = [&](int gi, int st) {
    const int kg = kg0 + gi;
    const uint32_t* w = Wq + (size_t)n_lo * KW + (size_t)kg * (BK / 8) + 4 * t;
    bbt::cp_async16(ring_w(st, 0), n_ok ? w : Wq, n_ok);
    bbt::cp_async16(ring_w(st, 1), n_ok ? w + KW : Wq, n_ok);
    const size_t at = (size_t)kg * N + n_lo;
    bbt::cp_async4(ring_sz(st, 0), n_ok ? scales + at : scales, n_ok);
    bbt::cp_async4(ring_sz(st, 1), n_ok ? zeros + at : zeros, n_ok);
  };
  // The weights' first groups go out first: they come from device memory.
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < ng) load_group(s, s);
    bbt::cp_async_commit();
  }
  // Meanwhile A (an L2 hit after the first blocks): rows m0 .. m0 + ROWS -
  // 1 over the split's K range into shared memory as [group][i][m][t]
  // 16-byte chunks (chunk i of thread t holds k = 32 t + 8 i .. + 7 of the
  // group, so a warp reads 512 contiguous bytes), each chunk's halves
  // paired (x0 x1, x2 x3, x4 x5, x6 x7) -> (x0 x4, x1 x5, x2 x6, x3 x7),
  // the order in which the decode below yields a word's codes. The 16
  // chunks of one row and group sit in 16 neighbouring lanes, which sum
  // them for the zero correction. Rows past M are zeros, never read.
  const int per_row = ng * (BK / 8);   // a multiple of 16: whole warps
  for (int c = tid; c < ROWS * per_row; c += kDecThreads) {
    const int m = c / per_row, cc = c % per_row;
    const int kgl = cc / 16, w = cc % 16;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (m < mrows)
      x = __ldg(reinterpret_cast<const uint4*>(
          A + (size_t)(m0 + m) * K + (size_t)kg0 * BK + cc * 8));
    const uint32_t u[4] = {x.x, x.y, x.z, x.w};
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __half22float2(*reinterpret_cast<const half2*>(&u[e]));
      sum += f.x + f.y;
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (w == 0) sums[kgl * 16 + m] = sum;
    As[((kgl * 4 + w % 4) * 16 + m) * 4 + w / 4] =
        make_uint4(__byte_perm(x.x, x.z, 0x5410),
                   __byte_perm(x.x, x.z, 0x7632),
                   __byte_perm(x.y, x.w, 0x5410),
                   __byte_perm(x.y, x.w, 0x7632));
  }
  __syncthreads();

  float acc[NB8][4];
#pragma unroll
  for (int h = 0; h < NB8; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;

  for (int gi = 0; gi < ng; ++gi) {
    const int st = gi % kDecStages;
    bbt::cp_async_wait<kDecStages - 2>();   // this thread's group gi
    const uint4 wl = *ring_w(st, 0), wh = *ring_w(st, 1);
    const uint32_t sraw = *ring_sz(st, 0), zraw = *ring_sz(st, 1);
    if (gi + kDecStages - 1 < ng)
      load_group(gi + kDecStages - 1, (gi + kDecStages - 1) % kDecStages);
    bbt::cp_async_commit();
    const uint32_t wlo[4] = {wl.x, wl.y, wl.z, wl.w};
    const uint32_t whi[4] = {wh.x, wh.y, wh.z, wh.w};
    const uint4* ag = As + (size_t)gi * 4 * 16 * 4;
    // the group's raw sums over q a in f32 (products exact), one
    // accumulator per word so that the four mma chains run side by side
    float gacc[4][NB8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < NB8; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) gacc[i][h][e] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // (w >> 4j) & 0x000F000F | 0x64006400 = f16x2 (1024 + q_j,
      // 1024 + q_{j+4}) for codes j, j + 4 of word i, rows lo and hi;
      // less 1024: (q_j, q_{j+4}), exact
      uint32_t dlo[4], dhi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dlo[j] = codes(((wlo[i] >> (4 * j)) & 0x000F000Fu) | 0x64006400u);
        dhi[j] = codes(((whi[i] >> (4 * j)) & 0x000F000Fu) | 0x64006400u);
      }
      // two k16 products: pairs (0, 1) then (2, 3); logical k (2t, 2t+1)
      // is codes (j, j + 4) of pair j, logical (2t + 8, 2t + 9) those of
      // the next pair, and A's paired halves follow the same order
      const uint32_t a0[4] = {dlo[0], dhi[0], dlo[1], dhi[1]};
      const uint32_t a1[4] = {dlo[2], dhi[2], dlo[3], dhi[3]};
#pragma unroll
      for (int h = 0; h < NB8; ++h) {
        const uint4 x = ag[(i * 16 + h * 8 + g) * 4 + t];
        const uint32_t b0[2] = {x.x, x.y}, b1[2] = {x.z, x.w};
        bbt::mma_16816(gacc[i][h], a0, b0);
        bbt::mma_16816(gacc[i][h], a1, b1);
      }
    }
    // acc += s * (sum q a - z sum a): the dequantized product (q - z) s a,
    // with the scale and zero applied once a group in f32 (the JAX
    // kernel's s * (a @ q - z * sum(a)))
    const float2 sf = __half22float2(*reinterpret_cast<const half2*>(&sraw));
    const float2 zf = __half22float2(*reinterpret_cast<const half2*>(&zraw));
    const float zz_lo = zf.x, zz_hi = zf.y;
    const float* sm = sums + gi * 16;
#pragma unroll
    for (int h = 0; h < NB8; ++h) {
      const float a0s = sm[8 * h + 2 * t], a1s = sm[8 * h + 2 * t + 1];
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        r[e] = (gacc[0][h][e] + gacc[1][h][e]) +
               (gacc[2][h][e] + gacc[3][h][e]);
      acc[h][0] = fmaf(sf.x, fmaf(-zz_lo, a0s, r[0]), acc[h][0]);
      acc[h][1] = fmaf(sf.x, fmaf(-zz_lo, a1s, r[1]), acc[h][1]);
      acc[h][2] = fmaf(sf.y, fmaf(-zz_hi, a0s, r[2]), acc[h][2]);
      acc[h][3] = fmaf(sf.y, fmaf(-zz_hi, a1s, r[3]), acc[h][3]);
    }
  }
  bbt::cp_async_wait<0>();

  // acc[h]: (row lo, token 2t), (lo, 2t + 1), (hi, 2t), (hi, 2t + 1) of
  // tokens m0 + 8 h ...
  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < NB8; ++h) {
      const int m = 8 * h + 2 * t;
      if (!n_ok) continue;
      if (m < mrows)
        *reinterpret_cast<half2*>(out + (size_t)(m0 + m) * N + n_lo) =
            __floats2half2_rn(acc[h][0], acc[h][2]);
      if (m + 1 < mrows)
        *reinterpret_cast<half2*>(out + (size_t)(m0 + m + 1) * N + n_lo) =
            __floats2half2_rn(acc[h][1], acc[h][3]);
    }
    return;
  }
  // partial of split s: [s][M][N] f32, rows < M only
  auto at = [&](int sp, int m) {
    return part + ((size_t)sp * M + m0 + m) * N + n_lo;
  };
#pragma unroll
  for (int h = 0; h < NB8; ++h) {
    const int m = 8 * h + 2 * t;
    if (!n_ok) continue;
    if (m < mrows)
      *reinterpret_cast<float2*>(at(split, m)) =
          make_float2(acc[h][0], acc[h][2]);
    if (m + 1 < mrows)
      *reinterpret_cast<float2*>(at(split, m + 1)) =
          make_float2(acc[h][1], acc[h][3]);
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
      float2 o = make_float2(0.f, 0.f);
      for (int sp = 0; sp < splits; ++sp) {
        const float2 p = __ldcg(reinterpret_cast<const float2*>(at(sp, m)));
        o.x += p.x;
        o.y += p.y;
      }
      *reinterpret_cast<half2*>(out + (size_t)(m0 + m) * N + n_lo) =
          __floats2half2_rn(o.x, o.y);
    }
  }
}

}  // namespace

// The tiled instances (bbt::dqw::run_tiled lists them): kernels/
// dequant_matmul.py FUSED_TILES names them after the decode instance, and
// the tuner (tuner/space.py) picks one per M bucket.
extern "C" int dequant_matmul_u4(const void* A, const void* Wq,
                                 const void* scales, const void* zeros,
                                 void* out, int M, int N, int K, int group,
                                 int bm, int bn, int bk, int stages,
                                 void* stream) {
  if (group != BK || K % BK != 0 || N % 8 != 0 || M < 1)
    return (int)cudaErrorInvalidValue;
  return (int)bbt::dqw::run_tiled<bbt::dqw::U4>(
      A, Wq, scales, zeros, out, M, N, K, bm, bn, bk, stages,
      static_cast<cudaStream_t>(stream));
}

// The decode instance (16 x 128, 4 stages): grid (ceil(N / 128), splits,
// ceil(M / 16)); splits = ceil(K / 128 / chunk) with chunk <= 8 groups
// from kernels/dequant_matmul.plan_splits_k. `part` holds splits * M * N
// floats and `count` ceil(N / 128) * ceil(M / 16) zero ints when splits >
// 1 (the kernel leaves them at 0).
extern "C" int dequant_matmul_u4_decode(const void* A, const void* Wq,
                                        const void* scales,
                                        const void* zeros, void* out,
                                        void* part, void* count, int M,
                                        int N, int K, int group, int chunk,
                                        int splits, void* stream) {
  const int groups = K / BK;
  if (group != BK || K % BK != 0 || N % 8 != 0 || M < 1 || chunk < 1 ||
      chunk > kDecMaxChunk || splits != (groups + chunk - 1) / chunk ||
      splits > 65535 || (M + 15) / 16 > 65535 ||
      (splits > 1 && (part == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kDecBN - 1) / kDecBN, splits, (M + 15) / 16);
  const int bytes =
      chunk * kDecABytes + kDecSumBytes + kDecStages * kDecStageBytes;
  auto st = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const half*>(A);
  auto w = static_cast<const uint32_t*>(Wq);
  auto s = static_cast<const half*>(scales);
  auto z = static_cast<const half*>(zeros);
  auto o = static_cast<half*>(out);
  auto p = static_cast<float*>(part);
  auto c = static_cast<int*>(count);
  cudaError_t err;
  if (M <= 8) {
    static bool smem_set[bbt::kMaxDevices];
    err = bbt::set_max_smem_once(dequant_decode_kernel<1>, kDecSmemMax,
                                 smem_set);
    if (err != cudaSuccess) return (int)err;
    dequant_decode_kernel<1><<<grid, kDecThreads, bytes, st>>>(
        a, w, s, z, o, p, c, M, N, K, chunk);
  } else {
    static bool smem_set[bbt::kMaxDevices];
    err = bbt::set_max_smem_once(dequant_decode_kernel<2>, kDecSmemMax,
                                 smem_set);
    if (err != cudaSuccess) return (int)err;
    dequant_decode_kernel<2><<<grid, kDecThreads, bytes, st>>>(
        a, w, s, z, o, p, c, M, N, K, chunk);
  }
  return (int)cudaGetLastError();
}
