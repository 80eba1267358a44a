// dequant_matmul_u4: out[M, N] = A[M, K] @ dequant(Wq)^T (+ bias) for GPTQ
// W4A16.
//
// Replaces bitblas_tpu/kernels/dequant_matmul.py:make_dequant_matmul (its
// pallas_call at :629) for the uint4 / float16 configurations: group sizes
// 32, 64, 128, every multiple of 256 and per channel (g = K); zeros modes
// original, (q - z) s, and rescale, q s - z (the quantized mode's packed
// zeros are unpacked to f16 zeros when the weight is transformed and run
// as original); an optional f32 bias added before the one f16 rounding.
//
// Operands (layout of quantization/packing.py, "Hopper device layout"):
//   A      [M, K]    float16, row-major
//   Wq     [N, K/8]  int32, eight uint4 codes per word along K, LSB first
//   scales [K/g, N]  float16      zeros [K/g, N] float16
//   bias   [N]       float32, or none
//   out    [M, N]    float16      (f32 accumulation, one rounding at the end)
// The dequantized weight is (q - z) * s (rescale: q * s - z) evaluated in
// f16 -- exactly the value the plain reference (ops/reference.py
// dequantize_weight, and the JAX oracle) produces -- so kernel and plain
// version differ only in the order of the f32 sums.
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
//   - K is walked in steps of 128 and split across blocks in whole steps
//     (chunk steps a split, kernels/dequant_matmul.plan_splits_k: static
//     sizes only, several blocks in flight on every SM). A block copies its
//     K range of A once into shared memory (one barrier), then each thread
//     streams its own 16-byte chunks of packed weights (32 codes of each of
//     its two rows a step) and its rows' scale and zero pairs through a
//     private 4-stage cp.async ring: it reads back only what it copied, so
//     no barrier sits in the K loop.
//   - The decode stays in registers and costs two integer ops and one
//     f16 subtraction a pair of codes: (w >> 4j) & 0x000F000F |
//     0x64006400 is the f16x2 (1024 + q_j, 1024 + q_{j+4}) of a word's
//     codes j and j + 4 (the 0x6400 magic of quantization/numerics.py
//     fast_decode_uint_to_f16, BitBLAS LOP3), less 1024 exactly the
//     codes, which the mma takes: q a is exact in f32. Scale and zero
//     apply to a group's sums in f32, as the JAX kernel applies them to its
//     accumulator: s (sum q a - z sum a) (rescale: s sum q a - z sum a),
//     with sum a of each group and row of A computed once a block. (Feeding
//     the mma 1024 + q instead saves the subtraction but sums values 1024
//     times larger, which costs the f32 group sums 10 bits.) Any order of k
//     inside a product is fine as long as A follows it: A's halves are
//     paired to match once, in shared memory. Rounding (q - z) s to f16 per
//     pair, as the plain version does, would cost three more f16 ops a pair
//     for no accuracy the f32 correction lacks.
//   - Groups. A product's k16 spans the four threads of a quad, so its sums
//     are one group's only if the quad's codes are. From g = 128 (128, any
//     multiple of 256, per channel) a step lies in one group: thread t
//     takes words 4t .. 4t + 3 of the step (one 16-byte copy a row), and
//     the step's one scale / zero pair is the row's group's, read again by
//     every step of a larger group (an L1 hit). At g = 32 and 64 (NARROW)
//     the quad shares its copies: thread t still copies words 4t .. 4t + 3
//     of each row (quarter t, k 32 t .. 32 t + 31) and quarter t's scale /
//     zero pair, and after a __syncwarp reads word t of each quad-mate's
//     chunk from shared memory, so that its word i is word 4 i + t of the
//     step and word i of every thread of the quad lies in quarter i: the
//     four products of word i sum one quarter, and each quarter takes its
//     own pair (read from quad-mate i) and its own sums of A. The
//     quarters' corrections add in order 0 .. 3. (Four 4-byte copies a
//     row instead, each thread fetching its own words, ran 50% over g =
//     128 at M = 4: PERF.md.) A quad's four chunks sit at slots rotated
//     by g / 2, so the eight quads' reads of one word hit 32 banks.
//   - Each split writes its f32 partial (rows < M only); the last block of
//     each (N tile, M tile) to finish -- an atomic on a per-device counter
//     it resets to 0 -- sums the partials in split order 0, 1, ..., adds
//     the bias and writes f16: one launch a call and the same bits on every
//     call.
//
// Prefill M (the tiled instances, every call with M > 16 on the default
// route): the mixed-input wgmma + TMA main loop of dequant_wgmma.cuh,
// shared with the int2 x int8 kernel (design and bound written there):
// one producer warp with TMA, the weight decoded in registers straight
// into wgmma's A fragments as (q - z) * s (rescale: q * s - z) in f16 (the
// plain version's weight, bit for bit), the tokens on wgmma's n side.
//
// The f16 store is a plain round-to-nearest cast: for a float output the
// JAX epilogue's saturate_cast is exactly that cast.

#include "common.cuh"
#include "dequant_wgmma.cuh"

namespace {

constexpr int BK = 128;       // K of one step
// -- decode M: split-K, register decode ------------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecBN = kDecWarps * 16;      // weight rows a block
constexpr int kDecStages = 4;               // steps in flight a thread
constexpr int kDecMaxChunk = 8;             // steps a split (A in smem)
// shared memory: A [chunk][4][16 rows][4] 16-byte chunks (its halves
// paired as the mma's B fragments take them), the sums of A [chunk][P][16]
// (P = 4 quarters when NARROW, else 1), then the ring: [stage][2 rows]
// [thread] weight chunks and [stage][2][thread] scale / zero pairs
constexpr int kDecABytes = 16 * BK * 2;
constexpr int kDecStageBytes = kDecThreads * (2 * 16 + 2 * 4);
__host__ __device__ constexpr int dec_pairs(bool narrow) {
  return narrow ? 4 : 1;
}
__host__ __device__ constexpr int dec_sum_bytes(bool narrow) {
  return kDecMaxChunk * dec_pairs(narrow) * 16 * 4;
}
__host__ __device__ constexpr int dec_smem_max(bool narrow) {
  return kDecMaxChunk * kDecABytes + dec_sum_bytes(narrow) +
         kDecStages * kDecStageBytes;
}

// A raw pair of uint4 codes (q0, q1 in the low bits of each half) ->
// f16x2 (q0, q1): the 0x6400 magic of decode_formats.cuh, exact.
__device__ __forceinline__ uint32_t codes(uint32_t raw) {
  return bbt::fmt::UInt<4>::convert<bbt::fmt::F16>(raw, nullptr);
}

// One block: (N tile of 128 rows, split, M tile of 16 rows); NB8 = 1 for
// at most 8 rows of A (one n8 product a k16 step), 2 for up to 16. NARROW:
// g = 32 or 64 (quarter pairs, `gsh` = log2(g / 32)); else a step's pair is
// row kg / `gsteps` (gsteps = g / 128; per channel: K / 128).
template <int NB8, bool NARROW, bool RESCALE>
__global__ void __launch_bounds__(kDecThreads)
    dequant_decode_kernel(const half* __restrict__ A,
                          const uint32_t* __restrict__ Wq,
                          const half* __restrict__ scales,
                          const half* __restrict__ zeros,
                          const float* __restrict__ bias,
                          half* __restrict__ out, float* __restrict__ part,
                          int* __restrict__ count, int M, int N, int K,
                          int chunk, int gsteps, int gsh) {
  constexpr int P = dec_pairs(NARROW);
  constexpr int kStageBytes = kDecStageBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y, splits = gridDim.y;
  const int steps = K / BK;
  const int kg0 = split * chunk;
  const int ng = min(chunk, steps - kg0);    // >= 1: the planner's splits
  const int m0 = blockIdx.z * 16;
  const int mrows = min(16, M - m0);
  const int KW = K / 8;
  constexpr int ROWS = NB8 * 8;              // rows of A a block holds
  // this thread's two weight rows (adjacent, so one 4-byte scale pair)
  const int n_lo = blockIdx.x * kDecBN + warp * 16 + 2 * g;
  const bool n_ok = n_lo < N;                // N % 8 == 0: n_lo + 1 too

  uint4* As = reinterpret_cast<uint4*>(smem);
  float* sums = reinterpret_cast<float*>(smem + chunk * kDecABytes);
  unsigned char* ring = smem + chunk * kDecABytes + dec_sum_bytes(NARROW);
  // the ring slot of lane (g, c)'s weight chunk (NARROW: rotated by g / 2
  // within its quad, so that reads of one word across the quads hit
  // distinct banks)
  auto slot = [&](int c) {
    return NARROW ? warp * 32 + 4 * g + ((c + (g >> 1)) & 3) : tid;
  };
  auto ring_w = [&](int st, int r, int sl) {
    return reinterpret_cast<uint4*>(ring + st * kStageBytes) +
           r * kDecThreads + sl;
  };
  // r = 0: scales, 1: zeros; lane `ln` of the block's
  auto ring_sz = [&](int st, int r, int ln) {
    return reinterpret_cast<uint32_t*>(ring + st * kStageBytes +
                                       2 * 16 * kDecThreads) +
           r * kDecThreads + ln;
  };

  auto load_step = [&](int gi, int st) {
    const int kg = kg0 + gi;
    const uint32_t* w = Wq + (size_t)n_lo * KW + (size_t)kg * (BK / 8);
    bbt::cp_async16(ring_w(st, 0, slot(t)), n_ok ? w + 4 * t : Wq, n_ok);
    bbt::cp_async16(ring_w(st, 1, slot(t)), n_ok ? w + KW + 4 * t : Wq,
                    n_ok);
    // NARROW: quarter t's group; else the step's
    const int row = NARROW ? (4 * kg + t) >> gsh
                           : (gsteps == 1 ? kg : kg / gsteps);
    const size_t at = (size_t)row * N + n_lo;
    bbt::cp_async4(ring_sz(st, 0, tid), n_ok ? scales + at : scales, n_ok);
    bbt::cp_async4(ring_sz(st, 1, tid), n_ok ? zeros + at : zeros, n_ok);
  };
  // The weights' first steps go out first: they come from device memory.
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < ng) load_step(s, s);
    bbt::cp_async_commit();
  }
  // Meanwhile A (an L2 hit after the first blocks): rows m0 .. m0 + ROWS -
  // 1 over the split's K range into shared memory as [step][i][m][t]
  // 16-byte chunks, chunk i of thread t holding the k that word i of that
  // thread's weight chunk holds (k = 32 t + 8 i .. + 7 of the step, NARROW:
  // k = 32 i + 8 t ..; a warp reads 512 contiguous bytes), each chunk's
  // halves paired (x0 x1, x2 x3, x4 x5, x6 x7) -> (x0 x4, x1 x5, x2 x6, x3
  // x7), the order in which the decode below yields a word's codes. The 16
  // chunks of one row and step sit in 16 neighbouring lanes, which sum them
  // for the zero correction (NARROW: each 4 lanes, a quarter). Rows past M
  // are zeros, never read.
  const int per_row = ng * (BK / 8);   // a multiple of 16: whole warps
  for (int c = tid; c < ROWS * per_row; c += kDecThreads) {
    const int m = c / per_row, cc = c % per_row;
    const int kgl = cc / 16, w = cc % 16;   // k = 8 w .. 8 w + 7
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
    constexpr int kLanes = NARROW ? 4 : 16;
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (w % kLanes == 0) sums[(kgl * P + w / kLanes) * 16 + m] = sum;
    const int wi = NARROW ? w / 4 : w % 4, wt = NARROW ? w % 4 : w / 4;
    As[((kgl * 4 + wi) * 16 + m) * 4 + wt] =
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
    bbt::cp_async_wait<kDecStages - 2>();   // this thread's step gi
    uint32_t wlo[4], whi[4], sraw[P], zraw[P];
    if constexpr (NARROW) {
      // the quad's copies of step gi are complete and visible, and its
      // reads of the stage refilled below (step gi - 1's) are done
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // word t of quad-mate i's chunk: word 4 i + t of the step
        const int sl = slot(i);
        wlo[i] = reinterpret_cast<const uint32_t*>(ring_w(st, 0, sl))[t];
        whi[i] = reinterpret_cast<const uint32_t*>(ring_w(st, 1, sl))[t];
        sraw[i] = *ring_sz(st, 0, tid - t + i);
        zraw[i] = *ring_sz(st, 1, tid - t + i);
      }
    } else {
      const uint4 wl = *ring_w(st, 0, tid), wh = *ring_w(st, 1, tid);
      wlo[0] = wl.x; wlo[1] = wl.y; wlo[2] = wl.z; wlo[3] = wl.w;
      whi[0] = wh.x; whi[1] = wh.y; whi[2] = wh.z; whi[3] = wh.w;
      sraw[0] = *ring_sz(st, 0, tid);
      zraw[0] = *ring_sz(st, 1, tid);
    }
    if (gi + kDecStages - 1 < ng)
      load_step(gi + kDecStages - 1, (gi + kDecStages - 1) % kDecStages);
    bbt::cp_async_commit();
    const uint4* ag = As + (size_t)gi * 4 * 16 * 4;
    // the step's raw sums over q a in f32 (products exact), one
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
        dlo[j] = codes((wlo[i] >> (4 * j)) & 0x000F000Fu);
        dhi[j] = codes((whi[i] >> (4 * j)) & 0x000F000Fu);
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
    // with the scale and zero applied to a group's sums in f32 (the JAX
    // kernel's s * (a @ q - z * sum(a)); rescale: s * (a @ q) - z * sum(a))
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float2 sf =
          __half22float2(*reinterpret_cast<const half2*>(&sraw[q]));
      const float2 zf =
          __half22float2(*reinterpret_cast<const half2*>(&zraw[q]));
      const float* sm = sums + (gi * P + q) * 16;
#pragma unroll
      for (int h = 0; h < NB8; ++h) {
        const float a0s = sm[8 * h + 2 * t], a1s = sm[8 * h + 2 * t + 1];
        float r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          r[e] = NARROW ? gacc[q][h][e]
                        : (gacc[0][h][e] + gacc[1][h][e]) +
                              (gacc[2][h][e] + gacc[3][h][e]);
        if constexpr (RESCALE) {
          acc[h][0] = fmaf(-zf.x, a0s, fmaf(sf.x, r[0], acc[h][0]));
          acc[h][1] = fmaf(-zf.x, a1s, fmaf(sf.x, r[1], acc[h][1]));
          acc[h][2] = fmaf(-zf.y, a0s, fmaf(sf.y, r[2], acc[h][2]));
          acc[h][3] = fmaf(-zf.y, a1s, fmaf(sf.y, r[3], acc[h][3]));
        } else {
          acc[h][0] = fmaf(sf.x, fmaf(-zf.x, a0s, r[0]), acc[h][0]);
          acc[h][1] = fmaf(sf.x, fmaf(-zf.x, a1s, r[1]), acc[h][1]);
          acc[h][2] = fmaf(sf.y, fmaf(-zf.y, a0s, r[2]), acc[h][2]);
          acc[h][3] = fmaf(sf.y, fmaf(-zf.y, a1s, r[3]), acc[h][3]);
        }
      }
    }
  }
  bbt::cp_async_wait<0>();

  // the bias of rows lo and hi, added before the one f16 rounding
  float b_lo = 0.f, b_hi = 0.f;
  if (bias != nullptr && n_ok) {
    b_lo = bias[n_lo];
    b_hi = bias[n_lo + 1];
  }
  // acc[h]: (row lo, token 2t), (lo, 2t + 1), (hi, 2t), (hi, 2t + 1) of
  // tokens m0 + 8 h ...
  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < NB8; ++h) {
      const int m = 8 * h + 2 * t;
      if (!n_ok) continue;
      if (m < mrows)
        *reinterpret_cast<half2*>(out + (size_t)(m0 + m) * N + n_lo) =
            __floats2half2_rn(acc[h][0] + b_lo, acc[h][2] + b_hi);
      if (m + 1 < mrows)
        *reinterpret_cast<half2*>(out + (size_t)(m0 + m + 1) * N + n_lo) =
            __floats2half2_rn(acc[h][1] + b_lo, acc[h][3] + b_hi);
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
          __floats2half2_rn(o.x + b_lo, o.y + b_hi);
    }
  }
}

// log2(g / 32) for g = 32, 64; -1 otherwise.
int narrow_shift(int group) {
  return group == 32 ? 0 : group == 64 ? 1 : -1;
}

// A group the kernels take for this K (K % 128 == 0): 32, 64, 128, a
// multiple of 256 that divides K, or K (per channel): the groups that
// neither straddle a 128-deep step nor a tiled instance's 256-deep slot.
bool group_ok(int K, int group) {
  if (K % BK != 0 || group < 32 || K % group != 0) return false;
  return narrow_shift(group) >= 0 || group == BK || group % 256 == 0 ||
         group == K;
}

template <int NB8, bool NARROW, bool RESCALE>
cudaError_t launch_decode(dim3 grid, int bytes, cudaStream_t st,
                          const half* a, const uint32_t* w, const half* s,
                          const half* z, const float* b, half* o, float* p,
                          int* c, int M, int N, int K, int chunk, int gsteps,
                          int gsh) {
  auto kernel = dequant_decode_kernel<NB8, NARROW, RESCALE>;
  static bool smem_set[bbt::kMaxDevices];
  cudaError_t err =
      bbt::set_max_smem_once(kernel, dec_smem_max(NARROW), smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kDecThreads, bytes, st>>>(a, w, s, z, b, o, p, c, M, N, K,
                                           chunk, gsteps, gsh);
  return cudaGetLastError();
}

}  // namespace

// The tiled instances (bbt::dqw::run_tiled lists them): kernels/
// dequant_matmul.py FUSED_TILES names them after the decode instance, and
// the tuner (tuner/space.py) picks one per M bucket. `rescale`: zeros mode
// rescale (q s - z), else original; `bias` [N] f32 or null.
extern "C" int dequant_matmul_u4(const void* A, const void* Wq,
                                 const void* scales, const void* zeros,
                                 const void* bias, void* out, int M, int N,
                                 int K, int group, int rescale, int bm,
                                 int bn, int bk, int stages, void* stream) {
  if (!group_ok(K, group) || N % 8 != 0 || M < 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  const bool narrow = narrow_shift(group) >= 0;
#define BBT_TILED(RESCALE, NARROW)                                        \
  if ((rescale != 0) == RESCALE && narrow == NARROW)                      \
    return (int)bbt::dqw::run_tiled<bbt::dqw::U4<RESCALE, NARROW>>(       \
        A, Wq, scales, zeros, b, out, M, N, K, group, bm, bn, bk, stages, \
        st);
  BBT_TILED(false, false)
  BBT_TILED(false, true)
  BBT_TILED(true, false)
  BBT_TILED(true, true)
#undef BBT_TILED
  return (int)cudaErrorInvalidValue;
}

// The decode instance (16 x 128, 4 stages): grid (ceil(N / 128), splits,
// ceil(M / 16)); splits = ceil(K / 128 / chunk) with chunk <= 8 steps
// from kernels/dequant_matmul.plan_splits_k. `part` holds splits * M * N
// floats and `count` ceil(N / 128) * ceil(M / 16) zero ints when splits >
// 1 (the kernel leaves them at 0). Dynamic shared memory:
// kernels/dequant_matmul.decode_smem_bytes.
extern "C" int dequant_matmul_u4_decode(const void* A, const void* Wq,
                                        const void* scales,
                                        const void* zeros, const void* bias,
                                        void* out, void* part, void* count,
                                        int M, int N, int K, int group,
                                        int rescale, int chunk, int splits,
                                        void* stream) {
  const int steps = K / BK;
  if (!group_ok(K, group) || N % 8 != 0 || M < 1 || chunk < 1 ||
      chunk > kDecMaxChunk || splits != (steps + chunk - 1) / chunk ||
      splits > 65535 || (M + 15) / 16 > 65535 ||
      (splits > 1 && (part == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kDecBN - 1) / kDecBN, splits, (M + 15) / 16);
  const int gsh = narrow_shift(group);
  const bool narrow = gsh >= 0;
  const int gsteps = narrow ? 0 : group / BK;
  const int bytes = chunk * kDecABytes + dec_sum_bytes(narrow) +
                    kDecStages * kDecStageBytes;
  auto st = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const half*>(A);
  auto w = static_cast<const uint32_t*>(Wq);
  auto s = static_cast<const half*>(scales);
  auto z = static_cast<const half*>(zeros);
  auto b = static_cast<const float*>(bias);
  auto o = static_cast<half*>(out);
  auto p = static_cast<float*>(part);
  auto c = static_cast<int*>(count);
#define BBT_DEC(NB8, NARROW, RESCALE)                                     \
  if ((M <= 8) == (NB8 == 1) && narrow == NARROW &&                       \
      (rescale != 0) == RESCALE)                                          \
    return (int)launch_decode<NB8, NARROW, RESCALE>(                      \
        grid, bytes, st, a, w, s, z, b, o, p, c, M, N, K, chunk, gsteps,  \
        gsh);
  BBT_DEC(1, false, false)
  BBT_DEC(2, false, false)
  BBT_DEC(1, true, false)
  BBT_DEC(2, true, false)
  BBT_DEC(1, false, true)
  BBT_DEC(2, false, true)
  BBT_DEC(1, true, true)
  BBT_DEC(2, true, true)
#undef BBT_DEC
  return (int)cudaErrorInvalidValue;
}
