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
// (kernels/dequant_matmul.py dequant_matmul_i2_plain) bit for bit, and the
// order in which partial sums meet changes no bit.
//
// What bounds it on the H100: at decode M (1..16) the weight bytes, N*K/4,
// over 3.35 TB/s (N = 14336, K = 4096: 0.0044 ms); at prefill M the int8
// tensor-core rate, 2*M*N*K over 1979 TOP/s.
//
// Two designs, chosen by the caller's tile.
//
// Decode M (the 16 x 128 instance, `dequant_matmul_i2_decode`; the default
// up to M = 16): split-K with the weight decoded in registers, the design
// of the uint4 decode instance (dequant_matmul.cu). The kernel it replaced
// decoded each 256-deep K step into a shared int8 tile between two block
// barriers, put the tokens on the mma's 16-row side (12 of 16 rows padding
// at M = 4) and ran N / 32 blocks (128 at N = 4096: under one an SM). So:
//   - mma.sync m16n8k32 (s8 in, s32 accumulate) takes the weight on its
//     16-row side and the tokens on its 8-wide side (out^T = W A^T): a warp
//     owns 16 weight rows, a block 8 warps (128 rows); M <= 8 runs one n8
//     product a k32 step, up to 16 two; larger M runs more M tiles of 16
//     on the grid.
//   - K is split across blocks in steps of 256 (chunk steps a split,
//     kernels/dequant_matmul.plan_splits_k_i2: static sizes only, several
//     blocks in flight on every SM). A block copies its K range of A once
//     into shared memory (one barrier), then each thread streams its own
//     16-byte chunks (four words, 64 codes) of its two weight rows a step
//     through a private 4-stage cp.async ring: it reads back only what it
//     copied, so no barrier sits in the K loop.
//   - The decode stays in registers and costs two integer ops (one for the
//     first) a register of four codes: (w >> 2j) & 0x03030303 holds field j
//     of each byte of word w, the biased codes f = value + 2 in 0..3, which
//     the mma takes as they are (bbt::decode_i2x4, which subtracts the
//     bias, costs about ten: by op count about as long to issue as the
//     codes take to arrive at the byte bound).
//     The bias comes off once a split: sum (f - 2) a = sum f a - 2 sum a,
//     with sum a of each token row over the split's K range summed while
//     A is copied (integers: exact in any order). Register j of word w
//     holds k = 16w + 4p + j in byte p, so A is stored with each 16 bytes
//     transposed 4 x 4 (byte p of register j = A[16w + 4p + j]): the
//     fragments then pair like k with like k. Any order of k inside a
//     product is fine as long as A follows it.
//   - Rows past N are zero-filled codes (sums masked on store), rows past
//     M and K past the end zero-filled activations (K % 64 == 0: a
//     thread's 64-code chunk is wholly in or out): a zero activation adds
//     nothing to either sum whatever its weight decodes to. A zero-filled
//     weight word would decode to -2 everywhere, so the tail is never made
//     zero through the weight.
//   - Each split writes its int32 partial (rows < M only); the last block
//     of each (N tile, M tile) to finish -- an atomic on a per-device
//     counter it resets to 0 -- sums the partials in split order 0, 1, ...
//     and writes f32: one launch a call and the same bits on every call.
//
// Prefill M (the tiled instances, every call with M > 16 on the default
// route): the mixed-input wgmma + TMA main loop of dequant_wgmma.cuh,
// shared with the uint4 x f16 kernel (design and bound written there),
// the int2 fields decoded in registers straight into wgmma's s8 A
// fragments.

#include "common.cuh"
#include "dequant_wgmma.cuh"

namespace {

// -- decode M: split-K, register decode ------------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecThreads = kDecWarps * 32;
constexpr int kDecBN = kDecWarps * 16;      // weight rows a block
constexpr int kDecStep = 256;               // K of a step (a quad's 4 chunks)
constexpr int kDecStages = 4;               // steps in flight a thread
constexpr int kDecMaxChunk = 8;             // steps a split (A in smem)
// shared memory: A [chunk][4 words][rows][4 threads] 16-byte chunks (each
// transposed 4 x 4), the sums of A [16], then the ring: [stage][2 rows]
// [thread] weight chunks
constexpr int kDecStepABytes = 16 * kDecStep;   // per step, 16 rows
constexpr int kDecSumBytes = 16 * 4;
constexpr int kDecStageBytes = kDecThreads * 2 * 16;
constexpr int kDecSmemMax = kDecMaxChunk * kDecStepABytes + kDecSumBytes +
                            kDecStages * kDecStageBytes;

// (b[0..15]) -> the four registers (b[j], b[4 + j], b[8 + j], b[12 + j]),
// j = 0..3: a 4 x 4 byte transpose.
__device__ __forceinline__ uint4 transpose4x4(uint4 x) {
  const uint32_t lo01 = __byte_perm(x.x, x.y, 0x5140);
  const uint32_t hi01 = __byte_perm(x.x, x.y, 0x7362);
  const uint32_t lo23 = __byte_perm(x.z, x.w, 0x5140);
  const uint32_t hi23 = __byte_perm(x.z, x.w, 0x7362);
  return make_uint4(__byte_perm(lo01, lo23, 0x5410),
                    __byte_perm(lo01, lo23, 0x7632),
                    __byte_perm(hi01, hi23, 0x5410),
                    __byte_perm(hi01, hi23, 0x7632));
}

// One block: (N tile of 128 rows, split, M tile of 16 rows); NB8 = 1 for
// at most 8 rows of A (one n8 product a k32 step), 2 for up to 16.
template <int NB8>
__global__ void __launch_bounds__(kDecThreads)
    i2_decode_kernel(const int8_t* __restrict__ A,
                     const uint32_t* __restrict__ Wq,
                     float* __restrict__ out, int* __restrict__ part,
                     int* __restrict__ count, int M, int N, int K,
                     int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ROWS = NB8 * 8;              // rows of A a block holds
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y, splits = gridDim.y;
  const int k0 = split * chunk * kDecStep;
  // >= 1 step: the planner's splits; the last step may end at a K tail
  const int ns = min(chunk, (K - k0 + kDecStep - 1) / kDecStep);
  const int m0 = blockIdx.z * 16;
  const int mrows = min(16, M - m0);
  const int KW = K / 16;
  // this thread's two weight rows: mma rows g (lo) and g + 8 (hi)
  const int n_lo = blockIdx.x * kDecBN + warp * 16 + 2 * g;
  const bool n_ok = n_lo < N;                // N % 8 == 0: n_lo + 1 too

  const int a_bytes = chunk * ROWS * kDecStep;
  uint4* As = reinterpret_cast<uint4*>(smem);
  int* sums = reinterpret_cast<int*>(smem + a_bytes);
  unsigned char* ring = smem + a_bytes + kDecSumBytes;
  auto ring_w = [&](int st, int r) {
    return reinterpret_cast<uint4*>(ring + st * kDecStageBytes) +
           r * kDecThreads + tid;
  };

  // step si: words 4t .. 4t + 3 of the step in both rows (k = 64 t ..
  // 64 t + 63 of it), zero-filled past N or K
  auto load_step = [&](int si, int st) {
    const int k = k0 + si * kDecStep + 64 * t;
    const bool ok = n_ok && k < K;
    const uint32_t* w = Wq + (size_t)n_lo * KW + k / 16;
    bbt::cp_async16(ring_w(st, 0), ok ? w : Wq, ok);
    bbt::cp_async16(ring_w(st, 1), ok ? w + KW : Wq, ok);
  };
  // The weights' first steps go out first: they come from device memory.
#pragma unroll
  for (int s = 0; s < kDecStages - 1; ++s) {
    if (s < ns) load_step(s, s);
    bbt::cp_async_commit();
  }
  if (tid < 16) sums[tid] = 0;
  __syncthreads();
  // Meanwhile A (an L2 hit after the first blocks): rows m0 .. m0 + ROWS -
  // 1 over the split's K range into shared memory as [step][i][m][t]
  // 16-byte chunks, chunk i of thread t holding k = 64 t + 16 i .. + 15 of
  // the step, transposed 4 x 4 (so a quarter warp reads 128 contiguous
  // bytes). The 16 chunks of one row and step sit in 16 neighbouring lanes,
  // which sum them for the bias correction. Rows past M and K past the end
  // are zeros.
  const int per_row = ns * 16;   // a multiple of 16: whole half-warps
  for (int c = tid; c < ROWS * per_row; c += kDecThreads) {
    const int m = c / per_row, cc = c % per_row;
    const int k = k0 + cc * 16;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (m < mrows && k < K)
      x = __ldg(reinterpret_cast<const uint4*>(A + (size_t)(m0 + m) * K + k));
    int s = __dp4a((int)x.x, 0x01010101, 0);
    s = __dp4a((int)x.y, 0x01010101, s);
    s = __dp4a((int)x.z, 0x01010101, s);
    s = __dp4a((int)x.w, 0x01010101, s);
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((lane & 15) == 0) atomicAdd(&sums[m], s);
    const int si = cc / 16, w = cc % 16;
    As[((si * 4 + w % 4) * ROWS + m) * 4 + w / 4] = transpose4x4(x);
  }
  __syncthreads();

  // two accumulator chains (even and odd words) a token block
  int acc[2][NB8][4];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int h = 0; h < NB8; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][h][e] = 0;

  for (int si = 0; si < ns; ++si) {
    const int st = si % kDecStages;
    bbt::cp_async_wait<kDecStages - 2>();   // this thread's step si
    const uint4 wl = *ring_w(st, 0), wh = *ring_w(st, 1);
    if (si + kDecStages - 1 < ns)
      load_step(si + kDecStages - 1, (si + kDecStages - 1) % kDecStages);
    bbt::cp_async_commit();
    const uint32_t wlo[4] = {wl.x, wl.y, wl.z, wl.w};
    const uint32_t whi[4] = {wh.x, wh.y, wh.z, wh.w};
    const uint4* as = As + (size_t)si * 4 * ROWS * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // field j of each byte of word i, rows lo and hi: k = 4p + j of the
      // word in byte p
      uint32_t flo[4], fhi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        flo[j] = (wlo[i] >> (2 * j)) & 0x03030303u;
        fhi[j] = (whi[i] >> (2 * j)) & 0x03030303u;
      }
      // two k32 products: fields (0, 1) then (2, 3); logical k 4t.. is
      // field 2s of the word, 16 + 4t.. field 2s + 1, and A's transposed
      // registers follow the same order
      const uint32_t a0[4] = {flo[0], fhi[0], flo[1], fhi[1]};
      const uint32_t a1[4] = {flo[2], fhi[2], flo[3], fhi[3]};
#pragma unroll
      for (int h = 0; h < NB8; ++h) {
        const uint4 x = as[(i * ROWS + h * 8 + g) * 4 + t];
        const uint32_t b0[2] = {x.x, x.y}, b1[2] = {x.z, x.w};
        bbt::mma_16832_s8(acc[i & 1][h], a0, b0);
        bbt::mma_16832_s8(acc[i & 1][h], a1, b1);
      }
    }
  }
  bbt::cp_async_wait<0>();

  // v[h]: (row lo, token 2t), (lo, 2t + 1), (hi, 2t), (hi, 2t + 1) of
  // tokens m0 + 8 h ..., the bias taken off: sum f a - 2 sum a
  int v[NB8][4];
#pragma unroll
  for (int h = 0; h < NB8; ++h) {
    const int s0 = sums[8 * h + 2 * t], s1 = sums[8 * h + 2 * t + 1];
    v[h][0] = acc[0][h][0] + acc[1][h][0] - 2 * s0;
    v[h][1] = acc[0][h][1] + acc[1][h][1] - 2 * s1;
    v[h][2] = acc[0][h][2] + acc[1][h][2] - 2 * s0;
    v[h][3] = acc[0][h][3] + acc[1][h][3] - 2 * s1;
  }
  if (splits == 1) {
#pragma unroll
    for (int h = 0; h < NB8; ++h) {
      const int m = 8 * h + 2 * t;
      if (!n_ok) continue;
      if (m < mrows)
        *reinterpret_cast<float2*>(out + (size_t)(m0 + m) * N + n_lo) =
            make_float2((float)v[h][0], (float)v[h][2]);
      if (m + 1 < mrows)
        *reinterpret_cast<float2*>(out + (size_t)(m0 + m + 1) * N + n_lo) =
            make_float2((float)v[h][1], (float)v[h][3]);
    }
    return;
  }
  // partial of split s: [s][M][N] int32, rows < M only
  auto at = [&](int sp, int m) {
    return part + ((size_t)sp * M + m0 + m) * N + n_lo;
  };
#pragma unroll
  for (int h = 0; h < NB8; ++h) {
    const int m = 8 * h + 2 * t;
    if (!n_ok) continue;
    if (m < mrows)
      *reinterpret_cast<int2*>(at(split, m)) = make_int2(v[h][0], v[h][2]);
    if (m + 1 < mrows)
      *reinterpret_cast<int2*>(at(split, m + 1)) =
          make_int2(v[h][1], v[h][3]);
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
      int2 o = make_int2(0, 0);
      for (int sp = 0; sp < splits; ++sp) {
        const int2 p = __ldcg(reinterpret_cast<const int2*>(at(sp, m)));
        o.x += p.x;
        o.y += p.y;
      }
      *reinterpret_cast<float2*>(out + (size_t)(m0 + m) * N + n_lo) =
          make_float2((float)o.x, (float)o.y);
    }
  }
}

}  // namespace

// The tiled instances (bbt::dqw::run_tiled lists them): kernels/
// dequant_matmul.py FUSED_TILES names them after the decode instance, and
// the tuner (tuner/space.py) picks one per M bucket.
extern "C" int dequant_matmul_i2(const void* A, const void* Wq, void* out,
                                 int M, int N, int K, int bm, int bn, int bk,
                                 int stages, void* stream) {
  if (K % 64 != 0 || K > 65536 || N % 8 != 0 || M < 1)
    return (int)cudaErrorInvalidValue;
  // no scales, zeros or bias (the group argument is not read)
  return (int)bbt::dqw::run_tiled<bbt::dqw::I2>(
      A, Wq, nullptr, nullptr, nullptr, out, M, N, K, K, bm, bn, bk, stages,
      static_cast<cudaStream_t>(stream));
}

// The decode instance (16 x 128, steps of 256, 4 stages): grid (ceil(N /
// 128), splits, ceil(M / 16)); splits = ceil(ceil(K / 256) / chunk) with
// chunk <= 8 steps from kernels/dequant_matmul.plan_splits_k_i2. `part`
// holds splits * M * N int32 and `count` ceil(N / 128) * ceil(M / 16) zero
// ints when splits > 1 (the kernel leaves them at 0).
extern "C" int dequant_matmul_i2_decode(const void* A, const void* Wq,
                                        void* out, void* part, void* count,
                                        int M, int N, int K, int chunk,
                                        int splits, void* stream) {
  const int steps = (K + kDecStep - 1) / kDecStep;
  if (K % 64 != 0 || K > 65536 || N % 8 != 0 || M < 1 || chunk < 1 ||
      chunk > kDecMaxChunk || splits != (steps + chunk - 1) / chunk ||
      splits > 65535 || (M + 15) / 16 > 65535 ||
      (splits > 1 && (part == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kDecBN - 1) / kDecBN, splits, (M + 15) / 16);
  auto st = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int8_t*>(A);
  auto w = static_cast<const uint32_t*>(Wq);
  auto o = static_cast<float*>(out);
  auto p = static_cast<int*>(part);
  auto c = static_cast<int*>(count);
  cudaError_t err;
  if (M <= 8) {
    const int bytes = chunk * kDecStepABytes / 2 + kDecSumBytes +
                      kDecStages * kDecStageBytes;
    static bool smem_set[bbt::kMaxDevices];
    err = bbt::set_max_smem_once(i2_decode_kernel<1>, kDecSmemMax, smem_set);
    if (err != cudaSuccess) return (int)err;
    i2_decode_kernel<1><<<grid, kDecThreads, bytes, st>>>(a, w, o, p, c, M, N,
                                                          K, chunk);
  } else {
    const int bytes = chunk * kDecStepABytes + kDecSumBytes +
                      kDecStages * kDecStageBytes;
    static bool smem_set[bbt::kMaxDevices];
    err = bbt::set_max_smem_once(i2_decode_kernel<2>, kDecSmemMax, smem_set);
    if (err != cudaSuccess) return (int)err;
    i2_decode_kernel<2><<<grid, kDecThreads, bytes, st>>>(a, w, o, p, c, M, N,
                                                          K, chunk);
  }
  return (int)cudaGetLastError();
}
