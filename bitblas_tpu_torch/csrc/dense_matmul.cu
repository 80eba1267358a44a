// dense_matmul: out[M, N] = A[M, K] . W[N, K]^T, the explicitly tiled "nt"
// dense GEMM.
//
// Replaces bitblas_tpu/kernels/dense.py:make_dense_matmul_pallas (its
// pallas_call at :105). What it computes is the same: f16 and bf16
// operands accumulate in float32, int8 operands in int32, float32
// operands in true float32 (FFMA; TF32 would not be the same function);
// the sums are cast once to the output type (float16 / bfloat16 round to
// nearest even, int32 sums to float32 likewise). The tile (BM, BN, BK)
// comes from the caller's hint; N % BN == 0 and K % BK == 0 are required,
// as in JAX. JAX pads M up to BM and slices the padding off; here rows
// past M are zero-filled on load and not stored, which gives the same
// rows. Bias is added outside the kernel in the output type, as JAX adds
// it after its pallas_call.
//
// Operands: A [M, K] and W [N, K] row-major in one type (f16, bf16, f32 or
// int8), 16-byte aligned; out [M, N] row-major, float16 / bfloat16 /
// float32 for float operands, int32 / float32 for int8.
//
// What bounds it on the H100: bytes ((M + N) * K operands in, M * N out)
// over 3.35 TB/s at small M; operations, 2 * M * N * K, over 989 TFLOP/s
// (f16 / bf16), 1979 TOP/s (int8) or 67 TFLOP/s (float32 FFMA) at large
// M.
//
// Design. Tiles of 64 rows and more (64 x 128, 128 x 128, 128 x 256) run
// on Hopper's wgmma + TMA main loop (the loop of flash_attention.cu, with
// the helpers of hopper.cuh):
//   - one producer warp issues cp.async.bulk.tensor loads of the A and W
//     tiles of each K step into a 4-stage ring of full / empty mbarriers.
//     A K step is 128 bytes of every row (64 f16 / bf16, 128 int8): one
//     128-byte-swizzled box per operand, K-major for both, exactly the
//     S = Q K^T operands of the flash kernel. Rows past M and, for int8,
//     a K tail of 64 past the last full step are TMA's zero fill: they add
//     0 to every sum. The tensor maps are encoded per call
//     (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, no -lcuda).
//   - BM / 64 consumer warpgroups each own 64 rows and run
//     wgmma.mma_async m64n128k16 .f32.f16.f16 / .f32.bf16.bf16 or
//     m64n128k32 .s32.s8.s8 from shared memory (BN / 128 products a
//     32-byte k slice), keeping one K step's products in flight while the
//     next stage is waited for; a stage is released when its products are
//     done. The sums stay in registers and are cast and stored directly.
// The 16-row tile is float32's alone: kernels/dense.py runs a hint that
// names it for f16 / bf16 / int8 on the 64 x 128 wgmma tile, which at
// M = 16 (the weight bytes bound the product) measured faster than a
// 16-row mma.sync tile, though 48 of its 64 rows are padding: its ring
// keeps more bytes in flight. float32 runs one FFMA chain per output
// over k (each thread a TM x 8 patch, 2-stage cp.async) at every tile: no
// tensor-core op computes full float32. No kernel of the program calls kernel 9 (nor
// does the JAX package call its Pallas twin): it is the tuner's
// explicit-tile dense GEMM, held against its plain version and timed
// against cuBLAS by chip_smoke.py.

#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// Output codes (kernels/dense.py _OUT_CODE): 0 float16, 1 bfloat16,
// 2 float32, 3 int32.
__device__ __forceinline__ void store1(void* out, int code, size_t i,
                                       float x) {
  if (code == 0)
    static_cast<half*>(out)[i] = __float2half_rn(x);
  else if (code == 1)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(out)[i] = x;
}

__device__ __forceinline__ void store2(void* out, int code, size_t i,
                                       float x0, float x1) {
  if (code == 0)
    *reinterpret_cast<half2*>(static_cast<half*>(out) + i) =
        __floats2half2_rn(x0, x1);
  else if (code == 1)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       i) = __floats2bfloat162_rn(x0, x1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
        make_float2(x0, x1);
}

__device__ __forceinline__ void store2(void* out, int code, size_t i, int x0,
                                       int x1) {
  if (code == 3)
    *reinterpret_cast<int2*>(static_cast<int*>(out) + i) = make_int2(x0, x1);
  else   // float32: one round-to-nearest conversion of the exact sum
    *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
        make_float2((float)x0, (float)x1);
}

// -- the wgmma + TMA main loop (tiles of 64 rows and more) -------------------

// d (64 x 128) += A (64 x k, shared, K-major) W (128 x k, shared, K-major)^T
// for one 32-byte k slice; d in wgmma's accumulator layout: d[4 j + e] is
// row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2 of the warpgroup's
// tile (warp w of the group, g = lane / 4, t = lane % 4).
__device__ __forceinline__ void wgmma_f16(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, "
      "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, "
      "0;\nwgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, "
      "%2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, "
      "0;\nwgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <typename T>
struct Wg;
template <>
struct Wg<half> {
  using Acc = float;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    wgmma_f16(d, da, db);
  }
};
template <>
struct Wg<__nv_bfloat16> {
  using Acc = float;
  static constexpr CUtensorMapDataType kMap =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    wgmma_bf16(d, da, db);
  }
};
template <>
struct Wg<int8_t> {
  using Acc = int;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  __device__ __forceinline__ static void mma(int (&d)[64], uint64_t da,
                                             uint64_t db) {
    wgmma_s8(d, da, db);
  }
};

constexpr int kRowBytes = 128;   // bytes of K a stage holds of every row

template <int BM, int BN, int STAGES>
struct WgTile {
  static constexpr int kGroups = BM / 64;              // consumer groups
  static constexpr int kConsumers = 128 * kGroups;
  static constexpr int kThreads = kConsumers + 32;     // + producer warp
  static constexpr int kStageBytes = (BM + BN) * kRowBytes;
  static constexpr int kSmemBytes =
      1024 /* alignment */ + STAGES * kStageBytes + 2 * STAGES * 8;
};

template <typename T, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(WgTile<BM, BN, STAGES>::kThreads, 1)
    dense_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tw,
                       void* __restrict__ out, int M, int N, int K,
                       int code) {
  using Tl = WgTile<BM, BN, STAGES>;
  using Acc = typename Wg<T>::Acc;
  constexpr int NH = BN / 128;                     // m64n128 products
  constexpr int KE = kRowBytes / (int)sizeof(T);   // K elements a stage
  static_assert(BM % 64 == 0 && BN % 128 == 0, "tile");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Tl::kStageBytes);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + KE - 1) / KE;   // an int8 tail of 64: zero-filled

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bbt::mbar_init(&full[i], 1);
      bbt::mbar_init(&empty[i], Tl::kConsumers);
    }
    bbt::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= Tl::kConsumers) {   // the producer warp: one thread issues
    if (tid == Tl::kConsumers) {
      for (int j = 0; j < nk; ++j) {
        const int st = j % STAGES;
        // use u = j / STAGES of a stage waits for the release of use u - 1
        if (j >= STAGES) bbt::mbar_wait(&empty[st], (j / STAGES - 1) & 1);
        unsigned char* a = smem + st * Tl::kStageBytes;
        bbt::mbar_expect_tx(&full[st], Tl::kStageBytes);
        bbt::tma_load_2d(a, &ta, &full[st], j * KE, m0);
        bbt::tma_load_2d(a + BM * kRowBytes, &tw, &full[st], j * KE, n0);
      }
    }
    return;
  }

  const int grp = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  Acc acc[NH][64];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0;

  for (int j = 0; j < nk; ++j) {
    const int st = j % STAGES;
    bbt::mbar_wait(&full[st], (j / STAGES) & 1);
    const uint32_t a_addr =
        bbt::smem_u32(smem + st * Tl::kStageBytes + grp * 64 * kRowBytes);
    const uint32_t w_addr =
        bbt::smem_u32(smem + st * Tl::kStageBytes + BM * kRowBytes);
#pragma unroll
    for (int h = 0; h < NH; ++h) bbt::fence_regs(acc[h]);
    bbt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowBytes / 32; ++kk)
#pragma unroll
      for (int h = 0; h < NH; ++h)
        Wg<T>::mma(acc[h], bbt::desc_sw128(a_addr + kk * 32),
                   bbt::desc_sw128(w_addr + h * 128 * kRowBytes + kk * 32));
    bbt::wgmma_commit();
    // keep this step's products in flight; those of step j - 1 are done,
    // so its stage may be refilled
    bbt::wgmma_wait<1>();
#pragma unroll
    for (int h = 0; h < NH; ++h) bbt::fence_regs(acc[h]);
    if (j > 0) bbt::mbar_arrive(&empty[(j - 1) % STAGES]);
  }
  bbt::wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < NH; ++h) bbt::fence_regs(acc[h]);

  const int r_lo = m0 + grp * 64 + warp * 16 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const int col = n0 + h * 128 + jn * 8 + 2 * t;   // N % BN == 0
      if (r_lo < M)
        store2(out, code, (size_t)r_lo * N + col, acc[h][4 * jn],
               acc[h][4 * jn + 1]);
      if (r_hi < M)
        store2(out, code, (size_t)r_hi * N + col, acc[h][4 * jn + 2],
               acc[h][4 * jn + 3]);
    }
  }
}

template <typename T, int BM, int BN, int STAGES>
cudaError_t launch_wgmma(const void* A, const void* W, void* out, int M,
                         int N, int K, int code, cudaStream_t stream) {
  using Tl = WgTile<BM, BN, STAGES>;
  const bbt::EncodeTiled encode = bbt::encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap ta, tw;
  if (!bbt::make_map_2d(encode, &ta, A, Wg<T>::kMap, sizeof(T), M, K, BM) ||
      !bbt::make_map_2d(encode, &tw, W, Wg<T>::kMap, sizeof(T), N, K, BN))
    return cudaErrorInvalidValue;
  auto kernel = dense_wgmma_kernel<T, BM, BN, STAGES>;
  static bool smem_set[bbt::kMaxDevices];
  cudaError_t err = bbt::set_max_smem_once(kernel, Tl::kSmemBytes, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  kernel<<<grid, Tl::kThreads, Tl::kSmemBytes, stream>>>(ta, tw, out, M, N,
                                                         K, code);
  return cudaGetLastError();
}

template <int BM, int BN, int BK>
struct F32Tile {
  static constexpr int kLds = BK + 4;   // floats; keeps 16-byte rows
  static constexpr size_t kSmemBytes = 2 * (size_t)(BM + BN) * kLds * 4;
};

template <int BM, int BN, int BK, int THREADS>
__global__ void __launch_bounds__(THREADS)
    dense_f32_kernel(const float* __restrict__ A, const float* __restrict__ W,
                     void* __restrict__ out, int M, int N, int K, int code) {
  constexpr int LDS = F32Tile<BM, BN, BK>::kLds;
  constexpr int TN = 8, CG = BN / TN;   // columns tc, tc + CG, ...
  constexpr int TM = BM * BN / (THREADS * TN);
  static_assert(THREADS / CG * TM == BM && BK % 4 == 0, "tile");

  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);   // [2][BM][LDS]
  float* Ws = As + 2 * BM * LDS;                // [2][BN][LDS]

  const int tid = threadIdx.x, tc = tid % CG, tr = tid / CG;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = K / BK;

  auto load_stage = [&](int kt, int s) {
    const int k0 = kt * BK;
    float* as = As + s * BM * LDS;
    for (int c = tid; c < BM * (BK / 4); c += THREADS) {
      const int r = c / (BK / 4), cc = c % (BK / 4);
      const bool ok = m0 + r < M;
      bbt::cp_async16(as + r * LDS + cc * 4,
                      ok ? A + (size_t)(m0 + r) * K + k0 + cc * 4 : A, ok);
    }
    float* ws = Ws + s * BN * LDS;
    for (int c = tid; c < BN * (BK / 4); c += THREADS) {
      const int r = c / (BK / 4), cc = c % (BK / 4);
      bbt::cp_async16(ws + r * LDS + cc * 4,
                      W + (size_t)(n0 + r) * K + k0 + cc * 4, true);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load_stage(0, 0);
  bbt::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage(kt + 1, (kt + 1) & 1);
    bbt::cp_async_commit();
    bbt::cp_async_wait<1>();
    __syncthreads();
    const float* as = As + (kt & 1) * BM * LDS + tr * TM * LDS;
    const float* ws = Ws + (kt & 1) * BN * LDS + tc * LDS;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[i * LDS + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[j * CG * LDS + k];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + tr * TM + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j)
      store1(out, code, (size_t)row * N + n0 + tc + j * CG, acc[i][j]);
  }
}

template <int BM, int BN, int BK, int THREADS>
cudaError_t launch_f32(const void* A, const void* W, void* out, int M, int N,
                       int K, int code, cudaStream_t stream) {
  using Tl = F32Tile<BM, BN, BK>;
  auto kernel = dense_f32_kernel<BM, BN, BK, THREADS>;
  static bool smem_set[bbt::kMaxDevices];
  cudaError_t err =
      bbt::set_max_smem_once(kernel, (int)Tl::kSmemBytes, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  kernel<<<grid, THREADS, Tl::kSmemBytes, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(W), out, M, N,
      K, code);
  return cudaGetLastError();
}

// Tiles of 64 rows and more on wgmma (float32 on FFMA with F32_THREADS
// threads); BK = 64 (128 bytes of f16 / bf16, half a stage of int8).
template <int BM, int BN, int STAGES, int F32_THREADS>
cudaError_t run_wgmma(int a_code, const void* A, const void* W, void* out,
                      int M, int N, int K, int code, cudaStream_t st) {
  switch (a_code) {
    case 0:
      return launch_wgmma<half, BM, BN, STAGES>(A, W, out, M, N, K, code,
                                                st);
    case 1:
      return launch_wgmma<__nv_bfloat16, BM, BN, STAGES>(A, W, out, M, N, K,
                                                         code, st);
    case 2:
      return launch_f32<BM, BN, 64, F32_THREADS>(A, W, out, M, N, K, code,
                                                 st);
    case 3:
      return launch_wgmma<int8_t, BM, BN, STAGES>(A, W, out, M, N, K, code,
                                                  st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The compiled tiles (BM, BN, BK); kernels/dense.py DENSE_TILES lists the
// same four (the first for float32) and dense_smem_bytes their shared
// memory (4 stages a wgmma ring).
extern "C" int dense_matmul(const void* A, const void* W, void* out, int M,
                            int N, int K, int a_code, int out_code, int bm,
                            int bn, int bk, void* stream) {
  const bool int_in = a_code == 3;
  const bool out_ok = int_in ? (out_code == 2 || out_code == 3)
                             : (out_code >= 0 && out_code <= 2);
  if (M < 1 || bn <= 0 || bk <= 0 || N % bn != 0 || K % bk != 0 ||
      a_code < 0 || a_code > 3 || !out_ok)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bm == 16 && bn == 128 && bk == 128)   // float32 only
    return a_code == 2 ? (int)launch_f32<16, 128, 128, 128>(
                             A, W, out, M, N, K, out_code, st)
                       : (int)cudaErrorInvalidValue;
  if (bm == 64 && bn == 128 && bk == 64)
    return (int)run_wgmma<64, 128, 4, 128>(a_code, A, W, out, M, N, K,
                                           out_code, st);
  if (bm == 128 && bn == 128 && bk == 64)
    return (int)run_wgmma<128, 128, 4, 256>(a_code, A, W, out, M, N, K,
                                            out_code, st);
  if (bm == 128 && bn == 256 && bk == 64)
    return (int)run_wgmma<128, 256, 4, 256>(a_code, A, W, out, M, N, K,
                                            out_code, st);
  return (int)cudaErrorInvalidValue;
}
