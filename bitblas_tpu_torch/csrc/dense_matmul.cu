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
// Design, a simple kernel that is right: a 2-stage cp.async double buffer
// of A and W tiles in shared memory; the warps of a block split the
// (BM, BN) tile and run mma.sync m16n8k16 (f16 / bf16 -> f32) or m16n8k32
// (s8 -> s32) on fragments read from shared memory; float32 runs one FFMA
// chain per output over k, each thread owning a TM x 8 patch. No kernel
// of the program calls it (nor does the JAX package call its Pallas
// twin): it is the tuner's explicit-tile dense GEMM, held against its
// plain version and timed against cuBLAS by chip_smoke.py. wgmma and TMA
// are left for later work.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

template <typename T>
struct Elem;
template <>
struct Elem<half> {
  using Acc = float;
  static constexpr int kK = 16;   // k of one mma
};
template <>
struct Elem<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kK = 16;
};
template <>
struct Elem<int8_t> {
  using Acc = int;
  static constexpr int kK = 32;
};

__device__ __forceinline__ void mma_op(float* d, const uint32_t* a,
                                       const uint32_t* b, const half*) {
  bbt::mma_16816(d, a, b);
}
__device__ __forceinline__ void mma_op(float* d, const uint32_t* a,
                                       const uint32_t* b,
                                       const __nv_bfloat16*) {
  bbt::mma_16816_bf16(d, a, b);
}
__device__ __forceinline__ void mma_op(int* d, const uint32_t* a,
                                       const uint32_t* b, const int8_t*) {
  bbt::mma_16832_s8(d, a, b);
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

template <typename T, int BM, int BN, int BK>
struct MmaTile {
  static constexpr int kChunk = 16 / (int)sizeof(T);   // elements per 16 B
  static constexpr int kLds = BK + kChunk;             // row stride + 16 B
  static constexpr size_t kSmemBytes =
      2 * (size_t)(BM + BN) * kLds * sizeof(T);
};

template <typename T, int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32)
    dense_mma_kernel(const T* __restrict__ A, const T* __restrict__ W,
                     void* __restrict__ out, int M, int N, int K, int code) {
  using Tl = MmaTile<T, BM, BN, BK>;
  using Acc = typename Elem<T>::Acc;
  constexpr int kThreads = WM * WN * 32, LDS = Tl::kLds, CH = Tl::kChunk;
  constexpr int KK = Elem<T>::kK, PER = 4 / (int)sizeof(T);
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  static_assert(WTM % 16 == 0 && WTN % 8 == 0 && BK % KK == 0, "tile");

  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);      // [2][BM][LDS]
  T* Ws = As + 2 * BM * LDS;               // [2][BN][LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = K / BK;

  auto load_stage = [&](int kt, int s) {
    const int k0 = kt * BK;
    T* as = As + s * BM * LDS;
    for (int c = tid; c < BM * (BK / CH); c += kThreads) {
      const int r = c / (BK / CH), cc = c % (BK / CH);
      const bool ok = m0 + r < M;   // rows past M: zero-filled
      bbt::cp_async16(as + r * LDS + cc * CH,
                      ok ? A + (size_t)(m0 + r) * K + k0 + cc * CH : A, ok);
    }
    T* ws = Ws + s * BN * LDS;
    for (int c = tid; c < BN * (BK / CH); c += kThreads) {
      const int r = c / (BK / CH), cc = c % (BK / CH);
      bbt::cp_async16(ws + r * LDS + cc * CH,
                      W + (size_t)(n0 + r) * K + k0 + cc * CH, true);
    }
  };

  Acc acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_stage(0, 0);
  bbt::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load_stage(kt + 1, (kt + 1) & 1);
    bbt::cp_async_commit();   // possibly empty: the wait below stays exact
    bbt::cp_async_wait<1>();  // every group but the newest: slab kt landed
    __syncthreads();
    const T* as = As + (kt & 1) * BM * LDS;
    const T* ws = Ws + (kt & 1) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += KK) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const T* p = as + (wm * WTM + i * 16 + g) * LDS + kk + PER * t;
        af[i][0] = ld32(p);
        af[i][1] = ld32(p + 8 * LDS);
        af[i][2] = ld32(p + KK / 2);
        af[i][3] = ld32(p + 8 * LDS + KK / 2);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* p = ws + (wn * WTN + j * 8 + g) * LDS + kk + PER * t;
        bf[j][0] = ld32(p);
        bf[j][1] = ld32(p + KK / 2);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_op(acc[i][j], af[i], bf[j], static_cast<const T*>(nullptr));
    }
    __syncthreads();   // the next iteration's load overwrites this stage
  }

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int row = m0 + wm * WTM + i * 16 + g;
      const int col = n0 + wn * WTN + j * 8 + 2 * t;   // N % BN == 0
      if (row < M)
        store2(out, code, (size_t)row * N + col, acc[i][j][0], acc[i][j][1]);
      if (row + 8 < M)
        store2(out, code, (size_t)(row + 8) * N + col, acc[i][j][2],
               acc[i][j][3]);
    }
  }
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

template <typename T, int BM, int BN, int BK, int WM, int WN>
cudaError_t launch_mma(const void* A, const void* W, void* out, int M, int N,
                       int K, int code, cudaStream_t stream) {
  using Tl = MmaTile<T, BM, BN, BK>;
  auto kernel = dense_mma_kernel<T, BM, BN, BK, WM, WN>;
  static bool smem_set[bbt::kMaxDevices];
  cudaError_t err =
      bbt::set_max_smem_once(kernel, (int)Tl::kSmemBytes, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  kernel<<<grid, WM * WN * 32, Tl::kSmemBytes, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(W), out, M, N, K, code);
  return cudaGetLastError();
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

// Operand codes (kernels/dense.py _A_CODE): 0 float16, 1 bfloat16,
// 2 float32, 3 int8.
template <int BM, int BN, int BK, int WM, int WN>
cudaError_t run(int a_code, const void* A, const void* W, void* out, int M,
                int N, int K, int code, cudaStream_t st) {
  switch (a_code) {
    case 0:
      return launch_mma<half, BM, BN, BK, WM, WN>(A, W, out, M, N, K, code,
                                                  st);
    case 1:
      return launch_mma<__nv_bfloat16, BM, BN, BK, WM, WN>(A, W, out, M, N,
                                                           K, code, st);
    case 2:
      return launch_f32<BM, BN, BK, WM * WN * 32>(A, W, out, M, N, K, code,
                                                  st);
    case 3:
      return launch_mma<int8_t, BM, BN, BK, WM, WN>(A, W, out, M, N, K,
                                                    code, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The compiled tiles (BM, BN, BK) with their warp grids; kernels/dense.py
// DENSE_TILES lists the same three.
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
  if (bm == 16 && bn == 128 && bk == 128)
    return (int)run<16, 128, 128, 1, 4>(a_code, A, W, out, M, N, K,
                                        out_code, st);
  if (bm == 64 && bn == 128 && bk == 64)
    return (int)run<64, 128, 64, 2, 2>(a_code, A, W, out, M, N, K, out_code,
                                       st);
  if (bm == 128 && bn == 128 && bk == 64)
    return (int)run<128, 128, 64, 2, 4>(a_code, A, W, out, M, N, K,
                                        out_code, st);
  return (int)cudaErrorInvalidValue;
}
