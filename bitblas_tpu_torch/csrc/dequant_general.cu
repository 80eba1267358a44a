// The general instances of kernels 1-3 (bitblas_tpu/kernels/
// dequant_matmul.py:make_dequant_matmul, bitblas_tpu/kernels/
// materialize.py:make_weight_decode_pallas and
// make_weight_decode_int8_pallas): every quantized configuration the JAX
// package runs that the specialized instances do not take. The weight
// formats are uint1-32, int1-32, nf4, fp4_e2m1 and fp8 e4m3 / e5m2 (packed
// int32 words for 8 bits or fewer, [N, K] int16 / int32 words for the
// wide ones); the activations and the decode type are any dense type of
// the JAX package (float16, bfloat16, float32, float64, e4m3, e5m2, int4 /
// uint4 / int8 / uint8 / int16 / uint16 / int32 / uint32, each in the torch
// storage of formats.TORCH_DTYPES); every K (a tail past the last word is
// zero codes), every group that divides K; zeros in the modes original,
// rescale and quantized (with or without scales, as JAX's oracle reads
// them).
//
// Semantics are the JAX oracle's (ops/reference.py), value for value: each
// code is decoded into the decode type D (numerics.decode_to: XLA's
// conversions, so an integer D truncates and saturates a float value and
// wraps an integer one, and e4m3 overflows to NaN), the scales and zeros
// converted to D, and (w - z) * s (rescale w * s - z; quantized (q - z)
// in the integer domain, then * s) with every op rounded to D. A value of
// D is carried in a double, exact for every type here, and each op is
// taken in double (__dsub_rn / __dmul_rn: no contraction) and rounded to
// D: for the types of 32 bits or fewer that is the correctly rounded op,
// which is what XLA's float32 op then conversion gives.
//
// dqg_matmul (kernel 1): out[M, N] (Acc) = sum_k A[m, k] W_D[n, k], Acc
// int32 (JAX's int_path: wrapping sums), float32 or float64, each block a
// 32-token x 64-row tile over K in steps of 32: A's tile converted to Acc
// and the weight's tile decoded to Acc in shared memory, then each of the
// 256 threads sums 4 x 2 outputs. The caller adds the bias and casts (the
// oracle's `cast_output`), so no rounding of its own sits here.
// dqg_decode (kernels 2 and 3): the dense W_D [N, K] in D's storage, one
// thread an element.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// dense type codes (kernels/general.py TYPE_CODE)
enum : int {
  T_F16 = 0, T_BF16 = 1, T_F32 = 2, T_F64 = 3, T_E4M3 = 4, T_E5M2 = 5,
  T_I8 = 6, T_U8 = 7, T_I16 = 8, T_U16 = 9, T_I32 = 10, T_U32 = 11,
  T_I4 = 12, T_U4 = 13
};
// weight families (kernels/dequant_matmul.py _FMT_FAMILY)
enum : int { F_UINT = 0, F_INT = 1, F_NF = 2, F_FP4 = 3, F_E4M3 = 4,
             F_E5M2 = 5 };
// zeros modes
enum : int { Z_NONE = 0, Z_ORIGINAL = 1, Z_RESCALE = 2, Z_QUANTIZED = 3 };

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f,
    -0.39491748809814453f, -0.28444138169288635f, -0.18477343022823334f,
    -0.09105003625154495f, 0.0f, 0.07958029955625534f,
    0.16093020141124725f, 0.24611230194568634f, 0.33791524171829224f,
    0.44070982933044434f, 0.5626170039176941f, 0.7229568362236023f, 1.0f};

__device__ __forceinline__ bool is_int_type(int t) { return t >= T_I8; }

__device__ __forceinline__ void int_bounds(int t, int& bits, bool& sgn) {
  switch (t) {
    case T_I8: bits = 8; sgn = true; break;
    case T_U8: bits = 8; sgn = false; break;
    case T_I16: bits = 16; sgn = true; break;
    case T_U16: bits = 16; sgn = false; break;
    case T_I32: bits = 32; sgn = true; break;
    case T_U32: bits = 32; sgn = false; break;
    case T_I4: bits = 4; sgn = true; break;
    default: bits = 4; sgn = false; break;
  }
}

__device__ __forceinline__ double fp8_value(uint8_t b, bool e4m3) {
  __half_raw h = __nv_cvt_fp8_to_halfraw(b, e4m3 ? __NV_E4M3 : __NV_E5M2);
  return (double)__half2float(__half(h));
}

// x (an integer when `from_int`) converted to type t, as XLA converts,
// carried back in a double.
__device__ double to_type(double x, bool from_int, int t) {
  switch (t) {
    case T_F16: return (double)__half2float(__double2half(x));
    case T_BF16: return (double)__bfloat162float(__double2bfloat16(x));
    case T_F32: return (double)(float)x;
    case T_F64: return x;
    case T_E4M3:
      if (isnan(x) || fabs(x) > 464.0) return nan("");
      return fp8_value(__nv_cvt_double_to_fp8(x, __NV_SATFINITE, __NV_E4M3),
                       true);
    case T_E5M2:
      if (isnan(x)) return nan("");
      if (fabs(x) >= 61440.0) return x > 0 ? INFINITY : -INFINITY;
      return fp8_value(__nv_cvt_double_to_fp8(x, __NV_SATFINITE, __NV_E5M2),
                       false);
    default: break;
  }
  int bits;
  bool sgn;
  int_bounds(t, bits, sgn);
  const long long span = 1LL << bits;
  if (from_int) {
    long long v = (long long)x & (span - 1);
    if (sgn && v >= span / 2) v -= span;
    return (double)v;
  }
  const double lo = sgn ? -(double)(span / 2) : 0.0;
  const double hi = sgn ? (double)(span / 2 - 1) : (double)(span - 1);
  if (isnan(x)) return 0.0;
  return fmin(fmax(trunc(x), lo), hi);
}

// element i of a tensor of type t (in its torch storage), as a double
__device__ __forceinline__ double load(const void* p, long long i, int t) {
  switch (t) {
    case T_F16: return (double)__half2float(static_cast<const half*>(p)[i]);
    case T_BF16:
      return (double)__bfloat162float(
          static_cast<const __nv_bfloat16*>(p)[i]);
    case T_F32: return (double)static_cast<const float*>(p)[i];
    case T_F64: return static_cast<const double*>(p)[i];
    case T_E4M3: return fp8_value(static_cast<const uint8_t*>(p)[i], true);
    case T_E5M2: return fp8_value(static_cast<const uint8_t*>(p)[i], false);
    case T_U8: return (double)static_cast<const uint8_t*>(p)[i];
    case T_I16: return (double)static_cast<const int16_t*>(p)[i];
    case T_U16:
    case T_I32: return (double)static_cast<const int32_t*>(p)[i];
    case T_U32: return (double)static_cast<const int64_t*>(p)[i];
    default: return (double)static_cast<const int8_t*>(p)[i];  // i8 i4 u4
  }
}

__device__ __forceinline__ void store(void* p, long long i, int t,
                                      double v) {
  switch (t) {
    case T_F16: static_cast<half*>(p)[i] = __double2half(v); break;
    case T_BF16:
      static_cast<__nv_bfloat16*>(p)[i] = __double2bfloat16(v);
      break;
    case T_F32: static_cast<float*>(p)[i] = (float)v; break;
    case T_F64: static_cast<double*>(p)[i] = v; break;
    case T_E4M3:   // v is already an e4m3 value (or NaN)
      static_cast<uint8_t*>(p)[i] =
          isnan(v) ? 0x7F
                   : __nv_cvt_double_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
      break;
    case T_E5M2:
      static_cast<uint8_t*>(p)[i] =
          __nv_cvt_double_to_fp8(v, __NV_NOSAT, __NV_E5M2);
      break;
    case T_U8: static_cast<uint8_t*>(p)[i] = (uint8_t)(int)v; break;
    case T_I16: static_cast<int16_t*>(p)[i] = (int16_t)v; break;
    case T_U16:
    case T_I32: static_cast<int32_t*>(p)[i] = (int32_t)v; break;
    case T_U32: static_cast<int64_t*>(p)[i] = (int64_t)v; break;
    default: static_cast<int8_t*>(p)[i] = (int8_t)(int)v; break;
  }
}

struct Weight {
  const void* w;       // packed int32 words, or [N, K] int16 / int32
  int family, bits;
  long long row;       // words (or values) a row
  const void* scales;  // [K/g, N] of type s_code, or null
  const void* zeros;   // [K/g, N] of type z_code, or null
  int s_code, z_code, zmode, d, group, n_total;
};

// the reference's fp4_e2m1 and e4m3 bit surgery and e5m2's f16 top byte
__device__ __forceinline__ double fp_field(uint32_t f, int family) {
  if (family == F_FP4) {
    const uint32_t e = f & 7u;
    if (e == 0) return 0.0;
    const uint16_t b = (uint16_t)(((e | 8u) | ((f >> 3) << 5)) << 10);
    return (double)__half2float(__ushort_as_half(b));
  }
  if (family == F_E4M3) {
    const uint32_t e4 = f & 0x40u;
    uint32_t e = ((f & 63u) << 7) | (e4 << 8) | (e4 << 7);
    e ^= 0x2000u;
    const uint16_t b = (uint16_t)(((f >> 7) << 15) | e);
    return (double)__half2float(__ushort_as_half(b));
  }
  return (double)__half2float(__ushort_as_half((uint16_t)(f << 8)));
}

// W_D[n, k], as the JAX oracle decodes it (see the header)
__device__ double decode(const Weight& W, int n, int k) {
  long long sfield;       // the field as JAX's astype(int32) reads it
  uint32_t ufield = 0;    // the unsigned field (sub-byte, 8-bit codes)
  if (W.bits <= 8) {
    const int e = 32 / W.bits;
    const uint32_t word =
        static_cast<const uint32_t*>(W.w)[n * W.row + k / e];
    ufield = (word >> ((k % e) * W.bits)) & ((1u << W.bits) - 1u);
    sfield = ufield;
    if (W.bits == 8 && W.family == F_INT) sfield = (int8_t)ufield;
  } else if (W.bits == 16) {
    const int16_t v = static_cast<const int16_t*>(W.w)[n * W.row + k];
    sfield = W.family == F_INT ? (long long)v : (long long)(uint16_t)v;
  } else {
    const int32_t v = static_cast<const int32_t*>(W.w)[n * W.row + k];
    sfield = W.family == F_INT ? (long long)v : (long long)(uint32_t)v;
  }
  const long long gi = (long long)(k / W.group) * W.n_total + n;
  double w;
  if (W.zeros != nullptr && W.zmode == Z_QUANTIZED) {
    const int32_t z = (int32_t)load(W.zeros, gi, W.z_code);
    const int32_t d = (int32_t)((uint32_t)(int32_t)sfield - (uint32_t)z);
    w = to_type((double)d, true, W.d);
  } else if (W.family == F_UINT || (W.family == F_INT && W.bits >= 8)) {
    w = to_type((double)sfield, true, W.d);
  } else if (W.family == F_INT) {
    w = to_type((double)(sfield - (1LL << (W.bits - 1))), true, W.d);
  } else if (W.family == F_NF) {
    // JAX's table is converted on the host: into an integer type
    // truncated and wrapped (-1.0 into uint8 is 255)
    const double v = (double)kNF4[ufield];
    w = is_int_type(W.d) ? to_type(trunc(v), true, W.d)
                         : to_type(v, false, W.d);
  } else {
    w = to_type(fp_field(ufield, W.family), false, W.d);
  }
  if (W.scales == nullptr) return w;
  const double s = to_type(load(W.scales, gi, W.s_code), false, W.d);
  if (W.zeros == nullptr || W.zmode == Z_QUANTIZED)
    return to_type(__dmul_rn(w, s), false, W.d);
  const double z = to_type(load(W.zeros, gi, W.z_code), false, W.d);
  if (W.zmode == Z_RESCALE)
    return to_type(__dsub_rn(to_type(__dmul_rn(w, s), false, W.d), z), false,
                   W.d);
  return to_type(__dmul_rn(to_type(__dsub_rn(w, z), false, W.d), s), false,
                 W.d);
}

constexpr int BM = 32, BN = 64, BK = 32, THREADS = 256;

template <typename Acc>
__device__ __forceinline__ Acc to_acc(double v) {
  return (Acc)v;
}

template <typename Acc>
__device__ __forceinline__ Acc mac(Acc acc, Acc a, Acc w) {
  return acc + a * w;
}

template <>
__device__ __forceinline__ int32_t mac<int32_t>(int32_t acc, int32_t a,
                                                int32_t w) {
  return (int32_t)((uint32_t)acc + (uint32_t)a * (uint32_t)w);
}

template <typename Acc>
__global__ void __launch_bounds__(THREADS)
    general_kernel(const void* A, int a_code, Weight W, Acc* out, int M,
                   int N, int K) {
  __shared__ Acc As[BK][BM + 1];
  __shared__ Acc Ws[BK][BN + 1];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int tx = tid % 32, ty = tid / 32;   // cols tx, tx + 32; rows 4 ty..
  Acc acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = Acc(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e / BK, c = e % BK;
      const int m = m0 + r, k = k0 + c;
      As[c][r] = (m < M && k < K)
                     ? to_acc<Acc>(load(A, (long long)m * K + k, a_code))
                     : Acc(0);
    }
#pragma unroll
    for (int i = 0; i < BN * BK / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e / BK, c = e % BK;
      const int n = n0 + r, k = k0 + c;
      Ws[c][r] = (n < N && k < K) ? to_acc<Acc>(decode(W, n, k)) : Acc(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      const Acc w0 = Ws[c][tx], w1 = Ws[c][tx + 32];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const Acc a = As[c][ty * 4 + i];
        acc[i][0] = mac(acc[i][0], a, w0);
        acc[i][1] = mac(acc[i][1], a, w1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + tx + 32 * j;
      if (n < N) out[(long long)m * N + n] = acc[i][j];
    }
  }
}

__global__ void decode_kernel(Weight W, void* out, int N, int K) {
  const long long total = (long long)N * K;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(i / K), k = (int)(i % K);
    store(out, i, W.d, decode(W, n, k));
  }
}

bool weight_ok(int family, int bits) {
  if (family == F_UINT || family == F_INT)
    return bits == 1 || bits == 2 || bits == 4 || bits == 8 || bits == 16 ||
           bits == 32;
  if (family == F_NF || family == F_FP4) return bits == 4;
  return (family == F_E4M3 || family == F_E5M2) && bits == 8;
}

Weight make_weight(const void* Wq, int family, int bits, const void* scales,
                   int s_code, const void* zeros, int z_code, int zmode,
                   int d_code, int N, int K, int group) {
  Weight W;
  W.w = Wq;
  W.family = family;
  W.bits = bits;
  W.row = bits <= 8 ? ((long long)K * bits + 31) / 32 : K;
  W.scales = scales;
  W.zeros = zeros;
  W.s_code = s_code;
  W.z_code = z_code;
  W.zmode = zmode;
  W.d = d_code;
  W.group = group;
  W.n_total = N;
  return W;
}

}  // namespace

// acc_code: 0 int32, 1 float32, 2 float64 (the type of `out`)
extern "C" int dqg_matmul(const void* A, int a_code, const void* Wq,
                          int family, int bits, const void* scales,
                          int s_code, const void* zeros, int z_code,
                          int zmode, int d_code, int acc_code, void* out,
                          int M, int N, int K, int group, void* stream) {
  if (!weight_ok(family, bits) || M < 1 || N < 1 || K < 1 || group < 1 ||
      K % group != 0 || acc_code < 0 || acc_code > 2)
    return (int)cudaErrorInvalidValue;
  const Weight W = make_weight(Wq, family, bits, scales, s_code, zeros,
                               z_code, zmode, d_code, N, K, group);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  auto st = static_cast<cudaStream_t>(stream);
  if (acc_code == 0)
    general_kernel<int32_t><<<grid, THREADS, 0, st>>>(
        A, a_code, W, static_cast<int32_t*>(out), M, N, K);
  else if (acc_code == 1)
    general_kernel<float><<<grid, THREADS, 0, st>>>(
        A, a_code, W, static_cast<float*>(out), M, N, K);
  else
    general_kernel<double><<<grid, THREADS, 0, st>>>(
        A, a_code, W, static_cast<double*>(out), M, N, K);
  return (int)cudaGetLastError();
}

extern "C" int dqg_decode(const void* Wq, int family, int bits,
                          const void* scales, int s_code, const void* zeros,
                          int z_code, int zmode, int d_code, void* out, int N,
                          int K, int group, void* stream) {
  if (!weight_ok(family, bits) || N < 1 || K < 1 || group < 1 ||
      K % group != 0)
    return (int)cudaErrorInvalidValue;
  const Weight W = make_weight(Wq, family, bits, scales, s_code, zeros,
                               z_code, zmode, d_code, N, K, group);
  const long long total = (long long)N * K;
  const int blocks = (int)((total + 255) / 256 < 132 * 16 ? (total + 255) / 256
                                                          : 132 * 16);
  decode_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      W, out, N, K);
  return (int)cudaGetLastError();
}
