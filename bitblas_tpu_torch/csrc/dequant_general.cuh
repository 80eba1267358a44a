// The general instances of kernels 1-3: the decode, the sum units and the
// kernels (see csrc/dequant_general.cu). Two sources instantiate them:
// dequant_general.cu (the mma.sync units, the decode kernel) and
// dequant_general_ffma.cu (DMMA and FFMA), so that they build side by
// side.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace bbt {
namespace dqg {

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
// sum units (kernels/general.py UNIT_CODE)
enum : int { UNIT_F16 = 0, UNIT_BF16 = 1, UNIT_S8 = 2, UNIT_F64 = 3,
             UNIT_FFMA = 4 };

__constant__ float kNF4[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f,
    -0.39491748809814453f, -0.28444138169288635f, -0.18477343022823334f,
    -0.09105003625154495f, 0.0f, 0.07958029955625534f,
    0.16093020141124725f, 0.24611230194568634f, 0.33791524171829224f,
    0.44070982933044434f, 0.5626170039176941f, 0.7229568362236023f, 1.0f};

__host__ __device__ constexpr bool is_int_type(int t) {
  return t >= T_I8 && t <= T_U4;
}
__host__ __device__ constexpr bool is_float_d(int t) {
  return t == T_F16 || t == T_BF16 || t == T_F32;
}
// The decode's template classes: float16, bfloat16 and float32 each its
// own (D's value in a float); every integer type one class, its width read
// at run time (D's value in a long long); float64, e4m3 and e5m2 one class
// (the double path)
enum : int { DT_INT = 100, DT_DBL = 101 };
__host__ __device__ constexpr int dt_class(int t) {
  return is_float_d(t) ? t : is_int_type(t) ? DT_INT : DT_DBL;
}

// bytes of an element of type t in its torch storage
__host__ __device__ constexpr int storage_bytes(int t) {
  return t == T_F16 || t == T_BF16 || t == T_I16 ? 2
         : t == T_F32 || t == T_U16 || t == T_I32 ? 4
         : t == T_F64 || t == T_U32                ? 8
                                                    : 1;
}

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

struct Weight {
  const void* w;       // packed int32 words, or [N, K] int16 / int32
  int family, bits;
  long long row;       // words (or values) a row
  const void* scales;  // [K/g, N] of type s_code, or null
  const void* zeros;   // [K/g, N] of type z_code, or null
  int s_code, z_code, zmode, d, group, n_total;
};

// the reference's fp4_e2m1 and e4m3 bit surgery and e5m2's f16 top byte:
// a float16 value
__device__ __forceinline__ float fp_field(uint32_t f, int family) {
  if (family == F_FP4) {
    const uint32_t e = f & 7u;
    if (e == 0) return 0.f;
    const uint16_t b = (uint16_t)(((e | 8u) | ((f >> 3) << 5)) << 10);
    return __half2float(__ushort_as_half(b));
  }
  if (family == F_E4M3) {
    const uint32_t e4 = f & 0x40u;
    uint32_t e = ((f & 63u) << 7) | (e4 << 8) | (e4 << 7);
    e ^= 0x2000u;
    const uint16_t b = (uint16_t)(((f >> 7) << 15) | e);
    return __half2float(__ushort_as_half(b));
  }
  return __half2float(__ushort_as_half((uint16_t)(f << 8)));
}

// One code's fields: the unsigned field (sub-byte and 8-bit codes) and the
// field as JAX's astype(int32) reads it.
struct Field {
  uint32_t u;
  long long s;
};

__device__ __forceinline__ Field field_of(const Weight& W, uint32_t raw) {
  Field f;
  if (W.bits <= 8) {
    f.u = raw;
    f.s = (W.bits == 8 && W.family == F_INT) ? (long long)(int8_t)raw
                                             : (long long)raw;
  } else if (W.bits == 16) {
    f.u = 0;
    f.s = W.family == F_INT ? (long long)(int16_t)raw
                            : (long long)(uint16_t)raw;
  } else {
    f.u = 0;
    f.s = W.family == F_INT ? (long long)(int32_t)raw
                            : (long long)(uint32_t)raw;
  }
  return f;
}

// the raw code of W[n, k] (a field, or the int16 / int32 value's bits)
__device__ __forceinline__ uint32_t code_at(const Weight& W, int n, int k) {
  if (W.bits <= 8) {
    const int e = 32 / W.bits;
    const uint32_t word =
        static_cast<const uint32_t*>(W.w)[n * W.row + k / e];
    return (word >> ((k % e) * W.bits)) & ((1u << W.bits) - 1u);
  }
  if (W.bits == 16)
    return (uint16_t)static_cast<const int16_t*>(W.w)[n * W.row + k];
  return (uint32_t)static_cast<const int32_t*>(W.w)[n * W.row + k];
}

// -- float16 / bfloat16 / float32 decode types: D's value in a float ------

template <int DT>
__device__ __forceinline__ float rnd(float x) {   // x rounded to D
  if constexpr (DT == T_F16) return __half2float(__float2half_rn(x));
  else if constexpr (DT == T_BF16)
    return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

template <int DT>
__device__ __forceinline__ float rnd_d(double x) {   // a double to D
  if constexpr (DT == T_F16) return __half2float(__double2half(x));
  else if constexpr (DT == T_BF16)
    return __bfloat162float(__double2bfloat16(x));
  else return __double2float_rn(x);
}

// an integer to D, correctly rounded: exact in float below 2^24 (a 32-bit
// conversion), through a double above
template <int DT>
__device__ __forceinline__ float rnd_int(long long v) {
  if (v > -(1LL << 24) && v < (1LL << 24))
    return rnd<DT>(__int2float_rn((int)v));
  return rnd_d<DT>((double)v);
}

// element i of a scale or zero tensor, converted to D
template <int DT>
__device__ __forceinline__ float param(const void* p, long long i, int t) {
  switch (t) {
    case T_F16: return rnd<DT>(__half2float(static_cast<const half*>(p)[i]));
    case T_BF16:
      return rnd<DT>(__bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]));
    case T_F32: return rnd<DT>(static_cast<const float*>(p)[i]);
    case T_E4M3:
    case T_E5M2: return rnd<DT>((float)load(p, i, t));
    default: return rnd_d<DT>(load(p, i, t));
  }
}

// -- integer decode types: D's value in a long long ------------------------

// an integer wrapped into D's width
__device__ __forceinline__ long long wrap_to(long long v, int d) {
  int bits;
  bool sgn;
  int_bounds(d, bits, sgn);
  const long long span = 1LL << bits;
  v &= span - 1;
  return sgn && v >= span / 2 ? v - span : v;
}

// a float value truncated and saturated into D (NaN -> 0)
__device__ __forceinline__ long long sat_to(float x, int d) {
  int bits;
  bool sgn;
  int_bounds(d, bits, sgn);
  const long long span = 1LL << bits;
  const double lo = sgn ? -(double)(span / 2) : 0.0;
  const double hi = sgn ? (double)(span / 2 - 1) : (double)(span - 1);
  if (isnan(x)) return 0;
  return (long long)fmin(fmax(trunc((double)x), lo), hi);
}

// D's value type V: float (float16, bfloat16, float32: exact there),
// long long (the integer types) or double (float64, e4m3, e5m2)
template <int DT>
struct DecodeType {
  using V = typename std::conditional<
      is_float_d(DT), float,
      typename std::conditional<DT == DT_INT, long long,
                                double>::type>::type;
};

// What a code's first value is, by the weight's family and zeros mode
// (hoisted out of the per-code loops: one template instance each)
enum : int { K_INT = 0, K_INTOFF = 1, K_NF = 2, K_FP = 3, K_QZ = 4 };

__host__ __device__ __forceinline__ int kind_of(const Weight& W) {
  if (W.zeros != nullptr && W.zmode == Z_QUANTIZED) return K_QZ;
  if (W.family == F_UINT || (W.family == F_INT && W.bits >= 8)) return K_INT;
  if (W.family == F_INT) return K_INTOFF;
  return W.family == F_NF ? K_NF : K_FP;
}

// A group's scale and zero in D (float / double D), or its quantized zero
template <int DT>
struct Group {
  typename DecodeType<DT>::V s, z;
  int32_t zq;
};

template <int DT>
__device__ __forceinline__ Group<DT> group_of(const Weight& W, long long gi) {
  Group<DT> g;
  g.s = g.z = 0;
  g.zq = 0;
  if (W.zeros != nullptr && W.zmode == Z_QUANTIZED)
    g.zq = static_cast<const int32_t*>(W.zeros)[gi];
  if constexpr (DT != DT_INT) {
    if (W.scales != nullptr) {
      if constexpr (is_float_d(DT)) {
        g.s = param<DT>(W.scales, gi, W.s_code);
        if (W.zeros != nullptr && W.zmode != Z_QUANTIZED)
          g.z = param<DT>(W.zeros, gi, W.z_code);
      } else {
        g.s = to_type(load(W.scales, gi, W.s_code), false, W.d);
        if (W.zeros != nullptr && W.zmode != Z_QUANTIZED)
          g.z = to_type(load(W.zeros, gi, W.z_code), false, W.d);
      }
    }
  }
  return g;
}

// W_D of code `raw` in its group g, as the JAX oracle decodes it: the
// code's value in D (quantized zeros: the field less the zero in int32,
// then converted), then with scales (w - z) * s, rescale w * s - z,
// quantized w * s, each op rounded to D
template <int DT, int KIND>
__device__ __forceinline__ typename DecodeType<DT>::V decode_k(
    const Weight& W, uint32_t raw, const Group<DT>& g) {
  const Field f = field_of(W, raw);
  long long iv = 0;   // an integer first value
  if constexpr (KIND == K_QZ)
    iv = (int32_t)((uint32_t)(int32_t)f.s - (uint32_t)g.zq);
  else if constexpr (KIND == K_INT) iv = f.s;
  else if constexpr (KIND == K_INTOFF) iv = f.s - (1LL << (W.bits - 1));
  if constexpr (DT == DT_INT) {
    // integer D only without scales (ops/reference.decode_type); JAX's nf4
    // table is converted on the host: truncated, then wrapped (-1.0 into
    // uint8 is 255); an fp value truncated and saturated
    if constexpr (KIND == K_NF)
      return wrap_to((long long)truncf(kNF4[f.u]), W.d);
    else if constexpr (KIND == K_FP)
      return sat_to(fp_field(f.u, W.family), W.d);
    else return wrap_to(iv, W.d);
  } else if constexpr (is_float_d(DT)) {
    float w;
    if constexpr (KIND == K_NF) w = rnd<DT>(kNF4[f.u]);
    else if constexpr (KIND == K_FP) w = rnd<DT>(fp_field(f.u, W.family));
    else if (W.bits < 32) w = rnd<DT>(__int2float_rn((int)iv));   // < 2^24
    else w = rnd_int<DT>(iv);
    // the last op is left unrounded: its one consumer rounds it to D (the
    // operand of the f16 / bf16 / FFMA units is D itself, and dqg_decode
    // stores D), the same single rounding
    if (W.scales == nullptr) return w;
    if (KIND == K_QZ || W.zeros == nullptr) return __fmul_rn(w, g.s);
    if (W.zmode == Z_RESCALE)
      return __fsub_rn(rnd<DT>(__fmul_rn(w, g.s)), g.z);
    return __fmul_rn(rnd<DT>(__fsub_rn(w, g.z)), g.s);
  } else {   // float64, e4m3, e5m2: the ops in double, each rounded to D
    const int d = W.d;
    double w;
    if constexpr (KIND == K_NF) w = to_type((double)kNF4[f.u], false, d);
    else if constexpr (KIND == K_FP)
      w = to_type((double)fp_field(f.u, W.family), false, d);
    else w = to_type((double)iv, true, d);
    if (W.scales == nullptr) return w;
    if (KIND == K_QZ || W.zeros == nullptr)
      return to_type(__dmul_rn(w, g.s), false, d);
    if (W.zmode == Z_RESCALE)
      return to_type(__dsub_rn(to_type(__dmul_rn(w, g.s), false, d), g.z),
                     false, d);
    return to_type(__dmul_rn(to_type(__dsub_rn(w, g.z), false, d), g.s),
                   false, d);
  }
}

// The same, the kind (uniform over a launch) chosen at run time
template <int DT>
__device__ __forceinline__ typename DecodeType<DT>::V decode_rt(
    const Weight& W, uint32_t raw, const Group<DT>& g, int kind) {
  switch (kind) {
    case K_INT: return decode_k<DT, K_INT>(W, raw, g);
    case K_INTOFF: return decode_k<DT, K_INTOFF>(W, raw, g);
    case K_NF: return decode_k<DT, K_NF>(W, raw, g);
    case K_FP: return decode_k<DT, K_FP>(W, raw, g);
    default: return decode_k<DT, K_QZ>(W, raw, g);
  }
}

// W_D[n, k] at group index gi (the one-element decode kernel)
template <int DT>
__device__ __forceinline__ typename DecodeType<DT>::V decode_value(
    const Weight& W, uint32_t raw, long long gi) {
  return decode_rt<DT>(W, raw, group_of<DT>(W, gi), kind_of(W));
}


// D's value stored in D's storage (the integer and double classes by the
// decode type d)
template <int DT>
__device__ __forceinline__ void store_d(void* p, long long i,
                                        typename DecodeType<DT>::V v, int d) {
  if constexpr (DT == T_F16) static_cast<half*>(p)[i] = __float2half_rn(v);
  else if constexpr (DT == T_BF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else if constexpr (DT == T_F32) static_cast<float*>(p)[i] = v;
  else if constexpr (DT == DT_DBL) {
    if (d == T_F64) static_cast<double*>(p)[i] = v;
    else if (d == T_E4M3)   // v is already an e4m3 value (or NaN)
      static_cast<uint8_t*>(p)[i] =
          isnan(v) ? 0x7F
                   : __nv_cvt_double_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
    else
      static_cast<uint8_t*>(p)[i] =
          __nv_cvt_double_to_fp8(v, __NV_NOSAT, __NV_E5M2);
  } else {
    switch (d) {
      case T_U8: static_cast<uint8_t*>(p)[i] = (uint8_t)v; break;
      case T_I16: static_cast<int16_t*>(p)[i] = (int16_t)v; break;
      case T_U16:
      case T_I32: static_cast<int32_t*>(p)[i] = (int32_t)v; break;
      case T_U32: static_cast<int64_t*>(p)[i] = (int64_t)v; break;
      default: static_cast<int8_t*>(p)[i] = (int8_t)v; break;   // i8 i4 u4
    }
  }
}

// -- the sum units ----------------------------------------------------------

constexpr int BK = 32, THREADS = 256, STAGES = 4;

// m16n8k32 with either operand signed or unsigned 8-bit
template <bool AU, bool WU>
__device__ __forceinline__ void mma_16832(int* d, const uint32_t* a,
                                          const uint32_t* b) {
#define BBT_MMA_I8(TA, TB)                                                    \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." TA "." TB ".s32 "    \
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "              \
               "{%0, %1, %2, %3};\n"                                         \
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),      \
                 "r"(b[1]))
  if constexpr (AU && WU) BBT_MMA_I8("u8", "u8");
  else if constexpr (AU) BBT_MMA_I8("u8", "s8");
  else if constexpr (WU) BBT_MMA_I8("s8", "u8");
  else BBT_MMA_I8("s8", "s8");
#undef BBT_MMA_I8
}

// D (8x8) += A (8x4, row) B (4x8, col), float64: a = A[g][t], b = B[t][g]
// (= W[g][t]), d[0..1] = D[g][2t..2t+1] (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_884_f64(double* d, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// A unit: the operand type Op in shared memory (pitch BK + PAD elements),
// the sums' type Acc, the weight rows a block BN.
template <int UNIT>
struct Unit;
template <>
struct Unit<UNIT_F16> {
  using Op = half;
  using Acc = float;
  static constexpr int BN = 64, PAD = 8;
};
template <>
struct Unit<UNIT_BF16> {
  using Op = __nv_bfloat16;
  using Acc = float;
  static constexpr int BN = 64, PAD = 8;
};
template <>
struct Unit<UNIT_S8> {
  using Op = int8_t;
  using Acc = int;
  static constexpr int BN = 64, PAD = 16;
};
template <>
struct Unit<UNIT_F64> {
  using Op = double;
  using Acc = double;
  static constexpr int BN = 32, PAD = 2;
};
template <>
struct Unit<UNIT_FFMA> {
  using Op = float;
  using Acc = float;
  static constexpr int BN = 64, PAD = 4;
};

// A value of D (or of A's type) as the unit's operand: exact for every
// pair general_unit gives the unit
template <typename Op, typename V>
__device__ __forceinline__ Op to_op(V v) {
  if constexpr (std::is_same<Op, half>::value) {
    if constexpr (std::is_same<V, float>::value) return __float2half_rn(v);
    else if constexpr (std::is_same<V, double>::value)
      return __double2half(v);
    else return __int2half_rn((int)v);
  } else if constexpr (std::is_same<Op, __nv_bfloat16>::value) {
    return __float2bfloat16_rn((float)v);
  } else if constexpr (std::is_same<Op, int8_t>::value) {
    return (int8_t)(int)v;   // uint8 values keep their bits (u8 operands)
  } else if constexpr (std::is_same<Op, double>::value) {
    return (double)v;
  } else {   // float
    if constexpr (std::is_same<V, long long>::value) return __ll2float_rn(v);
    else if constexpr (std::is_same<V, double>::value)
      return __double2float_rn(v);
    else return v;
  }
}

// Element j of a staged A row (A's torch storage) as the unit's operand.
template <typename Op>
__device__ __forceinline__ Op a_op(const unsigned char* row, int j, int t) {
  switch (t) {
    case T_F16: return to_op<Op>(__half2float(
        reinterpret_cast<const half*>(row)[j]));
    case T_BF16: return to_op<Op>(__bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(row)[j]));
    case T_F32: return to_op<Op>(reinterpret_cast<const float*>(row)[j]);
    case T_F64: return to_op<Op>(reinterpret_cast<const double*>(row)[j]);
    case T_E4M3: return to_op<Op>(fp8_value(row[j], true));
    case T_E5M2: return to_op<Op>(fp8_value(row[j], false));
    case T_U8: return to_op<Op>((long long)row[j]);
    case T_I16: return to_op<Op>(
        (long long)reinterpret_cast<const int16_t*>(row)[j]);
    case T_U16:
    case T_I32: return to_op<Op>(
        (long long)reinterpret_cast<const int32_t*>(row)[j]);
    case T_U32: return to_op<Op>(
        (long long)reinterpret_cast<const int64_t*>(row)[j]);
    default: return to_op<Op>(
        (long long)reinterpret_cast<const int8_t*>(row)[j]);
  }
}

// cp.async of `gran` (16 or 4) bytes, the first `valid` of them read and
// the rest zero-filled; gran 1: a plain byte copy
__device__ __forceinline__ void copy_chunk(unsigned char* dst,
                                           const unsigned char* src,
                                           int gran, int valid) {
  if (gran == 16) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid));
  } else if (gran == 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid));
  } else {
    *dst = valid > 0 ? *src : (unsigned char)0;
  }
}

// `rows` rows of `bytes` bytes (a multiple of gran) from global rows
// `stride` bytes apart, each with `avail` readable bytes from the tile's
// start (the rest zero), into shared rows `pitch` bytes apart; rows past
// `live` are zero.
__device__ __forceinline__ void copy_tile(unsigned char* dst, int pitch,
                                          const unsigned char* src,
                                          long long stride, int rows,
                                          int live, int bytes,
                                          long long avail, int gran) {
  // bytes and gran are powers of two: shifts, not divisions
  const int lg = __ffs(bytes / gran) - 1, per_row = 1 << lg;
  for (int i = threadIdx.x; i < rows << lg; i += THREADS) {
    const int r = i >> lg, c = (i & (per_row - 1)) * gran;
    long long v = r < live ? avail - c : 0;
    v = v < 0 ? 0 : v > gran ? gran : v;
    copy_chunk(dst + r * pitch + c, src + (v > 0 ? r * stride + c : 0),
               gran, (int)v);
  }
}

// The block's tile sizes at MR rows of M. A row of the ring is A's BK
// elements plus 16 bytes: the operand pitch WPITCH when A's storage is the
// operand type ("direct": the products read A from the ring).
template <int UNIT>
struct Plan {
  using U = Unit<UNIT>;
  static constexpr int WPITCH = BK + U::PAD;   // operand rows, elements
  static constexpr int OPB = sizeof(typename U::Op);
  __host__ __device__ static constexpr int a_raw(int mr, int esz) {
    return mr * (BK * esz + 16);
  }
  __host__ __device__ static constexpr int w_raw(int bits) {
    return U::BN * BK * bits / 8;
  }
  // the ring (A's rows and the weight's words), A's operand tiles (two,
  // unless direct) and the weight's (two)
  __host__ __device__ static constexpr int smem(int mr, int esz, int bits,
                                                bool direct) {
    return STAGES * (a_raw(mr, esz) + w_raw(bits)) +
           2 * ((direct ? 0 : mr) + U::BN) * WPITCH * OPB;
  }
};

// splits > 1: block z of the grid sums steps [z steps / splits, (z + 1)
// steps / splits) of K into part [splits][M][N], and the last block of
// each (N tile, M tile) to finish -- an atomic on a per-device counter
// that it leaves at 0 -- adds the partials in split order (the same sums
// in the same order at every call).
template <int UNIT, int DT, int MR, bool AU, bool WU>
__global__ void __launch_bounds__(THREADS, 1)
    general_kernel(const void* A, int a_code, Weight W_param,
                   typename Unit<UNIT>::Acc* out, int M, int N, int K,
                   int a_gran, int w_gran, int direct, int splits,
                   typename Unit<UNIT>::Acc* part, int* count) {
  // a local copy: the decode takes it by reference, which would otherwise
  // copy the parameter to local memory
  const Weight W = W_param;
  using U = Unit<UNIT>;
  using P = Plan<UNIT>;
  using Op = typename U::Op;
  using Acc = typename U::Acc;
  constexpr int BN = U::BN, WP = P::WPITCH;
  extern __shared__ __align__(16) unsigned char smem[];
  const int esz = storage_bytes(a_code);
  const int a_raw = P::a_raw(MR, esz), w_raw = P::w_raw(W.bits);
  const int a_rpitch = BK * esz + 16;
  unsigned char* raw = smem;   // STAGES x (A rows, weight rows)
  Op* aop = reinterpret_cast<Op*>(smem + STAGES * (a_raw + w_raw));
  Op* wop = aop + (direct ? 0 : 2 * MR * WP);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * MR;
  const int mrows = min(MR, M - m0), nrows = min(BN, N - n0);
  const int mpad = min(MR, (mrows + 15) / 16 * 16);   // A rows held
  const int all_steps = (K + BK - 1) / BK;
  const int lo = (int)((long long)blockIdx.z * all_steps / splits);
  const int steps =
      (int)((long long)(blockIdx.z + 1) * all_steps / splits) - lo;
  const unsigned char* a_src =
      static_cast<const unsigned char*>(A) + (long long)m0 * K * esz;
  // weight rows: words (or values) of W.bits bits
  const int wbytes_row = BK * W.bits / 8;   // a step's bytes of a row
  const long long w_stride = W.bits <= 8 ? W.row * 4 : W.row * W.bits / 8;
  const unsigned char* w_src =
      static_cast<const unsigned char*>(W.w) + (long long)n0 * w_stride;

  auto step_of = [&](int t) { return lo + t; };
  auto issue = [&](int t) {
    if (t < steps) {
      unsigned char* st = raw + (t % STAGES) * (a_raw + w_raw);
      const int k0 = step_of(t) * BK;
      copy_tile(st, a_rpitch, a_src + (long long)k0 * esz, (long long)K * esz,
                mpad, mrows, BK * esz, (long long)(K - k0) * esz, a_gran);
      const long long wk0 = (long long)k0 * W.bits / 8;
      copy_tile(st + a_raw, wbytes_row, w_src + wk0, w_stride, BN, nrows,
                wbytes_row, w_stride - wk0, w_gran);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // decode step t's weight (raw stage) and convert its A into buffer t % 2
  constexpr int EPT = BN * BK / THREADS;   // codes a thread: 8 (4: f64)
  const int kind = kind_of(W);   // one per launch: a uniform branch
  // EPT consecutive codes of one row a thread; they share one group when
  // the group is a multiple of EPT (their first k is one), and the group's
  // scale and zero are read once
  const bool one_group = W.group % EPT == 0;
  auto decode_row = [&](const unsigned char* st, Op* wo, int t) {
    using V = typename DecodeType<DT>::V;
    const int r = tid / (BK / EPT), kc = (tid % (BK / EPT)) * EPT;
    const unsigned char* wr = st + a_raw + r * wbytes_row;
    const int n = n0 + r, k0 = step_of(t) * BK + kc;
    Op* out_row = wo + r * WP + kc;
    Group<DT> g = {};
    if (one_group && n < N && k0 < K)
      g = group_of<DT>(W, (long long)(k0 / W.group) * W.n_total + n);
    // the thread's codes, read from the ring at once: EPT * bits bits, one
    // word when they fit in one, else the EPT * bits / 32 words from the
    // first (a multiple of EPT * bits)
    const int bit0 = kc * W.bits;
    const int nw = EPT * W.bits <= 32 ? 1 : EPT * W.bits / 32;
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(wr) + (bit0 >> 5);
    uint64_t q0 = wp[0], q1 = 0, q2 = 0, q3 = 0;
    if (nw > 1) q0 |= (uint64_t)wp[1] << 32;
    if (nw > 2) q1 = wp[2] | (uint64_t)wp[3] << 32;
    if (nw > 4) {
      q2 = wp[4] | (uint64_t)wp[5] << 32;
      q3 = wp[6] | (uint64_t)wp[7] << 32;
    }
    const int off = nw == 1 ? bit0 & 31 : 0;
    const uint64_t mask = (1ull << W.bits) - 1;
    auto code = [&](int e) -> uint32_t {   // no field straddles 64 bits
      const int b = off + e * W.bits, h = b >> 6;
      const uint64_t x = h == 0 ? q0 : h == 1 ? q1 : h == 2 ? q2 : q3;
      return (uint32_t)((x >> (b & 63)) & mask);
    };
#pragma unroll 1
    for (int e = 0; e < EPT; ++e) {
      const int k = k0 + e;
      Op v = to_op<Op>((V)0);
      if (n < N && k < K) {
        if (!one_group)
          g = group_of<DT>(W, (long long)(k / W.group) * W.n_total + n);
        v = to_op<Op>(decode_rt<DT>(W, code(e), g, kind));
      }
      out_row[e] = v;
    }
  };
  auto convert = [&](int t) {
    const unsigned char* st = raw + (t % STAGES) * (a_raw + w_raw);
    Op* ao = aop + (t % 2) * MR * WP;
    Op* wo = wop + (t % 2) * BN * WP;
    // A (unless direct): rows >= M and k >= K are zeros (the ring
    // zero-filled them)
    if (!direct) {
      for (int i = tid; i < mpad * (BK / 4); i += THREADS) {
        const int r = i / (BK / 4), j = (i % (BK / 4)) * 4;
        const unsigned char* row = st + r * a_rpitch;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ao[r * WP + j + e] = a_op<Op>(row, j + e, a_code);
      }
    }
    decode_row(st, wo, t);
  };

  // sums: see the units above
  constexpr int FM = UNIT == UNIT_FFMA ? MR / 16 : 1;
  constexpr int MT = UNIT == UNIT_F64 ? MR / 16 : MR / 32;   // m tiles a warp
  Acc acc[UNIT == UNIT_FFMA ? FM : MT][UNIT == UNIT_FFMA ? 4 :
                                      UNIT == UNIT_F64 ? 2 : 8];
#pragma unroll
  for (int i = 0; i < (UNIT == UNIT_FFMA ? FM : MT); ++i)
#pragma unroll
    for (int j = 0; j < (UNIT == UNIT_FFMA ? 4 : UNIT == UNIT_F64 ? 2 : 8);
         ++j)
      acc[i][j] = Acc(0);
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, tq = lane & 3;
  const int wm = warp / 4, wn = warp % 4;

  auto products = [&](int t) {
    const Op* ao = direct ? reinterpret_cast<const Op*>(
                                raw + (t % STAGES) * (a_raw + w_raw))
                          : aop + (t % 2) * MR * WP;
    const Op* wo = wop + (t % 2) * BN * WP;
    if constexpr (UNIT == UNIT_F16 || UNIT == UNIT_BF16 ||
                  UNIT == UNIT_S8) {
      // 32 bytes of K a k-step: two k16 steps of 16-bit operands, one k32
      // of 8-bit ones; fragments by ldmatrix (rows of 16 bytes: lane l
      // gives row l % 16 (A) or l % 8 + 8 (l / 16) (B), at byte 16 (l / 8
      // % 2) (B) or 16 (l / 16) (A) of the k-step)
      constexpr int KSTEP = UNIT == UNIT_S8 ? 32 : 16;
#pragma unroll
      for (int kk = 0; kk < BK; kk += KSTEP) {
        uint32_t b[4];   // b[0..1]: n8 tile 0, b[2..3]: n8 tile 1
        bbt::ldmatrix_x4(b, wo + (wn * 16 + (lane % 8) + 8 * (lane / 16)) * WP
                                + kk + (16 / (int)sizeof(Op)) *
                                           ((lane / 8) % 2));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int mt = wm + 2 * i;
          if (mt * 16 >= mrows) break;
          uint32_t a[4];
          bbt::ldmatrix_x4(a, ao + (mt * 16 + lane % 16) * WP + kk +
                                  (16 / (int)sizeof(Op)) * (lane / 16));
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if constexpr (UNIT == UNIT_F16)
              bbt::mma_16816(&acc[i][4 * j], a, &b[2 * j]);
            else if constexpr (UNIT == UNIT_BF16)
              bbt::mma_16816_bf16(&acc[i][4 * j], a, &b[2 * j]);
            else
              mma_16832<AU, WU>(&acc[i][4 * j], a, &b[2 * j]);
          }
        }
      }
    } else if constexpr (UNIT == UNIT_F64) {
#pragma unroll
      for (int k4 = 0; k4 < BK; k4 += 4) {
        const double b = wo[(wn * 8 + g) * WP + k4 + tq];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int mt = wm + 2 * i;   // m8 tiles
          if (mt * 8 >= mrows) break;
          mma_884_f64(acc[i], ao[(mt * 8 + g) * WP + k4 + tq], b);
        }
      }
    } else {   // FFMA: thread (tx, ty) columns tx + 16 j, rows ty + 16 i
      const int tx = tid % 16, ty = tid / 16;
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = wo[(tx + 16 * j) * WP + k];
#pragma unroll
        for (int i = 0; i < FM; ++i) {
          if (i * 16 >= mrows) break;
          const float a = ao[(ty + 16 * i) * WP + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
        }
      }
    }
  };

  // The ring runs three steps ahead. At step t, after the barrier: step t
  // + 3's copies go to the stage step t - 1 used (its products and decode
  // are done), step t + 1 is decoded while step t's products run, and
  // step t + 2's copies stay in flight.
  issue(0);
  issue(1);
  issue(2);
  asm volatile("cp.async.wait_group 2;\n" ::);
  __syncthreads();
  convert(0);
  for (int t = 0; t < steps; ++t) {
    asm volatile("cp.async.wait_group 1;\n" ::);   // step t + 1 is in
    __syncthreads();
    issue(t + 3);
    if (t + 1 < steps) convert(t + 1);
    products(t);
  }

  // out[m, n], or this split's partial
  Acc* dst = splits > 1 ? part + (size_t)blockIdx.z * M * N : out;
  if constexpr (UNIT == UNIT_FFMA) {
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      const int m = ty + 16 * i;
      if (m >= mrows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j;
        if (n < nrows) dst[(long long)(m0 + m) * N + n0 + n] = acc[i][j];
      }
    }
  } else if constexpr (UNIT == UNIT_F64) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = (wm + 2 * i) * 8 + g;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = wn * 8 + 2 * tq + e;
        if (m < mrows && n < nrows)
          dst[(long long)(m0 + m) * N + n0 + n] = acc[i][e];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = (wm + 2 * i) * 16 + g + 8 * (e / 2);
          const int n = wn * 16 + j * 8 + 2 * tq + (e % 2);
          if (m < mrows && n < nrows)
            dst[(long long)(m0 + m) * N + n0 + n] = acc[i][4 * j + e];
        }
      }
    }
  }
  if (splits == 1) return;
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = count + (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    last = atomicAdd(cnt, 1) == splits - 1;
    if (last) *cnt = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < mrows * nrows; i += THREADS) {
    const size_t at = (size_t)(m0 + i / nrows) * N + n0 + i % nrows;
    Acc v = __ldcg(part + at);
    for (int sp = 1; sp < splits; ++sp) {
      const Acc p = __ldcg(part + (size_t)sp * M * N + at);
      if constexpr (std::is_same<Acc, int>::value)   // wrapping int32 sums
        v = (int)((unsigned)v + (unsigned)p);
      else
        v += p;
    }
    out[at] = v;
  }
}

template <int DT>
__global__ void decode_kernel(Weight W, void* out, int N, int K) {
  const long long total = (long long)N * K;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int n = (int)(i / K), k = (int)(i % K);
    const long long gi = (long long)(k / W.group) * W.n_total + n;
    store_d<DT>(out, i, decode_value<DT>(W, code_at(W, n, k), gi), W.d);
  }
}

inline bool weight_ok(int family, int bits) {
  if (family == F_UINT || family == F_INT)
    return bits == 1 || bits == 2 || bits == 4 || bits == 8 || bits == 16 ||
           bits == 32;
  if (family == F_NF || family == F_FP4) return bits == 4;
  return (family == F_E4M3 || family == F_E5M2) && bits == 8;
}

inline Weight make_weight(const void* Wq, int family, int bits,
                          const void* scales, int s_code, const void* zeros,
                          int z_code, int zmode, int d_code, int N, int K,
                          int group) {
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

constexpr int kMaxSmem = 232448;   // an H100 block's opt-in limit

// The caller's scratch for the split of K: partials (of the unit's sums'
// type, part_elems of them), counters (all 0) and the device's SMs
struct Split {
  void* part;
  long long part_elems;
  int* count;
  int counters, sms;
};

// the copy granularity rows `stride` bytes apart from `ptr` allow, each
// step's tile `tile_bytes` long and starting at a multiple of
// `step_bytes`: 16, 4, or 1 (plain loads)
inline int gran_of(const void* ptr, long long stride, int tile_bytes,
                   long long step_bytes) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(ptr);
  auto ok = [&](int g) {
    return p % g == 0 && stride % g == 0 && tile_bytes % g == 0 &&
           step_bytes % g == 0;
  };
  return ok(16) ? 16 : ok(4) ? 4 : 1;
}

// whether A's storage is the unit's operand type
inline bool direct_a(int unit, int a_code) {
  switch (unit) {
    case UNIT_F16: return a_code == T_F16;
    case UNIT_BF16: return a_code == T_BF16;
    case UNIT_S8: return true;   // int8 / uint8 / int4 / uint4: one byte
    case UNIT_F64: return a_code == T_F64;
    default: return a_code == T_F32;
  }
}

template <int UNIT, int DT, int MR, bool AU, bool WU>
int launch_mr(const void* A, int a_code, const Weight& W, void* out, int M,
              int N, int K, const Split& sp, cudaStream_t stream) {
  using U = Unit<UNIT>;
  const int esz = storage_bytes(a_code);
  const bool direct = direct_a(UNIT, a_code);
  const int smem = Plan<UNIT>::smem(MR, esz, W.bits, direct);
  static bool smem_set[bbt::kMaxDevices];
  // the cap less room for the merge's static flag
  cudaError_t err = bbt::set_max_smem_once(
      general_kernel<UNIT, DT, MR, AU, WU>, kMaxSmem - 1024, smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long w_stride = W.bits <= 8 ? W.row * 4 : W.row * W.bits / 8;
  const int w_gran = gran_of(W.w, w_stride, BK * W.bits / 8, BK * W.bits / 8);
  const int a_gran = gran_of(A, (long long)K * esz, BK * esz, BK * esz);
  using Acc = typename U::Acc;
  const int tiles = ((N + U::BN - 1) / U::BN) * ((M + MR - 1) / MR);
  // splits of K: enough blocks for ~3 an SM where the tiles are fewer,
  // each at least 8 steps; only where the caller gave the scratch
  int splits = 1;
  if (sp.part != nullptr && sp.count != nullptr && tiles < 2 * sp.sms) {
    const int steps = (K + BK - 1) / BK;
    splits = (3 * sp.sms + tiles - 1) / tiles;
    splits = min(splits, max(1, steps / 8));
    if ((long long)splits * M * N > sp.part_elems || tiles > sp.counters)
      splits = 1;
  }
  const dim3 grid((N + U::BN - 1) / U::BN, (M + MR - 1) / MR, splits);
  general_kernel<UNIT, DT, MR, AU, WU><<<grid, THREADS, smem, stream>>>(
      A, a_code, W, static_cast<Acc*>(out), M, N, K, a_gran, w_gran,
      (int)direct, splits, static_cast<Acc*>(sp.part), sp.count);
  return (int)cudaGetLastError();
}

// M rows a block (MR): the smallest instance that holds M where shared
// memory takes it, else the largest that fits (then the weight is decoded
// once per MR rows): 32 / 512 rows for the tensor-core units, 32 / 128 /
// 256 for FFMA, 32 / 128 for float64.
template <int UNIT, int DT, bool AU = false, bool WU = false>
int launch_unit(const void* A, int a_code, const Weight& W, void* out, int M,
                int N, int K, const Split& sp, cudaStream_t stream) {
  const int esz = storage_bytes(a_code);
  const bool direct = direct_a(UNIT, a_code);
  auto fits = [&](int mr) {
    return Plan<UNIT>::smem(mr, esz, W.bits, direct) <= kMaxSmem - 1024;
  };
  if (M <= 32)
    return launch_mr<UNIT, DT, 32, AU, WU>(A, a_code, W, out, M, N, K, sp,
                                           stream);
  if constexpr (UNIT == UNIT_FFMA || UNIT == UNIT_F64) {
    if constexpr (UNIT == UNIT_FFMA) {
      if (M > 128 && fits(256))
        return launch_mr<UNIT, DT, 256, AU, WU>(A, a_code, W, out, M, N, K,
                                                sp, stream);
    }
    return launch_mr<UNIT, DT, 128, AU, WU>(A, a_code, W, out, M, N, K, sp,
                                            stream);
  } else {
    // every tensor-core case fits 512 rows (the largest: one-byte A
    // converted, 32-bit weight words, 223 KB)
    return launch_mr<UNIT, DT, 512, AU, WU>(A, a_code, W, out, M, N, K, sp,
                                            stream);
  }
}

// The instances: the decode types general_unit gives each unit
// (kernels/general.py)
// kTensor: the tensor-core units of mma.sync (dequant_general.cu), else
// DMMA and FFMA (dequant_general_ffma.cu): two sources that build side by
// side
template <bool kTensor>
int launch_general(int unit, const void* A, int a_code, const Weight& W,
                   void* out, int M, int N, int K, const Split& sp,
                   cudaStream_t st) {
  const int d = W.d;
#define BBT_GEN(U, DT, AU, WU)                                              \
  if (dt_class(d) == DT)                                                    \
    return launch_unit<U, DT, AU, WU>(A, a_code, W, out, M, N, K, sp, st)
  if constexpr (kTensor) {
    switch (unit) {
      case UNIT_F16:   // float16, or fp8 / 8-bit integers held exactly
        BBT_GEN(UNIT_F16, T_F16, false, false);
        BBT_GEN(UNIT_F16, DT_DBL, false, false);
        BBT_GEN(UNIT_F16, DT_INT, false, false);
        break;
      case UNIT_BF16:
        BBT_GEN(UNIT_BF16, T_BF16, false, false);
        break;
      case UNIT_S8:   // A is of D's type: uint8 on u8 operands, the rest s8
        if (a_code != W.d) break;
        if (a_code == T_U8)
          return launch_unit<UNIT_S8, DT_INT, true, true>(A, a_code, W, out,
                                                          M, N, K, sp, st);
        BBT_GEN(UNIT_S8, DT_INT, false, false);
        break;
      default: break;
    }
  } else {
    switch (unit) {
      case UNIT_F64:
        BBT_GEN(UNIT_F64, DT_DBL, false, false);
        break;
      case UNIT_FFMA:
        BBT_GEN(UNIT_FFMA, T_F32, false, false);
        BBT_GEN(UNIT_FFMA, DT_INT, false, false);
        break;
      default: break;
    }
  }
#undef BBT_GEN
  return (int)cudaErrorInvalidValue;
}

template <int DT>
int launch_decode(const Weight& W, void* out, int N, int K,
                  cudaStream_t st) {
  const long long total = (long long)N * K;
  const int blocks = (int)((total + 255) / 256 < 132 * 16 ? (total + 255) / 256
                                                          : 132 * 16);
  decode_kernel<DT><<<blocks, 256, 0, st>>>(W, out, N, K);
  return (int)cudaGetLastError();
}

}  // namespace dqg
}  // namespace bbt
