// The decode of every quantized weight format the port runs with float16
// or bfloat16 activations, shared by kernel 1's split-K decode instances
// and its wgmma + TMA tiled loop (dequant_formats.cuh, dequant_wgmma.cuh,
// and the uint4 x f16 kernel's magic in dequant_matmul.cu) and by kernel 2
// (dequant_formats.cuh fmt_weight_decode_kernel).
//
// Counterpart of bitblas_tpu/quantization/numerics.py (decode_field and its
// bf16 decoders) and of the per-family decode of
// bitblas_tpu/kernels/dequant_matmul.py (_decode_field, _decode_byte). A
// decoded value is the value numerics.decode_field gives in A's type, bit
// for bit (all of them are exact in f16 and bf16; NaN payloads aside), so
// a kernel's decoded weight equals the plain version's.
//
// A functor turns a "raw pair" -- two codes of one weight row, consecutive
// in K, in the low bits of the two 16-bit halves of a register -- into an
// f16x2 or bf16x2 register (the code of the low half in the low half):
//   uint b <= 4   f16: 0x6400 | q is 1024 + q, less 1024 (BitBLAS's LOP3
//                 magic); bf16: 0x4300 | q is 128 + q, less 128 (exact
//                 for q <= 127).
//   int b <= 4    the same magic, less 1024 + 2^(b-1) (bf16: 128 +
//                 2^(b-1)): the field is stored biased by 2^(b-1).
//   int8          two's complement bytes. f16: q ^ 0x80 is the value +
//                 128 <= 255, 0x6400 | that less 1152. bf16 (8 significant
//                 bits only): the float32 magic 2^23 + (q ^ 0x80), less 2^23
//                 + 128, then one exact conversion.
//   nf4           a 16-entry table in shared memory, the values rounded to
//                 A's type (nf4_lut(dtype)).
//   fp4_e2m1      the reference's decode (numerics.decode_fp4_field), not
//                 OCP e2m1: payload e = q & 7 and sign q >> 3 give +-2^(e -
//                 7), and +0 for e = 0. f16: (e | 8) << 10 | s << 15; bf16:
//                 (e + 120) << 7 | s << 15; a half with e = 0 masked to 0.
//   e4m3          the reference's bit surgery (numerics.decode_f8e4m3_byte):
//                 exponent e4 + 8 (f16) or e4 + 120 (bf16), no subnormals
//                 and no NaN: not Hopper's cvt (e4m3fn), which differs on
//                 exponent-0 codes and on 0x7F / 0xFF.
//   e5m2          f16's top byte: raw << 8. bf16: that f16 pair through
//                 float32 (exact for every code; f16 subnormals, +-inf and
//                 NaN included, NaN payloads aside).
// Scale and zero, when the configuration has them, apply in A's type with
// the plain version's roundings: (w - z) * s (zeros mode original and
// quantized, and scale-only with z = 0: w - 0 is w exactly), or w * s - z
// (rescale, the product rounded on its own).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "common.cuh"

namespace bbt {
namespace fmt {

// -- activation types ----------------------------------------------------------

__device__ __forceinline__ uint32_t as_u32(half2 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

struct F16 {
  using T = half;
  static constexpr bool kBf16 = false;
  static constexpr uint32_t kMagic = 0x64006400u;   // 1024 in each half
  static constexpr float kMagicF = 1024.f;
  __device__ __forceinline__ static uint32_t sub(uint32_t a, uint32_t b) {
    return as_u32(__hsub2(*reinterpret_cast<half2*>(&a),
                          *reinterpret_cast<half2*>(&b)));
  }
  // a * b rounded on its own (never contracted into an fma)
  __device__ __forceinline__ static uint32_t mul_rn(uint32_t a, uint32_t b) {
    uint32_t r;
    asm("mul.rn.f16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ __forceinline__ static uint32_t splat(float x) {
    return as_u32(__float2half2_rn(x));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    return as_u32(__floats2half2_rn(lo, hi));
  }
  __device__ __forceinline__ static T cvt(float x) {
    return __float2half_rn(x);
  }
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             const uint32_t* b) {
    mma_16816(d, a, b);
  }
};

struct BF16 {
  using T = __nv_bfloat16;
  static constexpr bool kBf16 = true;
  static constexpr uint32_t kMagic = 0x43004300u;   // 128 in each half
  static constexpr float kMagicF = 128.f;
  __device__ __forceinline__ static uint32_t sub(uint32_t a, uint32_t b) {
    uint32_t r;
    asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ __forceinline__ static uint32_t mul_rn(uint32_t a, uint32_t b) {
    uint32_t r;
    asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
    return r;
  }
  __device__ __forceinline__ static uint32_t splat(float x) {
    return as_u32(__float2bfloat162_rn(x));
  }
  __device__ __forceinline__ static uint32_t pack(float lo, float hi) {
    return as_u32(__floats2bfloat162_rn(lo, hi));
  }
  __device__ __forceinline__ static T cvt(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ __forceinline__ static void mma(float* d, const uint32_t* a,
                                             const uint32_t* b) {
    mma_16816_bf16(d, a, b);
  }
};

// -- raw pairs -----------------------------------------------------------------

// Codes i and i + 1 of a row whose codes of B bits are packed LSB first in
// words w[] (code i at bit B i): code i in the low half, i + 1 in the high.
// `i` is a compile-time constant wherever the loops unroll.
template <int B>
__device__ __forceinline__ uint32_t raw_pair(const uint32_t* w, int i) {
  constexpr uint32_t M = (1u << B) - 1u;
  const int pos = i * B;
  const uint32_t x = w[pos / 32] >> (pos % 32);
  if constexpr (B == 8)
    return (x & 0xFFu) | ((x << 8) & 0xFF0000u);
  else
    return (x & M) | ((x << (16 - B)) & (M << 16));
}

// -- the families --------------------------------------------------------------

// NF4's table (bitblas_tpu/quantization/formats.py NF4_TABLE) rounded to
// f16 and to bf16: the bits of nf4_lut(float16) and nf4_lut(bfloat16).
__device__ __constant__ const uint16_t kNf4F16[16] = {
    0xbc00, 0xb992, 0xb833, 0xb652, 0xb48d, 0xb1ea, 0xadd4, 0x0000,
    0x2d18, 0x3126, 0x33e0, 0x3568, 0x370d, 0x3880, 0x39c9, 0x3c00};
__device__ __constant__ const uint16_t kNf4Bf16[16] = {
    0xbf80, 0xbf32, 0xbf06, 0xbeca, 0xbe92, 0xbe3d, 0xbdba, 0x0000,
    0x3da3, 0x3e25, 0x3e7c, 0x3ead, 0x3ee2, 0x3f10, 0x3f39, 0x3f80};

// Each family: kBits; kLut (the kernel keeps NF4's table in shared memory
// and passes it to convert); convert(raw, lut) -> the x2 bits in A's type.
template <int B>
struct UInt {
  static constexpr int kBits = B;
  static constexpr bool kLut = false;
  template <class AT>
  __device__ __forceinline__ static uint32_t convert(uint32_t raw,
                                                     const uint16_t*) {
    return AT::sub(raw | AT::kMagic, AT::kMagic);   // exact
  }
};

template <int B>
struct Int {
  static constexpr int kBits = B;
  static constexpr bool kLut = false;
  template <class AT>
  __device__ __forceinline__ static uint32_t convert(uint32_t raw,
                                                     const uint16_t*) {
    if constexpr (B == 8) {
      const uint32_t u = raw ^ 0x00800080u;   // value + 128 in each half
      if constexpr (AT::kBf16) {
        const float lo = __uint_as_float(0x4B000000u | (u & 0xFFFFu)) -
                         8388736.f;            // 2^23 + 128
        const float hi = __uint_as_float(0x4B000000u | (u >> 16)) -
                         8388736.f;
        return AT::pack(lo, hi);               // exact: |value| <= 128
      } else {
        return AT::sub(u | AT::kMagic, AT::splat(1152.f));
      }
    } else {
      return AT::sub(raw | AT::kMagic,
                     AT::splat(AT::kMagicF + float(1 << (B - 1))));
    }
  }
};

struct Nf4 {
  static constexpr int kBits = 4;
  static constexpr bool kLut = true;
  template <class AT>
  __device__ __forceinline__ static uint32_t convert(uint32_t raw,
                                                     const uint16_t* lut) {
    return (uint32_t)lut[raw & 0xFu] | ((uint32_t)lut[raw >> 16] << 16);
  }
};

struct Fp4 {
  static constexpr int kBits = 4;
  static constexpr bool kLut = false;
  template <class AT>
  __device__ __forceinline__ static uint32_t convert(uint32_t raw,
                                                     const uint16_t*) {
    const uint32_t e = raw & 0x00070007u;
    const uint32_t s = (raw & 0x00080008u) << 12;
    const uint32_t x = AT::kBf16 ? (e << 7) | 0x3C003C00u | s
                                 : (e << 10) | 0x20002000u | s;
    return x & __vcmpne2(e, 0u);   // +0 where the payload is 0
  }
};

struct E4m3 {
  static constexpr int kBits = 8;
  static constexpr bool kLut = false;
  template <class AT>
  __device__ __forceinline__ static uint32_t convert(uint32_t raw,
                                                     const uint16_t*) {
    const uint32_t em = raw & 0x007F007Fu, s = (raw & 0x00800080u) << 8;
    // no carry leaves a half: the exponent is at most 23 (f16), 135 (bf16)
    return AT::kBf16 ? ((em << 4) + 0x3C003C00u) | s
                     : ((em << 7) + 0x20002000u) | s;
  }
};

struct E5m2 {
  static constexpr int kBits = 8;
  static constexpr bool kLut = false;
  template <class AT>
  __device__ __forceinline__ static uint32_t convert(uint32_t raw,
                                                     const uint16_t*) {
    const uint32_t h = raw << 8;
    if constexpr (AT::kBf16) {
      const float2 f = __half22float2(*reinterpret_cast<const half2*>(&h));
      return AT::pack(f.x, f.y);   // exact
    } else {
      return h;
    }
  }
};

// -- scale and zero ------------------------------------------------------------

// How a configuration applies its scale and zero: none (the decoded value
// as it is), (w - z) * s (original, quantized, and scale-only with z = 0),
// or w * s - z (rescale).
enum Mode { kNone = 0, kOrig = 1, kRescale = 2 };

template <class AT, int MODE>
__device__ __forceinline__ uint32_t scale2(uint32_t w, uint32_t s,
                                           uint32_t z) {
  if constexpr (MODE == kOrig) return AT::mul_rn(AT::sub(w, z), s);
  if constexpr (MODE == kRescale) return AT::sub(AT::mul_rn(w, s), z);
  return w;
}

// The 16-bit pattern of a half / bf16 in both halves of a register.
__device__ __forceinline__ uint32_t splat16(uint16_t v) {
  return (uint32_t)v | ((uint32_t)v << 16);
}

}  // namespace fmt
}  // namespace bbt
