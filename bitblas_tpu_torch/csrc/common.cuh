// Small device helpers shared by the kernels of bitblas_tpu_torch:
// cp.async copies (16 and 4 bytes) with zero fill, the mma.sync m16n8k16
// f16 and bf16 products with float32 accumulation and the m16n8k32 int8
// product with int32 accumulation.
#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bbt {

// 16-byte global->shared copy; when `pred` is false nothing is read and
// the 16 shared bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

// 4-byte global->shared copy (a scale); zero-filled when `pred` is false.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const half* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_half2(half lo, half hi) {
  half2 h = __halves2half2(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_float2(float lo, float hi) {
  half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// a * b rounded to f16 on its own: the explicit rounding mode keeps the
// compiler from contracting it with a following add or subtract into one
// fma (q * s - z must round twice, as the plain version's f16 ops do).
__device__ __forceinline__ half2 hmul2_rn(half2 a, half2 b) {
  uint32_t r;
  asm("mul.rn.f16x2 %0, %1, %2;\n"
      : "=r"(r)
      : "r"(*reinterpret_cast<uint32_t*>(&a)),
        "r"(*reinterpret_cast<uint32_t*>(&b)));
  return *reinterpret_cast<half2*>(&r);
}
__device__ __forceinline__ half hmul_rn(half a, half b) {
  unsigned short r;
  asm("mul.rn.f16 %0, %1, %2;\n"
      : "=h"(r)
      : "h"(__half_as_ushort(a)), "h"(__half_as_ushort(b)));
  return __ushort_as_half(r);
}

// D = A (16x16, row) * B (16x8, col) + D, f16 operands, f32 accumulators.
// Fragment ownership (g = lane / 4, t = lane % 4):
//   a[0]: (row g, k 2t..2t+1)  a[1]: (row g+8, k 2t..)  a[2]: (row g, k 2t+8..)
//   a[3]: (row g+8, k 2t+8..)  b[0]: (k 2t..2t+1, col g)  b[1]: (k 2t+8.., col g)
//   d[0..1]: (row g, col 2t..2t+1)  d[2..3]: (row g+8, col 2t..2t+1)
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The same product with bf16 operands (same fragment ownership).
__device__ __forceinline__ void mma_16816_bf16(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D = A (16x32, row) * B (32x8, col) + D, s8 operands, s32 accumulators.
// Fragment ownership (g = lane / 4, t = lane % 4), four int8 a register:
//   a[0]: (row g, k 4t..4t+3)     a[1]: (row g+8, k 4t..4t+3)
//   a[2]: (row g, k 16+4t..)      a[3]: (row g+8, k 16+4t..)
//   b[0]: (k 4t..4t+3, col g)     b[1]: (k 16+4t..16+4t+3, col g)
//   d[0..1]: (row g, col 2t..2t+1)  d[2..3]: (row g+8, col 2t..2t+1)
__device__ __forceinline__ void mma_16832_s8(int* d, const uint32_t* a,
                                             const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 tiles of 16-bit elements (or 8 x 16 bytes) from shared
// memory: lane l gives the address of a row of tile l / 8; register i of
// every lane holds (row lane / 4, elements 2 (lane % 4) ..) of tile i, the
// layout of mma.sync's A and B fragments.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Four biased int2 fields (the low byte of x, LSB first) -> four int8
// values field - 2, one per byte. Each byte of f | 0x80 is >= 0x80, so
// subtracting 2 from every byte borrows nothing, and XOR 0x80 takes the
// 0x80 back off: (0x80 + f - 2) ^ 0x80 = f - 2 (mod 256).
__device__ __forceinline__ uint32_t decode_i2x4(uint32_t x) {
  const uint32_t f = (x & 0x3u) | ((x & 0xCu) << 6) | ((x & 0x30u) << 12) |
                     ((x & 0xC0u) << 18);
  return ((f | 0x80808080u) - 0x02020202u) ^ 0x80808080u;
}

// Raises a kernel's dynamic shared memory cap on the current device, once:
// the attribute belongs to the function on each device, and setting it is
// a driver call that would otherwise run on every launch. `done` is the
// caller's static table for that one kernel.
constexpr int kMaxDevices = 64;

template <typename Kernel>
inline cudaError_t set_max_smem_once(Kernel kernel, int bytes,
                                     bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace bbt
